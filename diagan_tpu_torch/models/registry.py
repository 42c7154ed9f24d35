"""Model factory: dataset name -> (G, D[, D_drs]) modules and optimizer specs
(counterpart of diagan_tpu/models/registry.py).

cifar10 -> SNGAN-32, celeba -> SNGAN-64, each with Adam(2e-4, betas (0.0,
0.9)). With drs=True a third discriminator (netD_drs) is built, which always
trains with the ns loss whatever --loss_type says (reference
predefined_models.py:180). GOLD and top-k are switches on the bundle that the
trainer reads. The modules are built on `device`, from torch's global
generator (seed it first: utils.set_seed).

Not in the port yet, and raising: the ssgan and infomax_gan models, bf16,
and the MNIST, 25-Gaussians and FFHQ bundles (StyleGAN2 trains through
cli/train_ffhq.py).
"""
from __future__ import annotations

import dataclasses

import torch.nn as nn

from diagan_tpu_torch.device import resolve_device
from diagan_tpu_torch.models import sngan


@dataclasses.dataclass
class OptSpec:
    lr: float
    betas: tuple


@dataclasses.dataclass
class GANBundle:
    gen: nn.Module
    disc: nn.Module
    disc_drs: nn.Module | None
    opt_g: OptSpec
    opt_d: OptSpec
    opt_d_drs: OptSpec | None
    nz: int
    loss_type: str
    drs_loss_type: str
    gold: bool
    topk: bool
    model: str
    dataset: str
    image_size: int
    nc: int


_GEN_32 = {"sngan": sngan.SNGANGenerator32}
_DISC_32 = {"sngan": sngan.SNGANDiscriminator32}
_GEN_64 = {"sngan": sngan.SNGANGenerator64}
_DISC_64 = {"sngan": sngan.SNGANDiscriminator64}


def _not_ported(what):
    return NotImplementedError(f"{what}: not in the port yet (see ROADMAP.md, Queue A)")


def get_gan_model(dataset_name, model="sngan", loss_type="hinge", gold=False, drs=False,
                  topk=False, num_pack=1, device="cuda", **kwargs) -> GANBundle:
    device = resolve_device(device)
    if kwargs.get("bf16"):
        raise _not_ported("bf16")
    if dataset_name in ("cifar10", "celeba"):
        if model not in _GEN_32:
            raise _not_ported(f"model {model!r}")
        gens, discs = (_GEN_32, _DISC_32) if dataset_name == "cifar10" else (_GEN_64, _DISC_64)
        size = 32 if dataset_name == "cifar10" else 64
    elif dataset_name in ("color_mnist", "mnist_fmnist", "25gaussian", "ffhq"):
        raise _not_ported(f"the {dataset_name} bundle")
    else:
        raise ValueError(f"unknown dataset: {dataset_name}")
    opt = OptSpec(2e-4, (0.0, 0.9))
    return GANBundle(
        gen=gens[model](device=device),
        disc=discs[model](device=device),
        disc_drs=discs[model](device=device) if drs else None,
        opt_g=opt,
        opt_d=opt,
        opt_d_drs=opt if drs else None,
        nz=128,
        loss_type=loss_type,
        # netD_drs always trains with ns loss (predefined_models.py:180)
        drs_loss_type="ns",
        gold=gold,
        topk=topk,
        model=model,
        dataset=dataset_name,
        image_size=size,
        nc=3,
    )
