"""Model factory: dataset name -> (G, D[, D_drs]) modules and optimizer specs
(counterpart of diagan_tpu/models/registry.py).

cifar10 -> SNGAN-32, celeba -> SNGAN-64, ffhq -> StyleGAN2 at `size` (default
256; channel_multiplier 2, style_dim 512, n_mlp 8), each with Adam(2e-4, betas
(0.0, 0.9)). With drs=True a third discriminator (netD_drs) is built, which always
trains with the ns loss whatever --loss_type says (reference
predefined_models.py:180). GOLD and top-k are switches on the bundle that the
trainer reads. The modules are built on `device`, from torch's global
generator (seed it first: utils.set_seed).

The ffhq bundle serves evaluation (eval.evaluate, the eval CLIs); StyleGAN2
trains through cli/train_ffhq.py. Not in the port yet, and raising: the ssgan
and infomax_gan models, bf16, and the MNIST and 25-Gaussians bundles.
"""
from __future__ import annotations

import dataclasses
import functools

import torch.nn as nn

from diagan_tpu_torch.device import resolve_device
from diagan_tpu_torch.models import sngan, stylegan2


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
_STYLEGAN2_G = stylegan2.StyleGAN2Generator
_STYLEGAN2_D = stylegan2.StyleGAN2Discriminator


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
        size, nz = (32 if dataset_name == "cifar10" else 64), 128
        make_gen, make_disc = gens[model], discs[model]
    elif dataset_name == "ffhq":
        size, nz, model = kwargs.get("size", 256), 512, "stylegan"
        make_gen = functools.partial(_STYLEGAN2_G, size=size)
        make_disc = functools.partial(_STYLEGAN2_D, size=size)
    elif dataset_name in ("color_mnist", "mnist_fmnist", "25gaussian"):
        raise _not_ported(f"the {dataset_name} bundle")
    else:
        raise ValueError(f"unknown dataset: {dataset_name}")
    opt = OptSpec(2e-4, (0.0, 0.9))
    return GANBundle(
        gen=make_gen(device=device),
        disc=make_disc(device=device),
        disc_drs=make_disc(device=device) if drs else None,
        opt_g=opt,
        opt_d=opt,
        opt_d_drs=opt if drs else None,
        nz=nz,
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
