"""Model factory: dataset name -> (G, D[, D_drs]) modules and optimizer specs
(counterpart of diagan_tpu/models/registry.py).

  cifar10 -> {sngan, ssgan, infomax_gan}-32, celeba -> the 64 px ones (nz
    128), Adam(2e-4, (0.0, 0.9));
  color_mnist / mnist_fmnist -> the MNIST DCGAN (nc 3 / 1, nz 100, 32 px,
    num_pack and use_sn passed through), Adam(1e-4, (0.5, 0.9)), model
    "dcgan" whatever `model` says;
  25gaussian -> the toy MLPs (nz 2, points of 2, use_sn passed through),
    Adam(1e-4, (0.5, 0.999)), model "toy";
  ffhq -> StyleGAN2 at `size` (default 256; channel_multiplier 2, style_dim
    512, n_mlp 8), Adam(2e-4, (0.0, 0.9)), model "stylegan" whatever `model`
    says, but for model "stylegan3": a StyleGAN3-T G (models/stylegan3.py,
    z_dim 512) with StyleGAN2's D and twin D, both at `size`.

With drs=True a third discriminator (netD_drs) is built, which always
trains with the ns loss whatever --loss_type says (reference
predefined_models.py:180). GOLD and top-k are switches on the bundle that the
trainer reads. The modules are built on `device`, from torch's global
generator (seed it first: utils.set_seed). bf16=True builds the cifar10,
celeba, color_mnist and mnist_fmnist models with the bf16 compute dtype
(models/layers.py), as the JAX package does; the toy ignores it, as there.

The ffhq bundle serves evaluation (eval.evaluate, the eval CLIs); StyleGAN2
trains through cli/train_ffhq.py; StyleGAN3-T only samples (no trainer).
Not in the port yet, and raising: bf16 for StyleGAN3.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn as nn

from diagan_tpu_torch.device import resolve_device
from diagan_tpu_torch.models import infomax, mnist_dcgan, sngan, ssgan, stylegan2, stylegan3, toy


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


_GEN_32 = {
    "sngan": sngan.SNGANGenerator32,
    "ssgan": ssgan.SSGANGenerator32,
    "infomax_gan": infomax.InfoMaxGANGenerator32,
}
_DISC_32 = {
    "sngan": sngan.SNGANDiscriminator32,
    "ssgan": ssgan.SSGANDiscriminator32,
    "infomax_gan": infomax.InfoMaxGANDiscriminator32,
}
_GEN_64 = {
    "sngan": sngan.SNGANGenerator64,
    "ssgan": ssgan.SSGANGenerator64,
    "infomax_gan": infomax.InfoMaxGANGenerator64,
}
_DISC_64 = {
    "sngan": sngan.SNGANDiscriminator64,
    "ssgan": ssgan.SSGANDiscriminator64,
    "infomax_gan": infomax.InfoMaxGANDiscriminator64,
}
_STYLEGAN2_G = stylegan2.StyleGAN2Generator
_STYLEGAN2_D = stylegan2.StyleGAN2Discriminator
_STYLEGAN3_G = stylegan3.StyleGAN3Generator


def get_gan_model(dataset_name, model="sngan", loss_type="hinge", gold=False, drs=False,
                  topk=False, num_pack=1, device="cuda", **kwargs) -> GANBundle:
    device = resolve_device(device)
    dtype = torch.bfloat16 if kwargs.get("bf16") else torch.float32
    if dataset_name in ("cifar10", "celeba"):
        gens, discs = (_GEN_32, _DISC_32) if dataset_name == "cifar10" else (_GEN_64, _DISC_64)
        size, nz, nc = (32 if dataset_name == "cifar10" else 64), 128, 3
        make_gen = functools.partial(gens[model], dtype=dtype)
        make_disc = functools.partial(discs[model], dtype=dtype)
        opt = OptSpec(2e-4, (0.0, 0.9))
    elif dataset_name in ("color_mnist", "mnist_fmnist"):
        nc, nz, size, model = (3 if dataset_name == "color_mnist" else 1), 100, 32, "dcgan"
        make_gen = functools.partial(mnist_dcgan.MNISTDCGANGenerator, nz=nz, nc=nc, dtype=dtype)
        make_disc = functools.partial(mnist_dcgan.MNISTDCGANDiscriminator, nc=nc,
                                      num_pack=num_pack, use_sn=kwargs.get("use_sn", False),
                                      dtype=dtype)
        opt = OptSpec(1e-4, (0.5, 0.9))
    elif dataset_name == "25gaussian":
        nz, size, nc, model = 2, 0, 2, "toy"
        make_gen = toy.ToyGenerator
        make_disc = functools.partial(toy.ToyDiscriminator, use_sn=kwargs.get("use_sn", False))
        opt = OptSpec(1e-4, (0.5, 0.999))
    elif dataset_name == "ffhq":  # bf16: the synthesis and D's backbone (models/stylegan2.py)
        size, nz, nc = kwargs.get("size", 256), 512, 3
        if model == "stylegan3":
            if dtype != torch.float32:
                raise ValueError("StyleGAN3 runs in float32 only")
            make_gen = functools.partial(_STYLEGAN3_G, img_resolution=size)
        else:
            model = "stylegan"
            make_gen = functools.partial(_STYLEGAN2_G, size=size, dtype=dtype)
        make_disc = functools.partial(_STYLEGAN2_D, size=size, dtype=dtype)
        opt = OptSpec(2e-4, (0.0, 0.9))
    else:
        raise ValueError(f"unknown dataset: {dataset_name}")
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
        nc=nc,
    )
