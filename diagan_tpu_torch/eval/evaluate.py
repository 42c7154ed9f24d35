"""Sampling closures, the plain sampler, the SNGAN runs' eval loader and the
port's StyleGAN2 checkpoint.

Counterparts of make_gen_fn / make_disc_fn / Sampler / load_eval_models /
read_stylegan2_ckpt in diagan_tpu/eval/evaluate.py. The JAX make_gen_fn draws
the StyleGAN2 noise from one fixed key; here the noise comes from an
explicit torch.Generator on the generator's device. The SNGAN generator
draws no noise.

load_eval_models reads the mimicry layout a LogTrainer run writes
(checkpoints/{netG,netD,netD_drs}/{name}_{step}_steps.pth).

The port's checkpoint is one torch.save'd dict of state_dicts,
{"g_ema", "d", "drs_d"}; the trainer's checkpoints are a superset of it.
DRS reads drs_d and falls back to d, as the JAX reader does.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from diagan_tpu_torch.device import resolve_device
from diagan_tpu_torch.eval.drs import minmax_uint8 as _minmax_uint8
from diagan_tpu_torch.eval.drs import to_uint8
from diagan_tpu_torch.models.stylegan2 import StyleGAN2Generator
from diagan_tpu_torch.train.checkpoint import load_weights


def _module_device(module):
    return next(module.parameters()).device


def make_gen_fn(gen, generator=None):
    """Eval-mode z -> NHWC images closure over `gen`. For StyleGAN2,
    `generator` draws the per-layer noise (default: seed 0 on gen's device)."""
    gen.eval()
    noise = isinstance(gen, StyleGAN2Generator)
    if noise and generator is None:
        generator = torch.Generator(_module_device(gen)).manual_seed(0)

    @torch.no_grad()
    def gen_fn(z):
        return gen(z, generator=generator) if noise else gen(z)

    return gen_fn


def make_disc_fn(disc):
    """Eval-mode NHWC images -> (N,) logits closure over `disc`."""
    disc.eval()

    @torch.no_grad()
    def disc_fn(x):
        return disc(x)[0]

    return disc_fn


class Sampler:
    """Plain batched G sampler (the non-DRS path)."""

    def __init__(self, gen_fn, nz, generator=None, batch_size=256, device="cuda"):
        self.device = resolve_device(device)
        self.gen_fn = gen_fn
        self.nz = nz
        self.batch_size = batch_size
        self.generator = (generator if generator is not None
                          else torch.Generator(self.device).manual_seed(0))

    @torch.no_grad()
    def generate_images(self, num_images, return_uint8=False, minmax_uint8=False):
        out = []
        n = 0
        while n < num_images:
            z = torch.randn((self.batch_size, self.nz), generator=self.generator,
                            device=self.device)
            imgs = self.gen_fn(z)
            if minmax_uint8:
                imgs = _minmax_uint8(imgs)
            elif return_uint8:
                imgs = to_uint8(imgs)
            out.append(imgs.cpu().numpy())
            n += len(out[-1])
        return np.concatenate(out)[:num_images]


def load_eval_models(bundle, log_dir, evaluate_step, use_drs=False, use_original_netD=False):
    """Load G (and the DRS discriminator) of an SNGAN run at a step into the
    bundle's modules, in eval mode. Returns (gen, disc or None): with
    use_drs, netD_drs, or netD with use_original_netD (a phase-1 model's own
    D under DRS, reference eval_gan_drs.py:28)."""
    log_dir = Path(log_dir)
    g_path = log_dir / "checkpoints" / "netG" / f"netG_{evaluate_step}_steps.pth"
    if not g_path.is_file():
        raise FileNotFoundError(f"missing {g_path}")
    load_weights(bundle.gen, g_path)
    bundle.gen.eval()
    if not use_drs:
        return bundle.gen, None
    name = "netD" if use_original_netD else "netD_drs"
    d_path = log_dir / "checkpoints" / name / f"{name}_{evaluate_step}_steps.pth"
    if not d_path.is_file():
        raise FileNotFoundError(f"missing {d_path}")
    disc = bundle.disc_drs if bundle.disc_drs is not None else bundle.disc
    load_weights(disc, d_path)
    disc.eval()
    return bundle.gen, disc


def save_stylegan2_ckpt(path, g_ema, d=None, drs_d=None):
    """Write the port's monolithic checkpoint {"g_ema", "d", "drs_d"}."""
    mods = {"g_ema": g_ema, "d": d, "drs_d": drs_d}
    torch.save({k: m.state_dict() for k, m in mods.items() if m is not None}, path)
    return Path(path)


def read_stylegan2_ckpt(path, gen, disc=None, use_drs=False):
    """Load g_ema into `gen` and, with use_drs, drs_d (else d) into `disc`,
    in place, on the modules' devices. Returns (gen, disc)."""
    raw = torch.load(path, map_location=_module_device(gen), weights_only=True)
    gen.load_state_dict(raw["g_ema"])
    if use_drs:
        if disc is None:
            raise ValueError("use_drs needs the discriminator module")
        disc.load_state_dict(raw["drs_d"] if "drs_d" in raw else raw["d"])
    return gen, disc
