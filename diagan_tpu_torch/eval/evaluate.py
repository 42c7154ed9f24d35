"""Sampling closures, the plain sampler and the port's StyleGAN2 checkpoint.

Counterparts of make_gen_fn / make_disc_fn / Sampler / read_stylegan2_ckpt
in diagan_tpu/eval/evaluate.py. The JAX make_gen_fn draws the StyleGAN2
noise from one fixed key; here the noise comes from an explicit
torch.Generator on the generator's device.

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


def _module_device(module):
    return next(module.parameters()).device


def make_gen_fn(gen, generator=None):
    """Eval-mode z -> NHWC images closure over `gen`. `generator` draws the
    per-layer noise (default: seed 0 on gen's device)."""
    gen.eval()
    if generator is None:
        generator = torch.Generator(_module_device(gen)).manual_seed(0)

    @torch.no_grad()
    def gen_fn(z):
        return gen(z, generator=generator)

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
