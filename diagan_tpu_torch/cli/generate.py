"""Sample image grids from a StyleGAN2 checkpoint with truncation.

    python -m diagan_tpu_torch.cli.generate --size 256 --sample 16 --pics 2 \\
        --truncation 0.7 --ckpt ckpt.pt --out_dir sample

The argparse surface of stylegan2/generate.py, plus --device (default cuda;
no card and no --device cpu raises). --ckpt is the port's own checkpoint
(eval.evaluate.save_stylegan2_ckpt); samples come from g_ema, with the
mean latent for truncation estimated from --truncation_mean draws.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from diagan_tpu_torch.device import pin_fp32_precision, resolve_device
from diagan_tpu_torch.eval.evaluate import read_stylegan2_ckpt
from diagan_tpu_torch.models.stylegan2 import StyleGAN2Generator
from diagan_tpu_torch.train.logger import save_image_grid


@torch.no_grad()
def main(argv=None):
    """Write --pics grids of --sample images; returns the images as one
    (pics * sample, size, size, 3) float array in [-1, 1]."""
    pin_fp32_precision()
    parser = argparse.ArgumentParser()
    parser.add_argument("--size", type=int, default=1024)
    parser.add_argument("--sample", type=int, default=1)
    parser.add_argument("--pics", type=int, default=20)
    parser.add_argument("--truncation", type=float, default=1.0)
    parser.add_argument("--truncation_mean", type=int, default=4096)
    parser.add_argument("--ckpt", type=str, default="stylegan2-ffhq-config-f.pt")
    parser.add_argument("--channel_multiplier", type=int, default=2)
    parser.add_argument("--out_dir", type=str, default="sample")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    gen = StyleGAN2Generator(size=args.size, channel_multiplier=args.channel_multiplier,
                             dtype=dtype, device=device)
    read_stylegan2_ckpt(args.ckpt, gen)
    gen.eval()

    g = torch.Generator(device).manual_seed(args.seed)
    w_mean = None
    if args.truncation < 1:
        w_mean = gen.mean_latent(args.truncation_mean, generator=g)

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out = []
    for i in range(args.pics):
        z = torch.randn((args.sample, gen.style_dim), generator=g, device=device)
        imgs = gen.sample([z], None, args.truncation, w_mean, generator=g).cpu().numpy()
        save_image_grid(imgs, out_dir / f"{i:06d}.png", nrow=int(np.sqrt(args.sample)))
        out.append(imgs)
    print(f"wrote {args.pics} grids to {out_dir}")
    return np.concatenate(out)


if __name__ == "__main__":
    main()
