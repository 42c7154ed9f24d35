"""Prepare FFHQ images for training: an image directory -> one flat uint8
`ffhq_{size}.npy` per resolution (what data/ffhq.py:load_ffhq reads first).

    python -m diagan_tpu_torch.cli.prepare_data --path ./images --out ./dataset/ffhq \\
        --size 128,256,512,1024

The argparse surface of stylegan2/prepare_data.py. --n_worker and
--resample are accepted as the reference has them; the resize is Lanczos in
one process, as in the JAX package, so the files are byte for byte the
same. Needs Pillow.
"""
from __future__ import annotations

import argparse

from diagan_tpu_torch.data.ffhq import prepare_npy
from diagan_tpu_torch.device import pin_fp32_precision


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", type=str, help="output dataset root (dir for the .npy store)")
    parser.add_argument("--size", type=str, default="128,256,512,1024")
    parser.add_argument("--n_worker", type=int, default=8)
    parser.add_argument("--resample", type=str, default="lanczos")
    parser.add_argument("--path", type=str, help="path to the image dataset")
    return parser


def main(argv=None):
    """Write the npy store; returns {size: array}."""
    pin_fp32_precision()
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.path or not args.out:
        parser.error("--path and --out are required")
    sizes = tuple(int(s) for s in args.size.split(","))
    out = prepare_npy(args.path, args.out, sizes=sizes)
    print(f"wrote {[f'ffhq_{s}.npy' for s in sizes]} to {args.out}")
    return out


if __name__ == "__main__":
    main()
