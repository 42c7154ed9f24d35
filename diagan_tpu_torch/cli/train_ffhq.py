"""StyleGAN2 FFHQ phase-1 training (ADA, R1, path regularisation, logit
recording for the LDR scores).

    python -m diagan_tpu_torch.cli.train_ffhq -d ffhq -r ./dataset/ffhq \\
        --size 256 --batch 16 --iter 200000 --augment --exp_name p1

The argparse surface of stylegan2/train_ffhq.py, plus --device (default
cuda; no card and no --device cpu raises). --root holds ffhq_{size}.npy (or
an LMDB or image directory where lmdb / Pillow are installed); without any,
a procedural stand-in dataset is used. Flags of the JAX trainer that the
port does not have yet (--bf16, --remat, --stream_data, --no_fuse,
--max_chunk, --data_parallel) are accepted and raise when set.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from diagan_tpu_torch.data.ffhq import load_ffhq
from diagan_tpu_torch.device import resolve_device
from diagan_tpu_torch.models.stylegan2 import StyleGAN2Discriminator, StyleGAN2Generator
from diagan_tpu_torch.train.stylegan2_trainer import StyleGAN2Trainer

NOT_PORTED = ("bf16", "remat", "stream_data", "no_fuse", "max_chunk", "data_parallel")


def build_parser():
    parser = argparse.ArgumentParser()
    # the reference's defaults really are cifar10 even in the FFHQ scripts
    parser.add_argument("--dataset", "-d", default="cifar10", type=str)
    parser.add_argument("--root", "-r", default="./dataset/cifar10", type=str)
    parser.add_argument("--iter", type=int, default=800000)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--n_sample", type=int, default=64)
    parser.add_argument("--size", type=int, default=32)
    parser.add_argument("--r1", type=float, default=0.1)
    parser.add_argument("--path_regularize", type=float, default=2)
    parser.add_argument("--path_batch_shrink", type=int, default=2)
    parser.add_argument("--d_reg_every", type=int, default=16)
    parser.add_argument("--g_reg_every", type=int, default=4)
    parser.add_argument("--mixing", type=float, default=0.9)
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--lr", type=float, default=0.002)
    parser.add_argument("--channel_multiplier", type=int, default=2)
    parser.add_argument("--wandb", action="store_true")
    parser.add_argument("--local_rank", type=int, default=0)
    parser.add_argument("--augment", action="store_true")
    parser.add_argument("--augment_p", type=float, default=0)
    parser.add_argument("--ada_target", type=float, default=0.6)
    parser.add_argument("--ada_pad_frac", type=float, default=0.75)
    parser.add_argument("--ada_length", type=int, default=500 * 1000)
    parser.add_argument("--ada_every", type=int, default=256)
    parser.add_argument("--work_dir", default="./exp_results", type=str)
    parser.add_argument("--exp_name", default="test", type=str)
    parser.add_argument("--seed", default=1, type=int)
    parser.add_argument("--gpu", type=str)
    parser.add_argument("--logit_save_steps", default=100, type=int)
    parser.add_argument("--save_logit_after", default=195000, type=int)
    parser.add_argument("--stop_save_logit_after", default=200000, type=int)
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--stream_data", action="store_true")
    parser.add_argument("--remat", action="store_true")
    parser.add_argument("--no_fuse", action="store_true")
    parser.add_argument("--max_chunk", default=None, type=int)
    parser.add_argument("--data_parallel", action="store_true")
    parser.add_argument("--save_every", type=int, default=5000)
    parser.add_argument("--auto_resume", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    return parser


def make_trainer(args, sample_weights=None, drs=False, r1=None):
    """Build the trainer from parsed flags, and resume from --ckpt or, with
    --auto_resume, the latest checkpoint. Returns (trainer, start_step)."""
    device = resolve_device(args.device)
    unported = [f"--{f}" for f in NOT_PORTED if getattr(args, f) not in (False, None)]
    if unported:
        raise NotImplementedError(f"{', '.join(unported)}: not in the port yet "
                                  "(see ROADMAP.md, Queue A item 4)")
    torch.manual_seed(args.seed)
    np.random.seed(args.seed)
    output_dir = Path(args.work_dir) / args.exp_name
    images = load_ffhq(args.root, size=args.size)

    def disc():
        return StyleGAN2Discriminator(size=args.size, channel_multiplier=args.channel_multiplier,
                                      device=device)

    gen = StyleGAN2Generator(size=args.size, channel_multiplier=args.channel_multiplier,
                             device=device)
    trainer = StyleGAN2Trainer(
        output_dir, gen, disc(), images,
        num_steps=args.iter,
        save_every=args.save_every,
        drs_disc=disc() if drs else None,
        sample_weights=sample_weights,
        batch_size=args.batch,
        lr=args.lr,
        r1_weight=r1 if r1 is not None else args.r1,
        path_regularize=args.path_regularize,
        d_reg_every=args.d_reg_every,
        g_reg_every=args.g_reg_every,
        path_batch_shrink=args.path_batch_shrink,
        mixing=args.mixing,
        # None: augmentation off (no --augment); 0: adaptive ADA; > 0: fixed p
        augment_p=args.augment_p if args.augment else None,
        ada_target=args.ada_target,
        ada_length=args.ada_length,
        ada_pad_frac=args.ada_pad_frac,
        logit_save_steps=args.logit_save_steps,
        save_logit_after=args.save_logit_after,
        stop_save_logit_after=args.stop_save_logit_after,
        seed=args.seed,
        device=device,
    )
    start = 0
    if args.ckpt:
        start = trainer.load_ckpt(args.ckpt)
        print(f"resumed from {args.ckpt} at step {start}")
    elif args.auto_resume:
        latest = trainer.find_latest_ckpt()
        if latest is not None:
            start = trainer.load_ckpt(latest)
            print(f"auto-resumed from {latest} at step {start}")
    return trainer, start


def main(argv=None):
    """Train phase 1; returns the trainer."""
    args = build_parser().parse_args(argv)
    trainer, start = make_trainer(args)
    return trainer.train(start_step=start)


if __name__ == "__main__":
    main()
