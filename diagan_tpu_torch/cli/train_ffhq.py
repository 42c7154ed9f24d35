"""StyleGAN2 FFHQ phase-1 training (ADA, R1, path regularisation, logit
recording for the LDR scores).

    python -m diagan_tpu_torch.cli.train_ffhq -d ffhq -r ./dataset/ffhq \\
        --size 256 --batch 16 --iter 200000 --augment --exp_name p1

The argparse surface of stylegan2/train_ffhq.py, plus --device (default
cuda; no card and no --device cpu raises). --root holds ffhq_{size}.npy (or
an LMDB or image directory where lmdb / Pillow are installed; cli.prepare_data
writes the npy); without any, a procedural stand-in dataset is used.

The JAX trainer's own flags: --bf16 (G's synthesis and D's backbone in
bfloat16; parameters, the mapping and D's head fp32), --remat (recompute
each StyledConv / ToRGB and each D block in the backward), --stream_data
(keep the dataset on the host and stream real batches through the native
gather; automatic above 6 GiB). --no_fuse and --max_chunk are accepted and
change nothing: the port runs one step at a time. --data_parallel trains
over every rank of the process group, one process per card:

    torchrun --standalone --nproc_per_node=N -m diagan_tpu_torch.cli.train_ffhq \
        --data_parallel -d ffhq -r ./dataset/ffhq --size 256 --batch 16 ...

(without torchrun, a world of one in process); --batch is per rank, as the
reference's per GPU, and --no_fuse with it raises, as in the JAX trainer.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from diagan_tpu_torch.cli.common import data_parallel_from_args
from diagan_tpu_torch.data.ffhq import load_ffhq
from diagan_tpu_torch.device import pin_fp32_precision, resolve_device
from diagan_tpu_torch.models.stylegan2 import StyleGAN2Discriminator, StyleGAN2Generator
from diagan_tpu_torch.train.stylegan2_trainer import StyleGAN2Trainer


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
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute for G's synthesis and D's backbone")
    parser.add_argument("--stream_data", action="store_true",
                        help="stream real batches from the host (automatic above 6 GiB)")
    parser.add_argument("--remat", action="store_true",
                        help="recompute each G layer and D block in the backward")
    parser.add_argument("--no_fuse", action="store_true",
                        help="the JAX trainer's unfused dispatch; changes nothing in the port, "
                             "which runs one step at a time")
    parser.add_argument("--max_chunk", default=None, type=int,
                        help="the JAX trainer's steps per dispatch; changes nothing in the port")
    parser.add_argument("--data_parallel", action="store_true",
                        help="train over every rank of the process group (torchrun), or a "
                             "world of one in process; --batch is per rank")
    parser.add_argument("--save_every", type=int, default=5000)
    parser.add_argument("--auto_resume", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    return parser


def make_trainer(args, sample_weights=None, drs=False, r1=None):
    """Build the trainer from parsed flags, and resume from --ckpt or, with
    --auto_resume, the latest checkpoint. Returns (trainer, start_step)."""
    device = resolve_device(args.device)
    dp, device = data_parallel_from_args(args, device)
    torch.manual_seed(args.seed)
    np.random.seed(args.seed)
    output_dir = Path(args.work_dir) / args.exp_name
    images = load_ffhq(args.root, size=args.size)

    nets = dict(size=args.size, channel_multiplier=args.channel_multiplier,
                dtype=torch.bfloat16 if args.bf16 else torch.float32, remat=args.remat,
                device=device)

    def disc():
        return StyleGAN2Discriminator(**nets)

    gen = StyleGAN2Generator(**nets)
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
        stream_data=True if args.stream_data else None,
        fuse_steps=not args.no_fuse,
        max_chunk=args.max_chunk,
        device=device,
        data_parallel=dp,
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
    pin_fp32_precision()
    args = build_parser().parse_args(argv)
    trainer, start = make_trainer(args)
    return trainer.train(start_step=start)


if __name__ == "__main__":
    main()
