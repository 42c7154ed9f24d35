"""Shared plumbing of the SNGAN training CLIs (counterpart of
diagan_tpu/cli/common.py).

Flag names and defaults as the JAX package's scripts (the reference's
--gpu and --download_dataset are accepted and ignored), plus --device
(default cuda; without a card and without --device cpu the scripts raise).
--bf16, --simultaneous_g and --data_parallel do what the JAX package's do
(the scripts pass them on, each as its JAX counterpart does). With
--data_parallel, --batch_size is the global batch, split evenly over the
ranks: one process per card under torchrun, or in process a world of one
(parallel/dist.py).
"""
from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np


def add_common_train_flags(parser: argparse.ArgumentParser):
    parser.add_argument("--work_dir", default="./exp_results", type=str, help="output dir")
    parser.add_argument("--gpu", default="0", type=str,
                        help="accepted for reference CLI compat; unused")
    parser.add_argument("--batch_size", default=64, type=int)
    parser.add_argument("--seed", default=1, type=int)
    parser.add_argument("--simultaneous_g", action="store_true")
    # resume this experiment from its own newest checkpoints; phase-2
    # scripts fall back to the baseline phase-1 checkpoints on a fresh start
    parser.add_argument("--auto_resume", action="store_true")
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--data_parallel", action="store_true",
                        help="train over every rank of the process group (torchrun), or a "
                             "world of one in process; --batch_size is the global batch")
    parser.add_argument("--device", default="cuda", type=str)
    return parser


def data_parallel_from_args(args, device):
    """(parallel.DataParallel over the process group, this rank's device)
    when --data_parallel (the JAX package's mesh_from_args); (None, device)
    for a plain run."""
    if not getattr(args, "data_parallel", False):
        return None, device
    from diagan_tpu_torch.parallel import init_data_parallel

    dp = init_data_parallel(device)
    print(f"data-parallel: rank {dp.rank} of {dp.world} on {dp.device} ({dp.backend})")
    return dp, dp.device


def is_main(dp):
    """Whether this process writes the run's files: rank 0, or a plain run."""
    return dp is None or dp.is_main


def step_fusions_from_args(args):
    """LogTrainer's step_fusions from the flags: --simultaneous_g."""
    return {"simultaneous_g": getattr(args, "simultaneous_g", False)}


def load_phase1_scores(baseline_save_path, p1_step, resample_score, window=5000,
                       logit_name="netD_eval", normalize_logits=False):
    """logits pickle -> sample weights for phase 2 (reference
    train_mimicry_phase2.py:86-93; window=5000 for all datasets)."""
    from diagan_tpu_torch.score import calculate_scores, warn_if_degenerate_weights

    logit_path = Path(baseline_save_path) / f"logits_{logit_name}.pkl"
    print(f"Use logit from: {logit_path}")
    with open(logit_path, "rb") as f:
        logits = pickle.load(f)
    score_dict = calculate_scores(logits, start_epoch=p1_step - window, end_epoch=p1_step,
                                  normalize_logits=normalize_logits)
    w = np.asarray(score_dict[resample_score])
    print(f"sample_weights mean: {w.mean()}, var: {w.var()}, max: {w.max()}, min: {w.min()}")
    warn_if_degenerate_weights(w, resample_score)
    return w


def phase1_ckpt_paths(baseline_save_path, p1_step):
    base = Path(baseline_save_path)
    return (base / f"checkpoints/netG/netG_{p1_step}_steps.pth",
            base / f"checkpoints/netD/netD_{p1_step}_steps.pth")


def latest_ckpt_step(save_path):
    """Newest step with a netG checkpoint under save_path/checkpoints, or None."""
    d = Path(save_path) / "checkpoints" / "netG"
    steps = []
    if d.is_dir():
        for f in d.glob("netG_*_steps.pth"):
            try:
                steps.append(int(f.stem.split("_")[1]))
            except (IndexError, ValueError):
                continue
    return max(steps) if steps else None


def resolve_phase2_resume(args, save_path, netG_ckpt, netD_ckpt, netD_drs_ckpt=None):
    """--auto_resume for phase-2 scripts: if this experiment already has
    checkpoints, restore all nets from its newest step instead of the
    baseline phase-1 files; D_drs then comes from its own netD_drs file
    rather than the netD clone."""
    if not getattr(args, "auto_resume", False):
        return netG_ckpt, netD_ckpt, netD_drs_ckpt
    own = latest_ckpt_step(save_path)
    if own is None:
        return netG_ckpt, netD_ckpt, netD_drs_ckpt
    base = Path(save_path)
    g, d = phase1_ckpt_paths(base, own)
    drs = netD_drs_ckpt
    if netD_drs_ckpt is not None:
        own_drs = base / f"checkpoints/netD_drs/netD_drs_{own}_steps.pth"
        drs = own_drs if own_drs.is_file() else d
    print(f"auto-resumed from own checkpoints at step {own}")
    return g, d, drs
