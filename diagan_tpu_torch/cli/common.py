"""Shared plumbing of the SNGAN training CLIs (counterpart of
diagan_tpu/cli/common.py).

Flag names and defaults as the JAX package's scripts (the reference's
--gpu and --download_dataset are accepted and ignored), plus --device
(default cuda; without a card and without --device cpu the scripts raise).
The JAX package's --bf16, --data_parallel and --simultaneous_g are accepted
and raise when set: they are not in the port yet.
"""
from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np

NOT_PORTED = ("bf16", "data_parallel", "simultaneous_g")


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
    parser.add_argument("--data_parallel", action="store_true")
    parser.add_argument("--device", default="cuda", type=str)
    return parser


def check_ported(args):
    """Raise for the flags of the JAX package's scripts that the port does
    not have yet."""
    unported = [f"--{f}" for f in NOT_PORTED if getattr(args, f, False)]
    if unported:
        raise NotImplementedError(f"{', '.join(unported)}: not in the port yet "
                                  "(see ROADMAP.md, Queue A)")


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
