"""Checkpoint IO in the reference's on-disk layout (counterpart of
diagan_tpu/train/checkpoint.py).

One file per net and step, `{ckpt_dir}/{name}/{name}_{step}_steps.pth`, as
a torch payload in torch-mimicry's wrapper {"model_state_dict",
"optimizer_state_dict", "global_step"} (what the JAX package's
utils/torch_import.py reads, so its load_eval_models restores a port-trained
run), plus "update_count": the net's Adam update count, which the lr
schedule reads (train/state.py). The optimizer state carries Adam's moments,
so a resumed run continues the uninterrupted one. Writes are atomic (tmp +
rename).
"""
from __future__ import annotations

import os
from pathlib import Path

import torch

from diagan_tpu_torch.train.state import load_moments


def ckpt_path(ckpt_dir, name, step) -> Path:
    return Path(ckpt_dir) / name / f"{name}_{step}_steps.pth"


def save_net(net, ckpt_dir, name, step) -> Path:
    """Write a train.state.NetState at global step `step`."""
    path = ckpt_path(ckpt_dir, name, step)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    torch.save({"model_state_dict": net.module.state_dict(),
                "optimizer_state_dict": net.optim.state_dict(),
                "global_step": int(step), "update_count": net.count}, tmp)
    os.replace(tmp, path)
    return path


def load_weights(module, path):
    """Load a net file's weights and buffers into `module`, on its device.
    Returns the whole payload."""
    raw = torch.load(path, map_location=next(module.parameters()).device, weights_only=True)
    module.load_state_dict(raw["model_state_dict"])
    return raw


def restore_net(net, path):
    """Restore a NetState from `path` in place: the module's weights and
    buffers, the Adam moments (keeping this run's lr and betas) and the
    update count. Returns the file's global step."""
    raw = load_weights(net.module, path)
    load_moments(net.optim, raw["optimizer_state_dict"])
    net.count = int(raw["update_count"])
    return int(raw["global_step"])
