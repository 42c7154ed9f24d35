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

`read_stylegan2_file` reads a StyleGAN2 checkpoint in any of three formats,
told apart by its bytes and keys: the port's own torch payload, the
reference's (rosinality's) `{iter:06d}.pt`, and the JAX package's Flax
msgpack file (decoded by utils/flax_msgpack.py, without msgpack or flax).
"""
from __future__ import annotations

import os
from pathlib import Path

import torch

from diagan_tpu_torch.train.state import load_moments
from diagan_tpu_torch.utils import jax_params
from diagan_tpu_torch.utils.flax_msgpack import msgpack_restore

TORCH_ZIP_MAGIC = b"PK\x03\x04"
_G_KEYS, _D_KEYS = ("g", "g_ema"), ("d", "drs_d")


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


def read_stylegan2_file(path) -> dict:
    """A StyleGAN2 checkpoint as the port's payload: "format" ("port",
    "reference" or "jax"), the state_dicts of whichever of g, g_ema, d and
    drs_d it holds (port names, CPU tensors), and "ada_aug_p", "pl_mean" and
    "step" where it has them. Optimizer states: the port's own file keeps
    its torch state_dicts (g_optim, d_optim, drs_d_optim); a JAX file gives
    each as optax_adam_moments' {"count", "exp_avg", "exp_avg_sq"}; the
    reference's torch Adam states are not read (the JAX package keeps fresh
    moments there too), and its step comes from the file name.

    A torch zip whose g (or g_ema) has the port's keys is the port's file,
    one with the reference's keys (style.1.weight, convs.0...) is the
    reference's; anything else is read as the JAX package's msgpack."""
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(len(TORCH_ZIP_MAGIC))
    if head == TORCH_ZIP_MAGIC:
        raw = torch.load(path, map_location="cpu", weights_only=True)
        g = raw.get("g", raw.get("g_ema"))
        if g is None or "style.1.weight" not in g:
            return {"format": "port", **raw}
        out = {"format": "reference"}
        for key in _G_KEYS:
            if key in raw:
                out[key] = jax_params.reference_generator_state_dict(raw[key])
        for key in _D_KEYS:
            if key in raw:
                out[key] = jax_params.reference_discriminator_state_dict(raw[key])
        if "ada_aug_p" in raw:
            out["ada_aug_p"] = float(raw["ada_aug_p"])
        try:
            out["step"] = int(path.stem)
        except ValueError:
            pass
        return out
    raw = msgpack_restore(path.read_bytes())
    out = {"format": "jax"}
    bridges = {**dict.fromkeys(_G_KEYS, jax_params.generator_state_dict),
               **dict.fromkeys(_D_KEYS, jax_params.discriminator_state_dict)}
    for key, bridge in bridges.items():
        if key in raw:
            out[key] = bridge(raw[key])
    for key, bridge in (("g_optim", jax_params.generator_state_dict),
                        ("d_optim", jax_params.discriminator_state_dict),
                        ("drs_d_optim", jax_params.discriminator_state_dict)):
        if key in raw:
            out[key] = jax_params.optax_adam_moments(raw[key], bridge)
    for key, cast in (("ada_aug_p", float), ("pl_mean", float), ("step", int)):
        if key in raw:
            out[key] = cast(raw[key])
    return out
