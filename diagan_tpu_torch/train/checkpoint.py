"""Checkpoint IO in the reference's on-disk layout (counterpart of
diagan_tpu/train/checkpoint.py).

One file per net and step, `{ckpt_dir}/{name}/{name}_{step}_steps.pth`, as
a torch payload in torch-mimicry's wrapper {"model_state_dict",
"optimizer_state_dict", "global_step"} (what the JAX package's
utils/torch_import.py reads, so its load_eval_models restores a port-trained
run), plus "update_count": the net's Adam update count, which the lr
schedule reads (train/state.py), and "step": the net's step (the JAX
NetState's). The optimizer state carries Adam's moments, so a resumed run
continues the uninterrupted one. Writes are atomic (tmp + rename).

`load_weights` and `restore_net` also read the files the JAX package and the
reference write under the same names, told apart by their bytes and keys:
  - the JAX package's Flax msgpack NetState {params, state, opt_state,
    step} (diagan_tpu/train/checkpoint.py save_net; decoded by
    utils/flax_msgpack.py): params and state go through the
    utils/jax_params.py bridge of the module's class (`_MIMICRY_BRIDGES`),
    optax's mu / nu through the same bridge into torch Adam's moments; the
    update count is optax's schedule count (its Adam count under a constant
    lr), the step the file's `step`, as the JAX package's own restore;
  - the reference's torch-mimicry wrapper without "update_count", or a bare
    state_dict: the weights and buffers (stock spectral-norm names,
    weight_orig / weight_v, mapped to the port's weight / weight_u), and, as
    the JAX package's utils/torch_import.py import_torch_net, the step is the
    file's global_step (0 for a bare state_dict) while Adam starts fresh:
    moments 0, update count 0, so the lr schedule starts again from lr0.

`read_stylegan2_file` reads a StyleGAN2 checkpoint in any of three formats,
told apart by its bytes and keys: the port's own torch payload, the
reference's (rosinality's) `{iter:06d}.pt`, and the JAX package's Flax
msgpack file (decoded by utils/flax_msgpack.py, without msgpack or flax).
"""
from __future__ import annotations

import os
from pathlib import Path

import torch

from diagan_tpu_torch.models import infomax, mnist_dcgan, sngan, ssgan, toy
from diagan_tpu_torch.train.state import load_adam_moments, load_moments
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
                "global_step": int(step), "update_count": net.count, "step": net.step}, tmp)
    os.replace(tmp, path)
    return path


# a mimicry module's class -> the bridge of its JAX twin's variables (subclasses first)
_MIMICRY_BRIDGES = (
    ((ssgan.SSGANDiscriminator32, ssgan.SSGANDiscriminator64),
     jax_params.ssgan_discriminator_state_dict),
    ((infomax.InfoMaxGANDiscriminator32, infomax.InfoMaxGANDiscriminator64),
     jax_params.infomax_discriminator_state_dict),
    ((sngan.SNGANDiscriminator32, sngan.SNGANDiscriminator64),
     jax_params.sngan_discriminator_state_dict),
    ((sngan.SNGANGenerator32, sngan.SNGANGenerator64), jax_params.sngan_generator_state_dict),
    ((mnist_dcgan.MNISTDCGANGenerator,), jax_params.mnist_dcgan_generator_state_dict),
    ((mnist_dcgan.MNISTDCGANDiscriminator,), jax_params.mnist_dcgan_discriminator_state_dict),
    ((toy.ToyGenerator,), jax_params.toy_generator_state_dict),
    ((toy.ToyDiscriminator,), jax_params.toy_discriminator_state_dict),
)


def bridge_for(module, table=_MIMICRY_BRIDGES):
    """The utils/jax_params.py bridge for `module`'s class in `table`
    ((classes, bridge) pairs); raises on a class it does not know."""
    for classes, bridge in table:
        if isinstance(module, classes):
            return bridge
    raise ValueError(f"no JAX-package bridge for a {type(module).__name__}")


def is_torch_file(path) -> bool:
    """A torch zip (torch.save), else Flax msgpack bytes."""
    with open(path, "rb") as f:
        return f.read(len(TORCH_ZIP_MAGIC)) == TORCH_ZIP_MAGIC


def read_state_dict(path, bridge):
    """A file of one module's weights: a torch state_dict as it is, or the JAX
    package's Flax bytes of its variables mapped through `bridge` (CPU
    tensors either way)."""
    if is_torch_file(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    return bridge(msgpack_restore(Path(path).read_bytes()))


# the stock torch.nn.utils.spectral_norm names (and the short ones
# utils/torch_import.py accepts) -> the port's
_SN_NAMES = {"weight_orig": "weight", "weight_bar": "weight", "u": "weight_u"}


def reference_state_dict(sd, module):
    """A reference torch state_dict as `module`'s: spectral layers saved
    through torch.nn.utils.spectral_norm (weight_orig, weight_u, weight_v) take
    the port's names (weight, weight_u; v is dropped: every forward recomputes
    it from u, as the JAX import does), and each tensor the shape of the
    module's own (a (1, out) u becomes (out,))."""
    own = module.state_dict()
    out = {}
    for key, value in sd.items():
        stem, _, leaf = key.rpartition(".")
        if leaf in ("weight_v", "v") and f"{stem}.weight_u" in own:
            continue
        if leaf in _SN_NAMES and f"{stem}.{_SN_NAMES[leaf]}" in own:
            key = f"{stem}.{_SN_NAMES[leaf]}"
        target = own.get(key)
        out[key] = (value.reshape(target.shape)
                    if target is not None and value.numel() == target.numel() else value)
    return out


def read_net_file(path, module):
    """A mimicry net file as {"format": "port" | "reference" | "jax",
    "model_state_dict": `module`'s state_dict (CPU tensors), "global_step",
    "step", and per format "update_count" with "optimizer_state_dict" (the
    port's) or "moments" (the JAX package's: utils/jax_params.py
    optax_adam_moments' {"count", "schedule_count", "exp_avg",
    "exp_avg_sq"})}. See the module docstring for the three formats."""
    if is_torch_file(path):
        raw = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(raw, dict) and "update_count" in raw:
            return {"format": "port", **raw, "step": int(raw.get("step", raw["update_count"]))}
        step = 0
        if isinstance(raw, dict) and "model_state_dict" in raw:
            step = int(raw.get("global_step") or 0)
            raw = raw["model_state_dict"]
        return {"format": "reference", "model_state_dict": reference_state_dict(raw, module),
                "global_step": step, "step": step}
    raw = msgpack_restore(Path(path).read_bytes())
    bridge = bridge_for(module)
    step = int(raw.get("step", 0))
    out = {"format": "jax", "model_state_dict": bridge({"params": raw["params"],
                                                        **raw.get("state", {})}),
           "global_step": step, "step": step}
    if "opt_state" in raw:
        out["moments"] = jax_params.optax_adam_moments(
            raw["opt_state"], lambda tree: bridge({"params": tree}))
    return out


def load_weights(module, path):
    """Load a net file's weights and buffers into `module`, on its device:
    the port's file, the JAX package's msgpack NetState, the reference's
    torch-mimicry wrapper or a bare state_dict (read_net_file). Returns
    read_net_file's dict."""
    raw = read_net_file(path, module)
    module.load_state_dict(raw["model_state_dict"])
    return raw


def restore_net(net, path):
    """Restore a NetState from `path` in place: the module's weights and
    buffers, the Adam moments (keeping this run's lr and betas), the update
    count and the step; from a reference file Adam starts fresh (module
    docstring). Returns the file's global step."""
    raw = load_weights(net.module, path)
    net.optim.state.clear()
    if raw["format"] == "port":
        load_moments(net.optim, raw["optimizer_state_dict"])
        net.count = int(raw["update_count"])
    elif "moments" in raw:
        moments = raw["moments"]
        load_adam_moments(net.optim, net.module, moments)
        net.count = (moments["count"] if moments["schedule_count"] is None
                     else moments["schedule_count"])
    else:
        net.count = 0
    net.step = raw["step"]
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
    if is_torch_file(path):
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
