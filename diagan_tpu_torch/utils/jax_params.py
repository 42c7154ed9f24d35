"""Weight bridge: the JAX package's Flax StyleGAN2 params -> the port's state_dicts.

Input is a Flax param tree as nested dicts of numpy arrays (what
`jax.device_get(variables["params"])` gives); this module never imports jax.
Every leaf goes through exactly one rule; a leaf no rule knows raises, and
`load_state_dict` (strict) then checks that no port parameter was missed.

Layout conversions:
  - conv kernel (kh, kw, I, O)  -> weight (O, I, kh, kw);
  - the upsampling ModulatedConv kernel is also flipped in both spatial axes:
    lax.conv_transpose correlates with the kernel as given, while
    F.conv_transpose2d convolves with it;
  - dense kernel (I, O) -> weight (O, I); the discriminator's first dense
    layer reads a flatten, whose rows go from the JAX (H, W, C) order to the
    port's (C, H, W) order;
  - synthesis input (1, 4, 4, C) -> (1, C, 4, 4).
"""
from __future__ import annotations

import re

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if hasattr(value, "items"):
            yield from _flatten(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), np.asarray(value, dtype=np.float32)


def _conv(k):
    return k.transpose(3, 2, 0, 1)


def _modulated_conv_leaf(rest, arr, upsample):
    """(suffix, array) for a leaf inside a ModulatedConv, or None."""
    if rest == ("kernel",):
        k = _conv(arr)
        return "weight", k[:, :, ::-1, ::-1] if upsample else k
    if rest == ("modulation", "kernel"):
        return "modulation.weight", arr.T
    if rest == ("modulation", "bias"):
        return "modulation.bias", arr
    return None


def _convert(params, rule, what):
    sd = {}
    for path, arr in _flatten(params):
        hit = rule(path, arr)
        if hit is None:
            raise ValueError(f"{what} bridge: no rule for Flax leaf {'/'.join(path)} "
                             f"with shape {arr.shape}")
        key, value = hit
        if key in sd:
            raise ValueError(f"{what} bridge: two leaves map to {key}")
        sd[key] = torch.tensor(np.ascontiguousarray(value))
    return sd


def modulated_conv_state_dict(params, upsample=False):
    """Flax ModulatedConv params -> the port ModulatedConv's state_dict."""
    return _convert(params, lambda path, arr: _modulated_conv_leaf(path, arr, upsample),
                    "ModulatedConv")


def _generator_rule(path, arr):
    if path[0] == "mapping" and len(path) == 3:
        m = re.fullmatch(r"EqualDense_(\d+)", path[1])
        if m and path[2] in ("kernel", "bias"):
            name = "weight" if path[2] == "kernel" else "bias"
            return f"mapping.layers.{m.group(1)}.{name}", arr.T if name == "weight" else arr
        return None
    if path[0] != "synthesis":
        return None
    if path[1:] == ("input",):
        return "synthesis.input", arr.transpose(0, 3, 1, 2)
    layer, rest = path[1], path[2:]
    prefix = f"synthesis.layers.{layer}"
    if not re.fullmatch(r"conv1|to_rgb1|conv_up_\d+|conv_\d+|to_rgb_\d+", layer):
        return None
    if rest and rest[0] == "conv":
        hit = _modulated_conv_leaf(rest[1:], arr, layer.startswith("conv_up_"))
        return None if hit is None else (f"{prefix}.conv.{hit[0]}", hit[1])
    if rest == ("noise", "weight") and not layer.startswith("to_rgb"):
        return f"{prefix}.noise.weight", arr
    if rest == ("bias",):
        return f"{prefix}.bias", arr
    return None


def generator_state_dict(params):
    """Flax StyleGAN2Generator params -> the port generator's state_dict."""
    return _convert(params, _generator_rule, "generator")


def _conv_layer_leaf(rest, arr):
    if rest == ("EqualConv_0", "kernel"):
        return "conv.weight", _conv(arr)
    if rest == ("EqualConv_0", "bias"):
        return "conv.bias", arr
    if rest == ("bias",):
        return "bias", arr
    return None


_D_CONV_LAYERS = {"ConvLayer_0": "from_rgb", "ConvLayer_1": "final_conv"}
_D_BLOCK_LAYERS = {"ConvLayer_0": "conv1", "ConvLayer_1": "conv2", "ConvLayer_2": "skip"}


def _discriminator_rule(path, arr):
    head, rest = path[0], path[1:]
    if head in _D_CONV_LAYERS:
        hit = _conv_layer_leaf(rest, arr)
        return None if hit is None else (f"{_D_CONV_LAYERS[head]}.{hit[0]}", hit[1])
    m = re.fullmatch(r"DResBlock_(\d+)", head)
    if m and rest and rest[0] in _D_BLOCK_LAYERS:
        hit = _conv_layer_leaf(rest[1:], arr)
        if hit is None:
            return None
        return f"blocks.{m.group(1)}.{_D_BLOCK_LAYERS[rest[0]]}.{hit[0]}", hit[1]
    if head == "EqualDense_0" and rest == ("kernel",):
        # rows of the (4, 4, C) NHWC flatten -> the port's (C, 4, 4) flatten
        c = arr.shape[0] // 16
        w = arr.reshape(4, 4, c, -1).transpose(3, 2, 0, 1).reshape(-1, c * 16)
        return "final_linear.weight", w
    if head == "EqualDense_0" and rest == ("bias",):
        return "final_linear.bias", arr
    if head == "EqualDense_1" and rest in (("kernel",), ("bias",)):
        return ("out_linear.weight", arr.T) if rest == ("kernel",) else ("out_linear.bias", arr)
    return None


def discriminator_state_dict(params):
    """Flax StyleGAN2Discriminator params -> the port discriminator's state_dict."""
    return _convert(params, _discriminator_rule, "discriminator")
