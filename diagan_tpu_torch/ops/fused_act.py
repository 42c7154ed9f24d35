"""Fused bias-add + LeakyReLU (+ sqrt(2) gain).

    y = scale * leaky_relu(x + bias, negative_slope)

with `bias` broadcast over the channel axis: dim 1 of an (N, C, H, W) map or
of an (N, C) matrix (mapping network and discriminator head). Same forward as
the JAX package's fused_leaky_relu (the reference's fused_bias_act, act=3).

`fused_leaky_relu` launches the Triton kernel for a CUDA tensor and runs
`fused_leaky_relu_plain` for a CPU tensor, and does nothing else. The kernel
has no backward yet: autograd through it on the card raises.
"""
from __future__ import annotations

import functools
import math

import torch

_SLOPE = 0.2
_SCALE = math.sqrt(2.0)
_BLOCK = 1024


def _bias_view(x, bias):
    return bias.reshape((1, -1) + (1,) * (x.ndim - 2))


def fused_leaky_relu_plain(x, bias, negative_slope=_SLOPE, scale=_SCALE):
    """Plain-torch version: fp32 math, one rounding to x's dtype at the end."""
    y = x.float() + _bias_view(x, bias).float()
    return (torch.where(y > 0, y, y * negative_slope) * scale).to(x.dtype)


@functools.cache
def _kernel():
    """Compile-on-demand Triton kernel. triton is imported here, at the first
    launch, because machines without a card have no triton; the names are
    bound as module globals so the jitted body resolves them."""
    global triton, tl
    import triton
    import triton.language as tl

    @triton.jit
    def flr_fwd(x_ptr, b_ptr, y_ptr, numel, inner, channels, slope, scale,
                BLOCK: tl.constexpr):
        # Replaces diagan_tpu/ops/fused_act.py:_pallas_forward. Bound: bytes
        # (x read once, y written once, 2 flops per element); one program
        # streams BLOCK contiguous elements, the channel of each comes from
        # its flat offset, and the bias gather hits L1 (C floats).
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < numel
        ch = (offs // inner) % channels
        x = tl.load(x_ptr + offs, mask=mask).to(tl.float32)
        b = tl.load(b_ptr + ch, mask=mask).to(tl.float32)
        v = x + b
        v = tl.where(v > 0, v, v * slope) * scale
        tl.store(y_ptr + offs, v.to(y_ptr.dtype.element_ty), mask=mask)

    return flr_fwd


def _launch(x, bias, negative_slope, scale):
    from diagan_tpu_torch.ops import _build

    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_leaky_relu kernel takes float32 or bfloat16, got {x.dtype}")
    if x.ndim not in (2, 4):
        raise ValueError(f"fused_leaky_relu takes (N, C) or (N, C, H, W), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("fused_leaky_relu kernel takes a contiguous tensor")
    c = x.shape[1]
    if bias.shape != (c,) or bias.device != x.device or not bias.is_contiguous():
        raise ValueError(f"bias must be a contiguous ({c},) tensor on x's device")
    y = torch.empty_like(x)
    numel = x.numel()
    if numel == 0:
        return y
    inner = 1 if x.ndim == 2 else x.shape[2] * x.shape[3]
    grid = (-(-numel // _BLOCK),)
    with torch.cuda.device(x.device):
        _kernel()[grid](x, bias, y, numel, inner, c, float(negative_slope),
                        float(scale), BLOCK=_BLOCK, num_warps=4)
    _build.LAUNCHES["fused_leaky_relu"] += 1
    return y


class _FusedLeakyReLUCUDA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias, negative_slope, scale):
        return _launch(x, bias, negative_slope, scale)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "fused_leaky_relu has no backward kernel on CUDA yet (it comes "
            "with the training slice); run sampling under torch.no_grad()")


def fused_leaky_relu(x, bias, negative_slope=_SLOPE, scale=_SCALE):
    """y = scale * leaky_relu(x + bias) with bias over dim 1 of (N, C[, H, W])."""
    if x.device.type == "cpu":
        return fused_leaky_relu_plain(x, bias, negative_slope, scale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_leaky_relu runs on cpu or cuda tensors, got {x.device}")
    return _FusedLeakyReLUCUDA.apply(x, bias, negative_slope, scale)
