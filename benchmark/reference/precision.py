"""The precision the reference computes in: "fp32" (IEEE, TF32 off, as the
configurations state) or "tf32", the control one step below it. On the card
"tf32" switches cuDNN and cuBLAS to TF32; elsewhere it rounds the operands of
every convolution and matrix product of the forward to TF32's 10-bit
mantissa (round to nearest even), which is what TF32 does to them before it
accumulates in fp32 (the backward's products stay fp32 there).
"""
from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

_PRODUCTS = {F.conv2d, F.conv_transpose2d, F.linear, torch.matmul, torch.Tensor.matmul,
             torch.Tensor.__matmul__, torch.mm, torch.bmm}


def to_tf32(x):
    """fp32 -> the nearest TF32 value (10 mantissa bits), as fp32; the
    gradient passes through as it is."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        return x
    i = x.detach().contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    r = ((i + 0xFFF + lsb) & ~0x1FFF).view(torch.float32).reshape(x.shape)
    return x + (r - x).detach() if x.requires_grad else r


class _RoundProducts(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            args = tuple(to_tf32(a) if i < 2 else a for i, a in enumerate(args))
        return func(*args, **kwargs)


@contextmanager
def lowered(precision, device_type="cuda"):
    if precision == "fp32":
        yield
        return
    if precision != "tf32":
        raise ValueError(precision)
    if device_type == "cuda":
        old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old
        return
    with _RoundProducts():
        yield
