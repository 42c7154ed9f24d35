"""upfirdn2d: upsample -> pad -> 2-D FIR filter -> downsample, on NCHW tensors.

Same semantics and argument forms as the JAX package's upfirdn2d (the
reference's `upfirdn2d_native`):

  1. zero-stuff each pixel with (up - 1) trailing zeros per axis,
  2. pad by (pad0, pad1) per axis (negative pads crop),
  3. cross-correlate with the flipped kernel (a true convolution),
  4. keep every `down`-th output pixel.

  out = (in * up + pad0 + pad1 - k) // down + 1   per spatial axis.

`upfirdn2d` launches the CUDA kernel (csrc/upfirdn2d.cu) for a CUDA tensor and
runs `upfirdn2d_plain` for a CPU tensor, and does nothing else. Its backward
is the same op again (the JAX package's g_pad VJP, fir_pallas.py:379-399):
flipped taps, up and down swapped, pads chosen so the result has the input's
size. Because that backward is the same differentiable Function, the second
derivative (R1, path regularisation) follows without more code. Launches made
from a backward count under "upfirdn2d_backward", the others under
"upfirdn2d".

The kernel has one instance per shape family of the main paths (4x4 blurs at
up or down 1 or 2, ADA's 12-tap passes, the polyphase 6-tap and 6x6 passes)
and a generic one for anything else. `fir_instance` chooses it from the
arguments alone, so the choice is testable without a card; each launch also
counts under its instance's name in `_build.FIR_INSTANCES`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from diagan_tpu_torch.ops import _build


def make_resample_kernel(k: Sequence[float]) -> np.ndarray:
    """Normalized 2-D FIR taps from a 1-D (separable, outer(k, k)) or 2-D
    tap list; the taps sum to 1 (reference stylegan2/model.py make_kernel)."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    return k / np.sum(k)


def _as_pair(v) -> tuple[int, int]:
    if isinstance(v, (tuple, list)):
        a, b = v
        return int(a), int(b)
    return int(v), int(v)


def _parse(up, down, pad):
    """((up_x, up_y), (down_x, down_y), (p_x0, p_x1, p_y0, p_y1))."""
    if len(pad) == 2:
        p = (int(pad[0]), int(pad[1]), int(pad[0]), int(pad[1]))
    elif len(pad) == 4:
        p = tuple(int(v) for v in pad)
    else:
        raise ValueError(f"pad must have 2 or 4 entries, got {pad!r}")
    (up_x, up_y), (down_x, down_y) = _as_pair(up), _as_pair(down)
    if min(up_x, up_y, down_x, down_y) < 1:
        raise ValueError(f"up and down must be >= 1, got up={up!r} down={down!r}")
    return (up_x, up_y), (down_x, down_y), p


def _out_size(n, up, p0, p1, k, down):
    return (n * up + p0 + p1 - k) // down + 1


def _taps(kernel, device) -> torch.Tensor:
    k = torch.as_tensor(kernel, dtype=torch.float32, device=device)
    if k.ndim != 2:
        raise ValueError(f"kernel must be 2-D (kh, kw), got shape {tuple(k.shape)}")
    return k


def upfirdn2d_plain(x, kernel, up=1, down=1, pad=(0, 0)):
    """Plain-torch upfirdn2d on (N, C, H, W): explicit zero-stuff, pad/crop,
    correlation with the flipped taps as a sum of shifted slices, stride.
    fp32 accumulation; the result has x's dtype."""
    (up_x, up_y), (down_x, down_y), (p_x0, p_x1, p_y0, p_y1) = _parse(up, down, pad)
    k = _taps(kernel, x.device)
    kh, kw = k.shape
    n, c, h, w = x.shape
    xf = x.float()
    z = xf.new_zeros((n, c, h * up_y, w * up_x))
    z[:, :, ::up_y, ::up_x] = xf
    # F.pad-style pads: negative values crop
    z = torch.nn.functional.pad(z, (p_x0, p_x1, p_y0, p_y1))
    oh = (z.shape[2] - kh) // down_y + 1
    ow = (z.shape[3] - kw) // down_x + 1
    kflip = torch.flip(k, (0, 1))
    out = xf.new_zeros((n, c, oh, ow))
    for ky in range(kh):
        for kx in range(kw):
            tap = z[:, :, ky: ky + (oh - 1) * down_y + 1: down_y,
                    kx: kx + (ow - 1) * down_x + 1: down_x]
            out = out + kflip[ky, kx] * tap
    return out.to(x.dtype)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# The kernel's instances, in the order of their codes (csrc/upfirdn2d.cu,
# enum Instance), and the family each takes:
# (kh, kw, (up_x, up_y), (down_x, down_y)) -> instance name.
FIR_INSTANCES = ("generic", "fir4x4", "fir4x4_up2", "fir4x4_down2", "fir6x6", "fir6y",
                 "fir12y_up2", "fir12y_down2", "fir12x_up2", "fir12x_down2")
_FAMILIES = {
    (4, 4, (1, 1), (1, 1)): "fir4x4",
    (4, 4, (2, 2), (1, 1)): "fir4x4_up2",
    (4, 4, (1, 1), (2, 2)): "fir4x4_down2",
    (6, 6, (1, 1), (1, 1)): "fir6x6",
    (6, 1, (1, 1), (1, 1)): "fir6y",
    (12, 1, (1, 2), (1, 1)): "fir12y_up2",
    (12, 1, (1, 1), (1, 2)): "fir12y_down2",
    (1, 12, (2, 1), (1, 1)): "fir12x_up2",
    (1, 12, (1, 1), (2, 1)): "fir12x_down2",
}
_build.FIR_INSTANCES.update(dict.fromkeys(FIR_INSTANCES, 0))


def fir_instance(kh, kw, up, down, dtype, layout) -> str:
    """The kernel instance for taps (kh, kw), `up` and `down` (int or (x, y)),
    a float32 or bfloat16 `dtype`, and the input's memory `layout`
    (torch.contiguous_format or torch.channels_last): a family's own
    instance for contiguous NCHW, "generic" otherwise. Pads do not matter:
    every instance takes any pad."""
    (up_x, up_y), (down_x, down_y) = _as_pair(up), _as_pair(down)
    if layout != torch.contiguous_format or dtype not in _DTYPE_CODE:
        return "generic"
    return _FAMILIES.get((kh, kw, (up_x, up_y), (down_x, down_y)), "generic")


@functools.cache
def _forward_fn():
    """The C entry point of csrc/upfirdn2d.cu, built at first use."""
    fn = _build.load("upfirdn2d").upfirdn2d_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 8
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    return fn


def layout(x):
    """x's memory format as the kernel reads it: torch.contiguous_format,
    torch.channels_last, or None for any other strides."""
    if x.is_contiguous():
        return torch.contiguous_format
    if x.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    return None


def _launch(x, taps, up, down, pad, counter):
    (up_x, up_y), (down_x, down_y), (p_x0, p_x1, p_y0, p_y1) = _parse(up, down, pad)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"upfirdn2d kernel takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"upfirdn2d takes (N, C, H, W), got shape {tuple(x.shape)}")
    fmt = layout(x)
    if fmt is None:
        raise ValueError("upfirdn2d kernel takes a contiguous NCHW or channels-last tensor")
    if taps.device != x.device or taps.dtype != torch.float32 or not taps.is_contiguous():
        raise ValueError("taps must be a contiguous float32 tensor on x's device")
    n, c, h, w = x.shape
    kh, kw = taps.shape
    oh = _out_size(h, up_y, p_y0, p_y1, kh, down_y)
    ow = _out_size(w, up_x, p_x0, p_x1, kw, down_x)
    if oh <= 0 or ow <= 0:
        raise ValueError(f"upfirdn2d output would be empty ({oh}x{ow})")
    y = torch.empty((n, c, oh, ow), dtype=x.dtype, device=x.device, memory_format=fmt)
    sx, sy = x.stride(), y.stride()
    instance = fir_instance(kh, kw, up, down, x.dtype, fmt)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _forward_fn()(x.data_ptr(), y.data_ptr(), taps.data_ptr(),
                            _DTYPE_CODE[x.dtype], FIR_INSTANCES.index(instance),
                            n, c, h, w, oh, ow, *sx, *sy,
                            kh, kw, up_x, up_y, down_x, down_y, p_x0, p_y0, stream)
    if err == -1:
        raise RuntimeError(f"upfirdn2d: instance {instance} does not fit taps ({kh}, {kw}), "
                           f"up {up}, down {down}, strides {sx} -> {sy}")
    if err != 0:
        raise RuntimeError(f"upfirdn2d kernel launch failed: cudaError {err}")
    _build.LAUNCHES[counter] += 1
    _build.FIR_INSTANCES[instance] += 1
    if x.dtype == torch.bfloat16:
        _build.count_bf16(counter)
        _build.count_bf16(f"upfirdn2d/{instance}")
    return y


def _backward_args(in_hw, out_hw, kh, kw, up, down, pad):
    """(up, down, pad) of the op that maps the output's gradient back to the
    input's: up and down swap, pads (x0, x1, y0, y1) as in fir_pallas.py:388-391."""
    (up_x, up_y), (down_x, down_y), (p_x0, p_x1, p_y0, p_y1) = _parse(up, down, pad)
    (in_h, in_w), (out_h, out_w) = in_hw, out_hw
    g_pad = (kw - p_x0 - 1, in_w * up_x - out_w * down_x + p_x0 - up_x + 1,
             kh - p_y0 - 1, in_h * up_y - out_h * down_y + p_y0 - up_y + 1)
    return (down_x, down_y), (up_x, up_y), g_pad


class _Upfirdn2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, taps, up, down, pad, counter):
        if x.device.type == "cpu":
            y = upfirdn2d_plain(x, taps, up, down, pad)
        else:
            y = _launch(x, taps, up, down, pad, counter)
        ctx.save_for_backward(taps)
        ctx.args = (tuple(x.shape[2:]), tuple(y.shape[2:]), up, down, pad)
        return y

    @staticmethod
    def backward(ctx, grad):
        (taps,) = ctx.saved_tensors
        in_hw, out_hw, up, down, pad = ctx.args
        kh, kw = taps.shape
        g_up, g_down, g_pad = _backward_args(in_hw, out_hw, kh, kw, up, down, pad)
        flipped = torch.flip(taps, (0, 1)).contiguous()
        dx = _Upfirdn2d.apply(grad.contiguous(), flipped, g_up, g_down, g_pad,
                              "upfirdn2d_backward")
        return dx, None, None, None, None, None


def upfirdn2d(x, kernel, up=1, down=1, pad=(0, 0)):
    """Fused upsample-FIR-downsample on (N, C, H, W).

    Args:
      x: (N, C, H, W) tensor; on CUDA it must be contiguous NCHW or channels-last.
      kernel: (kh, kw) FIR taps (see `make_resample_kernel`), array or tensor.
      up / down: int or (x, y) pair of integer resampling factors.
      pad: (pad0, pad1) for both spatial axes, or (x0, x1, y0, y1).

    Returns (N, C, H', W') with H' = (H*up + pad0 + pad1 - kh)//down + 1.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"upfirdn2d runs on cpu or cuda tensors, got {x.device}")
    _parse(up, down, pad)
    taps = _taps(kernel, x.device).contiguous()
    return _Upfirdn2d.apply(x, taps, up, down, pad, "upfirdn2d")
