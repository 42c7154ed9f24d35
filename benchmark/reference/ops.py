"""Plain-PyTorch versions of the three operations that the port runs in
hand-written kernels, with the backward identities that the port's design
states, and a log of every call for the benchmark's byte and FLOP counts.

  upfirdn2d      zero-stuff by `up`, pad (negative pads crop), correlate with
                 the flipped taps (a depthwise convolution), keep every
                 `down`-th pixel. Its gradient is the same operation with
                 flipped taps, up and down swapped and the pads below, so the
                 second derivative that R1 and the path-length penalty take
                 is the same operation again.
  fused_act      y = sqrt(2) * leaky_relu(x + bias, 0.2); the backward masks
                 the gradient by y > 0 and sums it per channel for the bias;
                 the double backward is the same mask again.
  affine_gather  the bilinear sample of a (N, C, S2, S2) buffer at
                 q = (ay i + by j + cy, ax i + bx j + cx), clamped to the
                 buffer; its gradient is torch's own indexing adjoint.

Nothing here imports the program. When `CALLS` is a list, each call
appends (op, bytes, flops): every input read once, every output written
once, taps and coefficients left out.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

CALLS: list | None = None
SLOPE, GAIN = 0.2, math.sqrt(2.0)


def _log(op, nbytes, flops=0):
    if CALLS is not None:
        CALLS.append((op, int(nbytes), int(flops)))


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def resample_kernel(k):
    """Normalised 2-D taps: outer(k, k) for a 1-D list."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    return k / np.sum(k)


def _pair(v):
    return (int(v[0]), int(v[1])) if isinstance(v, (tuple, list)) else (int(v), int(v))


def _pads(pad):
    return tuple(int(p) for p in pad) if len(pad) == 4 else (int(pad[0]), int(pad[1])) * 2


def _fir_plain(x, taps, up, down, pad):
    (ux, uy), (dx, dy), (px0, px1, py0, py1) = up, down, pad
    n, c, h, w = x.shape
    if (ux, uy) != (1, 1):
        z = x.new_zeros((n, c, h * uy, w * ux))
        z[:, :, ::uy, ::ux] = x
        x = z
    x = F.pad(x, (px0, px1, py0, py1))
    kh, kw = taps.shape
    weight = torch.flip(taps, (0, 1)).to(x.dtype).expand(c, 1, kh, kw)
    return F.conv2d(x, weight, stride=(dy, dx), groups=c)


class _Fir(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, taps, up, down, pad):
        y = _fir_plain(x, taps, up, down, pad)
        (ux, uy), kh, kw = up, *taps.shape
        _log("fir", _nbytes(x, y), 2 * y.numel() * -(-kh // uy) * -(-kw // ux))
        ctx.save_for_backward(taps)
        ctx.args = (x.shape[2:], y.shape[2:], up, down, pad)
        return y

    @staticmethod
    def backward(ctx, g):
        (taps,) = ctx.saved_tensors
        (in_h, in_w), (out_h, out_w), (ux, uy), (dx, dy), (px0, px1, py0, py1) = ctx.args
        kh, kw = taps.shape
        g_pad = (kw - px0 - 1, in_w * ux - out_w * dx + px0 - ux + 1,
                 kh - py0 - 1, in_h * uy - out_h * dy + py0 - uy + 1)
        return (_Fir.apply(g.contiguous(), torch.flip(taps, (0, 1)), (dx, dy), (ux, uy), g_pad),
                None, None, None, None)


def upfirdn2d(x, taps, up=1, down=1, pad=(0, 0)):
    """x (N, C, H, W) fp32; taps (kh, kw); up / down int or (x, y); pad
    (p0, p1) for both axes or (x0, x1, y0, y1)."""
    taps = torch.as_tensor(taps, dtype=torch.float32, device=x.device)
    return _Fir.apply(x, taps, _pair(up), _pair(down), _pads(pad))


def _bias(x, b):
    return b.reshape((1, -1) + (1,) * (x.ndim - 2))


def _act_bwd(g, y, extra=None):
    h = g if extra is None else g + _bias(g, extra)
    return torch.where(y > 0, h, h * SLOPE) * GAIN


class _Act(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias):
        y = x + _bias(x, bias)
        y = torch.where(y > 0, y, y * SLOPE) * GAIN
        _log("act", _nbytes(x, y, bias))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return _ActBackward.apply(g, y)


class _ActBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, y):
        dx = _act_bwd(g, y)
        db = dx.sum((0,) + tuple(range(2, g.ndim)))
        _log("act", _nbytes(g, y, dx, db))
        ctx.save_for_backward(y)
        return dx, db

    @staticmethod
    def backward(ctx, gg_dx, gg_db):
        (y,) = ctx.saved_tensors
        if gg_dx is None:
            gg_dx = torch.zeros_like(y)
        dg = _act_bwd(gg_dx, y, gg_db)
        _log("act", _nbytes(gg_dx, y, dg))
        return dg, None


def fused_act(x, bias):
    return _Act.apply(x, bias)


def _gather_taps(coef, win, s2):
    idx = torch.arange(win, dtype=torch.float32, device=coef.device)
    ii = idx[:, None].expand(win, win).reshape(1, -1)
    jj = idx[None, :].expand(win, win).reshape(1, -1)
    ay, by, cy, ax, bx, cx = (coef[:, k:k + 1] for k in range(6))
    qy = (ay * ii + by * jj + cy).clamp(0.0, s2 - 1.0)
    qx = (ax * ii + bx * jj + cx).clamp(0.0, s2 - 1.0)
    fy, fx = torch.floor(qy), torch.floor(qx)
    y0, x0 = fy.long(), fx.long()
    y1, x1 = (y0 + 1).clamp(max=s2 - 1), (x0 + 1).clamp(max=s2 - 1)
    wy, wx = qy - fy, qx - fx
    return [y0 * s2 + x0, y0 * s2 + x1, y1 * s2 + x0, y1 * s2 + x1], wy, wx


def _gather_plain(x2, coef, win):
    n, c, s2, _ = x2.shape
    index, wy, wx = _gather_taps(coef, win, s2)
    flat = x2.reshape(n, c, s2 * s2)
    at = [torch.gather(flat, 2, i[:, None, :].expand(n, c, -1)) for i in index]
    wy, wx = wy[:, None], wx[:, None]
    top = at[0] * (1 - wx) + at[1] * wx
    bot = at[2] * (1 - wx) + at[3] * wx
    return (top * (1 - wy) + bot * wy).reshape(n, c, win, win)


def touched_pixels(coef, win, s2):
    """The number of distinct buffer pixels that the warp reads, summed over
    the images (coef on a real device)."""
    index, _, _ = _gather_taps(coef, win, s2)
    mark = torch.zeros((coef.shape[0], s2 * s2), dtype=torch.bool, device=coef.device)
    for i in index:
        mark.scatter_(1, i, True)
    return int(mark.sum())


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, coef, win, touched):
        y = _gather_plain(x2, coef, win)
        if CALLS is not None:
            if touched is None:
                touched = touched_pixels(coef, win, x2.shape[-1])
            _log("gather", touched * x2.shape[1] * x2.element_size() + _nbytes(y))
        ctx.save_for_backward(coef)
        ctx.shape = x2.shape
        return y

    @staticmethod
    def backward(ctx, g):
        (coef,) = ctx.saved_tensors
        with torch.enable_grad():
            x2 = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device, requires_grad=True)
            (dx2,) = torch.autograd.grad(_gather_plain(x2, coef, g.shape[-1]), x2, g)
        _log("scatter", _nbytes(g, dx2))
        return dx2, None, None, None


def affine_gather(x2, coef, win, touched=None):
    """touched: the count of `touched_pixels`, for a count on the meta device."""
    return _Gather.apply(x2, coef.float(), int(win), touched)
