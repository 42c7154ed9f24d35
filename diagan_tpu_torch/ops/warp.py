"""ADA's per-image affine bilinear warp and its adjoint, on NCHW planes.

Counterpart of diagan_tpu/ops/warp_pallas.py (`affine_gather`). For output
pixel (i, j) of image n, with coef[n] = [ay, by, cy, ax, bx, cx] (the JAX
order),

    qy = ay*i + by*j + cy,   qx = ax*i + bx*j + cx,

clamped to [0, S2 - 1] (torch grid_sample's padding_mode="border", which the
reference relies on after its reflect pad), and the output is the bilinear
sample of x2 there. x2 is (N, C, S2, S2); the output (N, C, win, win).

`affine_gather` is differentiable in x2, first order only: its backward is
the adjoint dx2[y, x] = sum_p g[p] * hat(qy_p - y) * hat(qx_p - x) from the
same clamped coordinates, and the coefficients get no gradient (they are
random draws). R1 differentiates with respect to the already augmented image,
so nothing takes a second derivative through the warp.

Each of the two halves launches its CUDA kernel (csrc/affine_warp.cu) for a
CUDA tensor and runs its plain-torch version for a CPU tensor, and does
nothing else: `affine_gather_plain` (indexing) and `affine_scatter_plain`
(autograd through that indexing).
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable


def _taps(coef, win, s2):
    """Flat indices of the four neighbours (N, win*win) and the weights
    (1 - fy, fy, 1 - fx, fx), each (N, 1, win*win), in the kernel's order of
    operations (no fused multiply-add anywhere)."""
    idx = torch.arange(win, dtype=torch.float32, device=coef.device)
    ii = idx[:, None].expand(win, win).reshape(1, -1)
    jj = idx[None, :].expand(win, win).reshape(1, -1)
    ay, by, cy, ax, bx, cx = (coef[:, k:k + 1] for k in range(6))
    qy = (ay * ii + by * jj + cy).clamp(0.0, s2 - 1.0)
    qx = (ax * ii + bx * jj + cx).clamp(0.0, s2 - 1.0)
    fly, flx = torch.floor(qy), torch.floor(qx)
    y0, x0 = fly.long(), flx.long()
    y1, x1 = (y0 + 1).clamp(max=s2 - 1), (x0 + 1).clamp(max=s2 - 1)
    fy, fx = qy - fly, qx - flx
    index = [y0 * s2 + x0, y0 * s2 + x1, y1 * s2 + x0, y1 * s2 + x1]
    weight = [(1 - fy)[:, None], fy[:, None], (1 - fx)[:, None], fx[:, None]]
    return index, weight


def affine_gather_plain(x2, coef, win):
    """Plain-torch warp: gathers of the four neighbours, then the bilinear
    blend. Differentiable in x2 through torch's own indexing backward."""
    n, c, s2, _ = x2.shape
    index, (wy0, wy1, wx0, wx1) = _taps(coef.float(), win, s2)
    flat = x2.float().reshape(n, c, s2 * s2)

    def at(k):
        return torch.gather(flat, 2, index[k][:, None, :].expand(n, c, -1))

    top = at(0) * wx0 + at(1) * wx1
    bot = at(2) * wx0 + at(3) * wx1
    return (top * wy0 + bot * wy1).reshape(n, c, win, win)


def affine_scatter_plain(g, coef, s2):
    """Plain-torch adjoint: the gradient of `affine_gather_plain` with
    respect to x2, for the upstream gradient g (N, C, win, win)."""
    n, c, win, _ = g.shape
    with torch.enable_grad():
        x2 = torch.zeros((n, c, s2, s2), dtype=torch.float32, device=g.device,
                         requires_grad=True)
        out = affine_gather_plain(x2, coef, win)
        (dx2,) = torch.autograd.grad(out, x2, g.float())
    return dx2


@functools.cache
def _fns():
    """The C entry points of csrc/affine_warp.cu, built at first use."""
    from diagan_tpu_torch.ops import _build

    lib = _build.load("affine_warp")
    out = []
    for name in ("affine_warp_gather", "affine_warp_scatter"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        out.append(fn)
    return tuple(out)


def _check(name, t, ndim):
    if t.dtype != torch.float32 or t.ndim != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 tensor with {ndim} dims, "
                         f"got {t.dtype} {tuple(t.shape)}")


def _check_coef(coef, n, device):
    if coef.shape != (n, 6) or coef.device != device:
        raise ValueError(f"coef must be ({n}, 6) on the input's device, got {tuple(coef.shape)}")
    _check("coef", coef, 2)


def _launch(which, src, coef, out, s2, win):
    from diagan_tpu_torch.ops import _build

    n, c = src.shape[:2]
    _check_coef(coef, n, src.device)
    fn = _fns()[0 if which == "affine_warp_gather" else 1]
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = fn(src.data_ptr(), coef.data_ptr(), out.data_ptr(), n, c, s2, win, stream)
    if err != 0:
        raise RuntimeError(f"{which} kernel launch failed: cudaError {err}")
    _build.LAUNCHES[which] += 1
    return out


def _gather(x2, coef, win):
    if x2.device.type == "cpu":
        return affine_gather_plain(x2, coef, win)
    _check("x2", x2, 4)
    n, c, s2, _ = x2.shape
    out = torch.empty((n, c, win, win), dtype=torch.float32, device=x2.device)
    return _launch("affine_warp_gather", x2, coef, out, s2, win)


def affine_scatter(g, coef, s2):
    """The adjoint alone (no autograd): dx2 (N, C, s2, s2) fp32 for the
    upstream gradient g (N, C, win, win); the kernel on CUDA, the plain
    version on CPU."""
    coef = coef.float().contiguous()
    if g.device.type == "cpu":
        return affine_scatter_plain(g, coef, s2)
    g = g.float().contiguous()
    _check("g", g, 4)
    n, c, win, _ = g.shape
    out = torch.empty((n, c, s2, s2), dtype=torch.float32, device=g.device)
    return _launch("affine_warp_scatter", g, coef, out, s2, win)


class _AffineGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, coef, win):
        ctx.save_for_backward(coef)
        ctx.s2 = x2.shape[2]
        return _gather(x2, coef, win)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (coef,) = ctx.saved_tensors
        return affine_scatter(g, coef, ctx.s2), None, None


def affine_gather(x2, coef, win):
    """Warp x2 (N, C, S2, S2) fp32 onto a win x win grid per image, with coef
    (N, 6) = [ay, by, cy, ax, bx, cx]; differentiable once in x2."""
    if x2.device.type not in ("cpu", "cuda"):
        raise ValueError(f"affine_gather runs on cpu or cuda tensors, got {x2.device}")
    if x2.ndim != 4 or x2.shape[2] != x2.shape[3]:
        raise ValueError(f"affine_gather takes a square (N, C, S2, S2) buffer, got {tuple(x2.shape)}")
    return _AffineGather.apply(x2, coef.float().contiguous(), int(win))
