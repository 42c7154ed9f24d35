"""Two-phase (polyphase-y) affine bilinear warp for ADA's polyphase resample.

Counterpart of diagan_tpu/ops/ada_phase.py (`affine_gather_2phase`). The 2x
buffer x2 (S2 x S2) of the resample is held as its two y-phase planes,
v_phi[m, x] = x2[2m + phi, x], each (N, C, S2/2, S2); the warp reads them
and emits its output split by both output parities, the four quarter grids
Y_ab[uy, ux] = out[2uy + a, 2ux + b], each (N, C, win/2, win/2), which the
polyphase downsample reads as four stride-1 FIRs (models/ada.py). The warp
itself is `affine_gather`'s (ops/warp.py): coef[n] = [ay, by, cy, ax, bx, cx],
source point clamped to [0, S2 - 1], bilinear.

The planes are exactly (S2/2, S2): the JAX package pads them to the TPU's
(8, 128) tiling before its kernel (diagan_tpu/models/ada.py:273-278), which
the GPU kernels do not need.

`affine_gather_2phase` is differentiable once in (v0, v1); its backward is
the adjoint `affine_scatter2`, and coef gets no gradient (random draws; R1
differentiates after the augment). Each half launches its CUDA kernel
(csrc/affine_warp.cu: gather2_kernel; scatter2_kernel, then
scatter2_clamped_kernel) for CUDA tensors and runs its plain-torch version
for CPU tensors, and does nothing else: `affine_gather2_plain` (interleave
the planes, `affine_gather_plain`, split by parity, as the JAX package's
`_gather2_xla`) and `affine_scatter2_plain` (autograd through it).

Both kernels are the interleaved pair's tile passes (ops/warp.py) with two
address maps changed. The gather stages each output tile's source box
(`_gather_tile_boxes`) from the planes, box row by box row, and stores its
outputs into the quarter grids; `_phase_box_rows` repeats its staging map in
plain torch. The adjoint owns its tiles of the S2 x S2 buffer and writes
every pixel of both planes once, with no memset and no global atomic
outside its clamped-output pass. `_quarter_offsets` and `_plane_offsets`
repeat its two maps in plain torch, and `_phase_tile_rows` the plane rows
that each buffer tile writes, so that the CPU tests can check them.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from diagan_tpu_torch.ops.warp import (
    SCATTER_TILE,
    _check,
    _check_coef,
    _tile_starts,
    affine_gather_plain,
)

PARITIES = ((0, 0), (0, 1), (1, 0), (1, 1))  # (a, b) of Y_ab, in output order


def affine_gather2_plain(v0, v1, coef, win):
    """Plain-torch two-phase warp: the planes interleaved back into the
    (N, C, S2, S2) buffer, the plain warp, and its output split by parity.
    Returns (Y00, Y01, Y10, Y11), each (N, C, win/2, win/2); differentiable
    in the planes through torch's own indexing backward."""
    n, c, s, s2 = v0.shape
    x2 = torch.stack([v0.float(), v1.float()], 3).reshape(n, c, 2 * s, s2)
    y = affine_gather_plain(x2, coef, win)
    return tuple(y[:, :, a::2, b::2] for a, b in PARITIES)


def affine_scatter2_plain(gs, coef, s2):
    """Plain-torch adjoint: the gradients (dv0, dv1) of `affine_gather2_plain`
    for the four quarter-grid cotangents gs (a sequence of four, or one
    (4, N, C, win/2, win/2) tensor)."""
    gs = [g.float() for g in gs]
    n, c, h2, _ = gs[0].shape
    with torch.enable_grad():
        v = [torch.zeros((n, c, s2 // 2, s2), dtype=torch.float32, device=gs[0].device,
                         requires_grad=True) for _ in range(2)]
        ys = affine_gather2_plain(*v, coef, 2 * h2)
        dv0, dv1 = torch.autograd.grad(ys, v, gs)
    return dv0, dv1


def _quarter_offsets(n, c, win, device=None):
    """The adjoint's map from outputs to its cotangent buffer: the flat
    offset in the (4, N, C, win/2, win/2) quarter grids of output (i, j) of
    image n, channel c, as an (N, C, win, win) int64 tensor. Output (i, j)
    lies in quarter grid (i & 1) * 2 + (j & 1) at (i >> 1, j >> 1)."""
    h2 = win // 2
    idx = torch.arange(win, device=device)
    i, j = idx[:, None], idx[None, :]
    nc = torch.arange(n * c, device=device).reshape(n, c, 1, 1)
    quarter = (i & 1) * 2 + (j & 1)
    return ((quarter * (n * c) + nc) * h2 + (i >> 1)) * h2 + (j >> 1)


def _plane_offsets(n, c, s2, device=None):
    """The adjoint's map from buffer pixels to its planes: the flat offset
    in the stacked (2, N, C, s2/2, s2) planes of pixel (y, x) of image n,
    channel c, as an (N, C, s2, s2) int64 tensor. Row y lies in plane y & 1
    at row y >> 1."""
    idx = torch.arange(s2, device=device)
    y, x = idx[:, None], idx[None, :]
    nc = torch.arange(n * c, device=device).reshape(n, c, 1, 1)
    return (((y & 1) * (n * c) + nc) * (s2 // 2) + (y >> 1)) * s2 + x


def _phase_tile_rows(s2, tile=SCATTER_TILE):
    """The plane rows that each row of the adjoint's buffer tiles writes:
    (TI, 2, 2) [phase, (first, last)] inclusive. A tile's rows [r0, r1]
    start at an even r0, so plane phi takes rows m with r0 <= 2m + phi <= r1."""
    r0, r1 = _tile_starts(s2, tile[0])
    rows = [torch.stack([(r0 - phi + 1) // 2, (r1 - phi) // 2], -1) for phi in (0, 1)]
    return torch.stack(rows, 1)


def _phase_box_rows(boxes):
    """The two-phase gather's staging map: box row r of each source box of
    `_gather_tile_boxes`, boxes (N, TI, TJ, 4) [y_lo, y_hi, x_lo, x_hi]
    inclusive, is copied from buffer row y = y_lo + r, which is row y >> 1
    of plane y & 1. Returns (plane, row), each (N, TI, TJ, H) int64 with H
    the tallest box's height, -1 past each box's last row."""
    height = boxes[..., 1] - boxes[..., 0] + 1
    r = torch.arange(int(height.max()))
    y = boxes[..., 0, None] + r
    inside = r < height[..., None]
    return torch.where(inside, y & 1, -1), torch.where(inside, y >> 1, -1)


@functools.cache
def _fns():
    """The two-phase C entry points of csrc/affine_warp.cu, built at first use."""
    from diagan_tpu_torch.ops import _build

    lib = _build.load("affine_warp")
    gather, scatter = lib.affine_warp2_gather, lib.affine_warp2_scatter
    for fn in (gather, scatter):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return gather, scatter


def _launch(which, pointers, n, c, s2, win, device):
    from diagan_tpu_torch.ops import _build

    fn = _fns()[0 if which == "affine_warp2_gather" else 1]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(t.data_ptr() for t in pointers), n, c, s2, win, stream)
    if err != 0:
        raise RuntimeError(f"{which} kernel launch failed: cudaError {err}")
    _build.LAUNCHES[which] += 1


def _gather2(v0, v1, coef, win):
    """(4, N, C, win/2, win/2): the four quarter grids in one buffer."""
    if v0.device.type == "cpu":
        return torch.stack(affine_gather2_plain(v0, v1, coef, win))
    _check("v0", v0, 4)
    _check("v1", v1, 4)
    n, c, _, s2 = v0.shape
    _check_coef(coef, n, v0.device)
    out = torch.empty((4, n, c, win // 2, win // 2), dtype=torch.float32, device=v0.device)
    _launch("affine_warp2_gather", (v0, v1, coef, out), n, c, s2, win, v0.device)
    return out


def affine_scatter2(gs, coef, s2):
    """The adjoint alone (no autograd): (dv0, dv1), each (N, C, s2/2, s2)
    fp32, for the four quarter-grid cotangents gs (a sequence of four
    (N, C, win/2, win/2), or one (4, N, C, win/2, win/2) tensor); the kernel
    on CUDA, the plain version on CPU. The kernel owns its tiles and writes
    every pixel of both planes, so they start from torch.empty."""
    coef = coef.float().contiguous()
    g = torch.stack(tuple(gs)) if not torch.is_tensor(gs) else gs
    if g.device.type == "cpu":
        return affine_scatter2_plain(g, coef, s2)
    g = g.float().contiguous()
    _check("g", g, 5)
    if g.shape[0] != 4 or g.shape[3] != g.shape[4] or s2 % 2:
        raise ValueError(f"affine_scatter2 takes four square quarter grids and an even s2, "
                         f"got {tuple(g.shape)} and s2={s2}")
    _, n, c, h2, _ = g.shape
    _check_coef(coef, n, g.device)
    dv = torch.empty((2, n, c, s2 // 2, s2), dtype=torch.float32, device=g.device)
    _launch("affine_warp2_scatter", (g, coef, dv[0], dv[1]), n, c, s2, 2 * h2, g.device)
    return dv[0], dv[1]


class _AffineGather2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v0, v1, coef, win):
        ctx.save_for_backward(coef)
        ctx.s2 = v0.shape[3]
        return tuple(_gather2(v0, v1, coef, win).unbind(0))

    @staticmethod
    @once_differentiable
    def backward(ctx, *gs):
        (coef,) = ctx.saved_tensors
        dv0, dv1 = affine_scatter2(gs, coef, ctx.s2)
        return dv0, dv1, None, None


def affine_gather_2phase(v0, v1, coef, win, s2):
    """Warp the 2x buffer held as its y-phase planes v0, v1 (N, C, s2/2, s2)
    fp32 onto a win x win grid per image, with coef (N, 6) = [ay, by, cy, ax,
    bx, cx], and return the output split by parity: (Y00, Y01, Y10, Y11),
    each (N, C, win/2, win/2) and contiguous, Y_ab[uy, ux] = out[2uy + a,
    2ux + b]. Differentiable once in (v0, v1)."""
    if v0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"affine_gather_2phase runs on cpu or cuda tensors, got {v0.device}")
    want = (v0.shape[0], v0.shape[1], s2 // 2, s2)
    if v0.ndim != 4 or tuple(v0.shape) != want or tuple(v1.shape) != want or s2 % 2 or win % 2:
        raise ValueError(f"affine_gather_2phase takes two (N, C, s2/2, s2) planes, even s2 and "
                         f"win; got {tuple(v0.shape)}, {tuple(v1.shape)}, s2={s2}, win={win}")
    return _AffineGather2.apply(v0, v1, coef.float().contiguous(), int(win))
