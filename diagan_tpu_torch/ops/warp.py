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

The kernels are tiled. `_gather_tile_boxes` and `_scatter_tile_candidates`
repeat their tile geometry in plain torch, formula for formula, so that the
CPU tests can hold it against brute force: the source box of each output
tile of the gather, and the candidate outputs of each dx2 tile of the
adjoint, with the images whose clamped outputs a second pass adds.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

# csrc/affine_warp.cu's tile geometry: gather tiles of GATHER_TILE (rows,
# columns) outputs, each staging a source box of at most GATHER_BUF floats
# per channel; adjoint tiles of SCATTER_TILE (rows, columns) dx2 pixels.
GATHER_TILE = (32, 32)
GATHER_BUF = 4608
SCATTER_TILE = (32, 32)

def _coords(coef, ii, jj):
    """The unclamped source points (qy, qx) of outputs (ii, jj), each (N, k)
    fp32, in the kernel's order of operations (no fused multiply-add)."""
    ay, by, cy, ax, bx, cx = (coef[:, k:k + 1] for k in range(6))
    return ay * ii + by * jj + cy, ax * ii + bx * jj + cx


def _floor_taps(q, s2):
    """Rows (or columns) of the two neighbours of clamped q: floor, and the
    next one clamped to s2 - 1."""
    fl = torch.floor(q.clamp(0.0, s2 - 1.0)).long()
    return fl, (fl + 1).clamp(max=s2 - 1)


def _taps(coef, win, s2):
    """Flat indices of the four neighbours (N, win*win) and the weights
    (1 - fy, fy, 1 - fx, fx), each (N, 1, win*win), in the kernel's order of
    operations (no fused multiply-add anywhere)."""
    idx = torch.arange(win, dtype=torch.float32, device=coef.device)
    ii = idx[:, None].expand(win, win).reshape(1, -1)
    jj = idx[None, :].expand(win, win).reshape(1, -1)
    qy, qx = (q.clamp(0.0, s2 - 1.0) for q in _coords(coef, ii, jj))
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


def _tile_starts(extent, tile, dtype=torch.long):
    """First and last index of each tile of `tile` along an axis of `extent`."""
    lo = torch.arange(0, extent, tile, dtype=dtype)
    return lo, (lo + tile).clamp(max=extent) - 1


def _gather_tile_boxes(coef, win, s2, tile=GATHER_TILE):
    """The gather kernel's source box of each output tile, as gather_box
    computes it: the rows and columns spanned by the taps of the tile's four
    corners, columns widened to multiples of 4 when s2 is one (16-byte
    copies). Returns boxes (N, TI, TJ, 4) [y_lo, y_hi, x_lo, x_hi] inclusive,
    and whether each box fits the shared-memory budget of GATHER_BUF floats
    (tiles that do not blend from global memory)."""
    coef = coef.float().cpu()
    (i0, i1), (j0, j1) = _tile_starts(win, tile[0]), _tile_starts(win, tile[1])
    ti, tj = len(i0), len(j0)
    ys, xs = [], []
    for ia, ja in ((i0, j0), (i0, j1), (i1, j0), (i1, j1)):
        ii = ia[:, None].expand(ti, tj).reshape(1, -1).float()
        jj = ja[None, :].expand(ti, tj).reshape(1, -1).float()
        qy, qx = _coords(coef, ii, jj)
        ys += _floor_taps(qy, s2)
        xs += _floor_taps(qx, s2)
    y_lo, y_hi = torch.stack(ys[0::2]).amin(0), torch.stack(ys[1::2]).amax(0)
    x_lo, x_hi = torch.stack(xs[0::2]).amin(0), torch.stack(xs[1::2]).amax(0)
    if s2 % 4 == 0:
        x_lo, x_hi = x_lo // 4 * 4, (x_hi + 4) // 4 * 4 - 1
    boxes = torch.stack([y_lo, y_hi, x_lo, x_hi], -1).reshape(-1, ti, tj, 4)
    fits = (y_hi - y_lo + 1) * (x_hi - x_lo + 1) <= GATHER_BUF
    return boxes, fits.reshape(-1, ti, tj)


def _scatter_tile_candidates(coef, win, s2, tile=SCATTER_TILE):
    """The adjoint's candidate outputs of each dx2 tile, as tile_geom
    computes them (float64, no contraction): the outputs whose unclamped q
    can put a tap in the tile have q in the tile grown by one pixel, so
    their indices lie in the bounding box of that rectangle's preimage under
    the map (through the inverse m of its 2x2 part), widened by a margin for
    q's fp32 rounding and clipped to the grid (the whole grid when the map
    is singular).

    Returns cand (N, TI, TJ, 4) [i_lo, i_hi, j_lo, j_hi] inclusive (empty
    where lo > hi: the tile is written as zeros); cells (N, TI, TJ), whether
    the tile takes the cell path (every cell's outputs lie in a window of at
    most 3 x 3 output rows and columns; the others take the shared-atomic
    fallback); and clamp (N,), the images whose output-grid corners leave
    [0, s2 - 1], which the clamped-output pass adds."""
    c = coef.double().cpu()
    ay, by, cy, ax, bx, cx = (c[:, k, None, None] for k in range(6))
    (r0, r1), (c0, c1) = (_tile_starts(s2, t, torch.float64) for t in tile)
    rows, cols = (r0 - 1, r1 + 1), (c0 - 1, c1 + 1)
    det = ay * bx - by * ax
    m00, m01, m10, m11 = bx / det, -by / det, -ax / det, ay / det
    big = (torch.maximum(ay.abs(), ax.abs()) * win + torch.maximum(by.abs(), bx.abs()) * win) \
        + (torch.maximum(cy.abs(), cx.abs()) + 1.0)
    wi, wj = m00.abs() + m01.abs(), m10.abs() + m11.abs()
    slack = big * 2.0**-20
    margin = 1.0 + torch.ceil(slack * torch.maximum(wi, wj))
    # the cell window: q's slack and the fp32 cell arithmetic's, per side
    span_i = wi + 2.0 * ((slack * wi + 2.0**-30) + 2.0**-10)
    span_j = wj + 2.0 * ((slack * wj + 2.0**-30) + 2.0**-10)
    corners_i, corners_j = [], []
    for qy in rows:
        for qx in cols:
            dy, dx = qy[None, :, None] - cy, qx[None, None, :] - cx
            corners_i.append(m00 * dy + m01 * dx)
            corners_j.append(m10 * dy + m11 * dx)
    ci, cj = torch.stack(corners_i), torch.stack(corners_j)
    finite = torch.isfinite(ci).all(0) & torch.isfinite(cj).all(0) & torch.isfinite(margin)
    top = win - 1.0
    i_lo = torch.clamp(torch.floor(ci.amin(0)) - margin, min=0.0)
    i_hi = torch.clamp(torch.ceil(ci.amax(0)) + margin, max=top)
    j_lo = torch.clamp(torch.floor(cj.amin(0)) - margin, min=0.0)
    j_hi = torch.clamp(torch.ceil(cj.amax(0)) + margin, max=top)
    full = [torch.zeros_like(i_lo), torch.full_like(i_lo, top)]
    cand = torch.stack([torch.where(finite, v, f) for v, f in
                        zip((i_lo, i_hi, j_lo, j_hi), full * 2)], -1).long()
    nonempty = (cand[..., 0] <= cand[..., 1]) & (cand[..., 2] <= cand[..., 3])
    cells = nonempty & finite & (span_i < 3.0) & (span_j < 3.0)
    e = float(win - 1)
    corners = torch.tensor([[0.0, 0.0, e, e], [0.0, e, 0.0, e]])
    qy, qx = _coords(coef.float().cpu(), corners[:1], corners[1:])
    clamp = ((qy < 0) | (qy > s2 - 1) | (qx < 0) | (qx > s2 - 1)).any(1)
    return cand, cells, clamp


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
