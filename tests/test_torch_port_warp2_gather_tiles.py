"""The two-phase warp gather's tile pass (csrc/affine_warp.cu: gather2_kernel,
gather_kernel's tile pass under the TwoPhaseGather layout), emulated in
plain torch from the mirrors in ops/warp.py and ops/ada_phase.py:

  - `_phase_box_rows`, the plane and plane row of each box row: the boxes
    staged from the two planes by that map are the interleaved buffer's
    boxes, bit for bit;
  - the tile blend: each output read from its tile's staged box at the
    kernel's offsets (`at`, `right`, `down`) or, for a box over the
    shared-memory budget, from the planes, blended in mix()'s order and
    stored at the kernel's per-thread addresses, equals
    `affine_gather2_plain` bit for bit;

on every WARP_CASES geometry (offsets scaled to S2) at S2 64, 66 and 1304
with wins 32 to 524, and on ADA draws at p = 1 at the three pad buckets of
256 px. Then the constant the layout relies on matches the CUDA source.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_port_train_ops import WARP_CASES  # noqa: E402
from test_torch_port_warp_tiles import BUCKETS, SIZE, WIN, _ada_coef  # noqa: E402

from diagan_tpu_torch.ops import ada_phase, warp  # noqa: E402

SRC = (Path(warp.__file__).parents[1] / "csrc" / "affine_warp.cu").read_text()
CONST = {m[0]: m[1] for m in re.findall(r"constexpr int (\w+) = ([^;]+);", SRC)}
WARPS = int(CONST["THREADS"]) // 32  # a thread's output rows are WARPS apart
GEOMETRIES = [(64, 32), (66, 34), (1304, 524)]  # (S2, win)


def _planes(n, c, s2, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((2, n, c, s2 // 2, s2)).astype(np.float32))


def _case_coef(case, s2, n=2):
    ay, by, cy, ax, bx, cx = WARP_CASES[case]
    f = s2 / 128
    return torch.tensor([[ay, by, cy * f, ax, bx, cx * f]] * n, dtype=torch.float32)


def _stage(v, boxes, fits):
    """The boxes that fit the budget staged from the planes v (2, N, C, S2/2,
    S2) by `_phase_box_rows`, as `stage` copies them: (C, total) flat, box
    after box, each row-major with its own width, and each box's start
    (N, TI, TJ; 0 for a box that does not fit)."""
    plane, row = ada_phase._phase_box_rows(boxes)
    flat, start, at = [], torch.zeros(boxes.shape[:3], dtype=torch.long), 0
    for n, ti, tj in zip(*torch.nonzero(fits, as_tuple=True)):
        y_lo, y_hi, x_lo, x_hi = boxes[n, ti, tj].tolist()
        h = y_hi - y_lo + 1
        box = v[plane[n, ti, tj, :h], n, :, row[n, ti, tj, :h], x_lo:x_hi + 1]  # (h, C, w)
        flat.append(box.permute(1, 0, 2).reshape(v.shape[2], -1))
        start[n, ti, tj] = at
        at += flat[-1].shape[1]
    return torch.cat(flat, 1), start


def _thread_offsets(n, c, win):
    """Where the kernel stores each output: thread (warp, lane) of the tile
    at (i0, j0) holds rows first + WARPS * r of column j0 + lane, first =
    i0 + warp, at dst(n, first, j) + c * cstep + r * rstep (TwoPhaseGather).
    (N, C, win, win) flat offsets in the (4, N, C, win/2, win/2) output."""
    th = warp.GATHER_TILE[0]
    h2 = win // 2
    idx = torch.arange(win)
    i, j = idx[:, None], idx[None, :]
    r = i % th // WARPS
    first = i - WARPS * r
    quarter = (first & 1) * 2 + (j & 1)
    nn = torch.arange(n).reshape(n, 1, 1, 1)
    cc = torch.arange(c).reshape(1, c, 1, 1)
    cstep, rstep = h2 * h2, WARPS // 2 * h2
    dst = ((quarter * n + nn) * c) * cstep + (first >> 1) * h2 + (j >> 1)
    return dst + cc * cstep + r * rstep


def _emulate_gather2(v, coef, win):
    """gather2_kernel in plain torch: (4, N, C, win/2, win/2)."""
    n, c, s2 = v.shape[1], v.shape[2], v.shape[4]
    boxes, fits = warp._gather_tile_boxes(coef, win, s2)
    staged, start = _stage(v, boxes, fits)
    index, (wy0, fy, wx0, fx) = warp._taps(coef, win, s2)
    y0, x0 = index[0] // s2, index[0] % s2
    x1, y1 = index[1] % s2, index[2] // s2
    wy0, fy, wx0, fx = (t[:, 0] for t in (wy0, fy, wx0, fx))
    th, tw = warp.GATHER_TILE
    idx = torch.arange(win)
    tile = (idx[:, None] // th * boxes.shape[2] + idx[None, :] // tw).reshape(1, -1)
    nb = torch.arange(n)[:, None]
    box = boxes.reshape(n, -1, 4)[nb, tile]  # (N, win*win, 4)
    w = box[..., 3] - box[..., 2] + 1
    at = start.reshape(n, -1)[nb, tile] + (y0 - box[..., 0]) * w + x0 - box[..., 2]
    right, down = x1 - x0, (y1 - y0) * w
    in_shared = fits.reshape(n, -1)[nb, tile]
    out = torch.empty((4 * n * c * (win // 2) ** 2,), dtype=torch.float32)
    offsets = _thread_offsets(n, c, win).reshape(n, c, -1)

    def read(ch, k, ys, xs):  # a tiled output from its box, the others from the planes
        shared = staged[ch][torch.where(in_shared, at + k, 0)]
        direct = v[ys & 1, nb, ch, ys >> 1, xs]
        return torch.where(in_shared, shared, direct)

    for ch in range(c):
        p00, p01 = read(ch, 0, y0, x0), read(ch, right, y0, x1)
        p10, p11 = read(ch, down, y1, x0), read(ch, down + right, y1, x1)
        a = p00 * wx0 + p01 * fx
        b = p10 * wx0 + p11 * fx
        out[offsets[:, ch]] = a * wy0 + b * fy
    return out.reshape(4, n, c, win // 2, win // 2), fits


def _check_staging(v, coef, win):
    s2 = v.shape[-1]
    x2 = torch.stack([v[0], v[1]], 3).reshape(v.shape[1], v.shape[2], s2, s2)
    boxes, fits = warp._gather_tile_boxes(coef, win, s2)
    staged, start = _stage(v, boxes, fits)
    for n, ti, tj in zip(*torch.nonzero(fits, as_tuple=True)):
        y_lo, y_hi, x_lo, x_hi = boxes[n, ti, tj].tolist()
        want = x2[n, :, y_lo:y_hi + 1, x_lo:x_hi + 1].reshape(v.shape[2], -1)
        got = staged[:, start[n, ti, tj]:start[n, ti, tj] + want.shape[1]]
        assert torch.equal(got, want), f"box ({n}, {ti}, {tj}) staged from the wrong rows"


def _check_blend(v, coef, win):
    got, fits = _emulate_gather2(v, coef, win)
    want = torch.stack(ada_phase.affine_gather2_plain(v[0], v[1], coef, win))
    assert torch.equal(got, want)
    return fits


@pytest.mark.parametrize("s2,win", GEOMETRIES)
def test_thread_offsets_are_the_quarter_grids(s2, win):
    off = _thread_offsets(2, 3, win)
    assert torch.equal(off, ada_phase._quarter_offsets(2, 3, win))


def test_phase_box_rows_pad_short_boxes():
    boxes = torch.tensor([[[[3, 6, 0, 3], [4, 4, 8, 11]]]])
    plane, row = ada_phase._phase_box_rows(boxes)
    assert plane.tolist() == [[[[1, 0, 1, 0], [0, -1, -1, -1]]]]
    assert row.tolist() == [[[[1, 2, 2, 3], [2, -1, -1, -1]]]]


@pytest.mark.parametrize("s2,win", GEOMETRIES)
@pytest.mark.parametrize("case", sorted(WARP_CASES))
def test_tile_pass_on_warp_cases(case, s2, win):
    v, coef = _planes(2, 3, s2, seed=s2), _case_coef(case, s2)
    _check_staging(v, coef, win)
    fits = _check_blend(v, coef, win)
    if case == "zoom_out" and s2 == 1304:  # both paths of the kernel run
        assert bool(fits.any()) and not bool(fits.all())


@pytest.mark.parametrize("P", BUCKETS)
def test_tile_pass_on_ada_draws_at_each_bucket(P):
    s2 = 2 * (SIZE + 2 * P)
    v, coef = _planes(2, 3, s2, seed=P), _ada_coef(1.0, P, seed=P, n=2)
    _check_staging(v, coef, WIN)
    fits = _check_blend(v, coef, WIN)
    assert bool(fits.all())


def test_gather_rows_keep_their_parity():
    """TwoPhaseGather's rstep stays in one quarter grid only if a thread's
    rows, WARPS apart, share one parity."""
    assert WARPS % 2 == 0 and warp.GATHER_TILE[0] % WARPS == 0
    assert "static_assert(WARPS % 2 == 0" in SRC
    assert CONST["GATHER_TH"] == "WARPS * GATHER_ROWS"
