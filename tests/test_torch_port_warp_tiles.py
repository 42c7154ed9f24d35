"""The tile geometry of the interleaved warp pair (csrc/affine_warp.cu),
through its plain-torch mirrors in ops/warp.py, against brute force from the
per-output taps (`_taps`, the kernels' own fp32 arithmetic):

  - every tap of every output lies in its gather tile's source box;
  - every unclamped output whose taps touch a dx2 tile lies in that tile's
    candidate box;
  - every clamped output belongs to an image flagged for the clamped-output
    pass;

on every WARP_CASES geometry (s2 = 128, win = 44; with small tiles too, so
that each case has a few dozen) and on ADA draws at p = 1 at the three pad
buckets of 256 px (S2 792, 1048, 1304, win 524, the kernels' own tiles).
Then: seeded ADA draws at p = 0.3 fit the shared-memory budgets on every
tile, the bucket-scaled geometries drive both paths of each kernel, and the
constants match the CUDA source.
"""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from test_torch_port_train_ops import WARP_CASES  # noqa: E402

from diagan_tpu_torch.models import ada  # noqa: E402
from diagan_tpu_torch.ops import warp  # noqa: E402

SIZE, WIN = 256, 2 * 256 + 2 * ada.PAD_K
BUCKETS = [min(SIZE - 1, int(f * SIZE) + ada.PAD_K) for f in (0.25, 0.5, 0.75)]
REAL = {"gather": warp.GATHER_TILE, "scatter": warp.SCATTER_TILE}
SMALL = {"gather": (8, 8), "scatter": (8, 8)}


def _ada_coef(p, P, seed, n=16):
    G = ada.sample_affine_matrices(n, p, SIZE, SIZE, torch.Generator().manual_seed(seed))
    return ada._warp_coef(torch.linalg.inv(G), SIZE, P).contiguous()


def _case_coef(case, n=2, scale=1.0):
    ay, by, cy, ax, bx, cx = WARP_CASES[case]
    return torch.tensor([[ay, by, cy * scale, ax, bx, cx * scale]] * n, dtype=torch.float32)


def _outputs(coef, win, s2):
    """Every output's output row and column (win*win,), its neighbours'
    rows y0, y1 and columns x0, x1 (N, win*win) as `_taps` gives them, and
    whether its source point was clamped (N, win*win)."""
    index, _ = warp._taps(coef, win, s2)
    y0, x0 = index[0] // s2, index[0] % s2
    y1, x1 = index[3] // s2, index[3] % s2
    idx = torch.arange(win)
    i, j = idx.repeat_interleave(win), idx.repeat(win)
    qy, qx = warp._coords(coef, i[None].float(), j[None].float())
    clamped = (qy < 0) | (qy > s2 - 1) | (qx < 0) | (qx > s2 - 1)
    return i, j, (y0, y1, x0, x1), clamped


def _check_tiles(coef, win, s2, tiles):
    i, j, (y0, y1, x0, x1), clamped = _outputs(coef, win, s2)
    boxes, _ = warp._gather_tile_boxes(coef, win, s2, tiles["gather"])
    th, tw = tiles["gather"]
    b = boxes[:, i // th, j // tw]
    assert bool(((y0 >= b[..., 0]) & (y1 <= b[..., 1]) & (x0 >= b[..., 2]) &
                 (x1 <= b[..., 3])).all()), "a tap outside its gather tile's source box"

    cand, _, clamp = warp._scatter_tile_candidates(coef, win, s2, tiles["scatter"])
    th, tw = tiles["scatter"]
    n = torch.arange(coef.shape[0])[:, None]
    for ys in (y0, y1):
        for xs in (x0, x1):
            c = cand[n, ys // th, xs // tw]
            found = (i >= c[..., 0]) & (i <= c[..., 1]) & (j >= c[..., 2]) & (j <= c[..., 3])
            assert bool((found | clamped).all()), "an output missing from a candidate box"
    assert not bool(clamped[~clamp].any()), "a clamped output in an image not flagged"
    return clamped.any(1), clamp


@pytest.mark.parametrize("size", ["real", "small"])
@pytest.mark.parametrize("case", sorted(WARP_CASES))
def test_tiles_cover_warp_cases(case, size):
    coef = _case_coef(case)
    clamped, clamp = _check_tiles(coef, 44, 128, REAL if size == "real" else SMALL)
    # the flag is exactly "some output is clamped", the corners being extreme
    assert torch.equal(clamped, clamp)


@pytest.mark.parametrize("P", BUCKETS)
def test_tiles_cover_ada_draws_at_each_bucket(P):
    s2 = 2 * (SIZE + 2 * P)
    coef = _ada_coef(1.0, P, seed=P, n=4)
    clamped, clamp = _check_tiles(coef, WIN, s2, REAL)
    assert torch.equal(clamped, clamp)


def test_ada_draws_at_p03_fit_the_budgets():
    """At ADA's running strength the gather stages every tile's source box
    in shared memory and every adjoint tile that some output reaches takes
    the cell path."""
    for P in BUCKETS:
        s2 = 2 * (SIZE + 2 * P)
        for seed in range(3):
            coef = _ada_coef(0.3, P, seed)
            _, fits = warp._gather_tile_boxes(coef, WIN, s2)
            cand, cells, _ = warp._scatter_tile_candidates(coef, WIN, s2)
            nonempty = (cand[..., 0] <= cand[..., 1]) & (cand[..., 2] <= cand[..., 3])
            assert bool(fits.all()), f"P={P} seed={seed}: a gather tile over budget"
            assert torch.equal(cells, nonempty), f"P={P} seed={seed}: an adjoint tile falls back"
            assert 0 < int(nonempty.sum()) < nonempty.numel()


def test_bucket_geometries_drive_both_paths():
    """The geometries as the card's checks scale them (offsets with S2, at
    the largest bucket): zoom_out overflows the gather's shared-memory
    budget, zoom_in sends the adjoint's tiles to the fallback, and clipped
    needs the clamped-output pass; the others stay on the tile paths."""
    s2 = 2 * (SIZE + 2 * BUCKETS[-1])
    paths = {}
    for case in WARP_CASES:
        coef = _case_coef(case, n=1, scale=s2 / 128)
        _, fits = warp._gather_tile_boxes(coef, WIN, s2)
        cand, cells, clamp = warp._scatter_tile_candidates(coef, WIN, s2)
        nonempty = (cand[..., 0] <= cand[..., 1]) & (cand[..., 2] <= cand[..., 3])
        paths[case] = (bool(fits.all()), bool(cells[nonempty].all()), bool(clamp.any()))
    assert not paths["zoom_out"][0] and paths["zoom_out"][1]
    assert paths["zoom_in"][0] and not paths["zoom_in"][1]
    assert paths["clipped"][2]
    assert all(p[0] and p[1] for case, p in paths.items() if case not in ("zoom_out", "zoom_in"))


def test_singular_map_takes_the_whole_grid():
    coef = torch.tensor([[0.0, 0.0, 5.0, 0.0, 0.0, 7.0]])
    cand, cells, clamp = warp._scatter_tile_candidates(coef, 20, 64)
    assert bool((cand == torch.tensor([0, 19, 0, 19])).all())
    assert not bool(cells.any()) and not bool(clamp.any())


def test_tile_constants_match_the_cuda_source():
    src = (Path(warp.__file__).parents[1] / "csrc" / "affine_warp.cu").read_text()
    const = {m[0]: m[1] for m in re.findall(r"constexpr int (\w+) = ([^;]+);", src)}
    rows = int(const["GATHER_ROWS"]) * int(const["THREADS"]) // 32
    assert warp.GATHER_TILE == (rows, int(const["GATHER_TW"]))
    assert const["GATHER_TH"] == "WARPS * GATHER_ROWS"
    assert warp.GATHER_BUF == int(const["GATHER_BUF"])
    assert warp.SCATTER_TILE == (int(const["SCATTER_TH"]), int(const["SCATTER_TW"]))
