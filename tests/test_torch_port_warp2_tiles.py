"""The two-phase warp adjoint's layout (csrc/affine_warp.cu: scatter2_kernel,
the interleaved adjoint's tile pass under the TwoPhase layout), through its
plain-torch mirrors in ops/ada_phase.py:

  - `_quarter_offsets`, the cotangent of each output in the four quarter
    grids, against the quarter grids that slicing the output gives;
  - `_plane_offsets`, each buffer pixel in the stacked y-phase planes,
    against the interleave that the plain gather reads;
  - `_phase_tile_rows`, the plane rows of each buffer tile, which cover both
    planes exactly once;
  - the identity the card's bit check rests on: the two-phase adjoint is the
    interleaved adjoint of the interleaved cotangent, de-interleaved, on
    every WARP_CASES geometry (s2 = 128, win = 44).
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_port_train_ops import WARP_CASES  # noqa: E402

from diagan_tpu_torch.ops import ada_phase, warp  # noqa: E402


@pytest.mark.parametrize("n,c,win", [(1, 1, 2), (2, 3, 44), (3, 2, 10)])
def test_quarter_offsets_match_the_quarter_grids(n, c, win):
    y = torch.arange(n * c * win * win).reshape(n, c, win, win)
    quarters = torch.stack([y[:, :, a::2, b::2] for a, b in ada_phase.PARITIES])
    off = ada_phase._quarter_offsets(n, c, win)
    assert off.shape == (n, c, win, win)
    assert torch.equal(quarters.flatten()[off], y)
    assert torch.equal(torch.sort(off.flatten()).values, torch.arange(y.numel()))


@pytest.mark.parametrize("n,c,s2", [(1, 1, 4), (2, 3, 128), (2, 1, 30)])
def test_plane_offsets_match_the_interleave(n, c, s2):
    v = torch.arange(2 * n * c * (s2 // 2) * s2).reshape(2, n, c, s2 // 2, s2)
    x2 = torch.stack([v[0], v[1]], 3).reshape(n, c, s2, s2)
    assert torch.equal(ada_phase._plane_offsets(n, c, s2), x2)


@pytest.mark.parametrize("tile", [warp.SCATTER_TILE, (8, 8)])
@pytest.mark.parametrize("s2", [64, 128, 1302, 1304])
def test_phase_tile_rows_partition_both_planes(s2, tile):
    rows = ada_phase._phase_tile_rows(s2, tile)
    assert rows.shape == ((s2 + tile[0] - 1) // tile[0], 2, 2)
    for phi in (0, 1):
        taken = torch.cat([torch.arange(lo, hi + 1) for lo, hi in rows[:, phi].tolist()])
        assert torch.equal(taken, torch.arange(s2 // 2)), f"plane {phi}"
    # each tile writes the same plane rows of both planes (r0 is even)
    assert torch.equal(rows[:, 0], rows[:, 1])


def test_scatter_tile_rows_are_even():
    src = (Path(warp.__file__).parents[1] / "csrc" / "affine_warp.cu").read_text()
    const = {m[0]: m[1] for m in re.findall(r"constexpr int (\w+) = ([^;]+);", src)}
    assert warp.SCATTER_TILE[0] == int(const["SCATTER_TH"]) and warp.SCATTER_TILE[0] % 2 == 0
    assert "static_assert(SCATTER_TH % 2 == 0" in src


@pytest.mark.parametrize("case", sorted(WARP_CASES))
def test_scatter2_is_the_interleaved_adjoint_deinterleaved(case):
    """affine_scatter2_plain of four quarter grids equals affine_scatter_plain
    of the interleaved cotangent, split into its y-phase planes, bit for
    bit (the same terms summed in the same order)."""
    s2, win, n = 128, 44, 2
    rng = np.random.default_rng(7)
    gq = torch.from_numpy(rng.standard_normal((4, n, 3, win // 2, win // 2)).astype(np.float32))
    coef = torch.tensor([WARP_CASES[case]] * n, dtype=torch.float32)
    g = torch.empty((n, 3, win, win))
    for k, (a, b) in enumerate(ada_phase.PARITIES):
        g[:, :, a::2, b::2] = gq[k]
    dx2 = warp.affine_scatter_plain(g, coef, s2)
    dv0, dv1 = ada_phase.affine_scatter2_plain(gq, coef, s2)
    assert torch.equal(dv0, dx2[:, :, 0::2]) and torch.equal(dv1, dx2[:, :, 1::2])
    # through the mirrors: the same cotangent, and the planes at their offsets
    assert torch.equal(gq.flatten()[ada_phase._quarter_offsets(n, 3, win)], g)
    assert torch.equal(torch.stack([dv0, dv1]).flatten()[ada_phase._plane_offsets(n, 3, s2)],
                       dx2)
