"""The two vector plans of kernel A (csrc/upfirdn2d.cu), through their plain
mirrors in ops/upfirdn2d.py, against brute force:

  - fir_vec_kernel (the bfloat16 instance fir4x4) on the 4x4 blurs of a
    --bf16 step and their backwards, rows of odd width (257, 259) and of
    128-129 columns (two tasks a warp), planes of 8 and 16 rows, pads of
    both parities, and tensors that start off a 16-byte boundary: every
    output is computed by one lane and written exactly once, whole chunks
    aligned and each element taking the value of the lane that computed it;
    every chunk a lane loads lies inside the tensor's chunks, and after the
    shift each lane's window holds exactly the input slice (zero outside the
    plane);
  - fir_cl_kernel and fir_cl_fixed_kernel (the generic instance on
    channels-last input) at C = 64, 128 and 256 in fp32 and bf16, at up 2,
    down 2 and the 4x4 blur: every load is one aligned channel vector of a
    pixel inside the image (the fixed body's each once a thread), every
    output is stored once, and each output sums exactly the taps that land
    on real pixels;

then that the mirrors' constants, the bf16 dispatch, the channels-last test
and the choice of the fixed body match the CUDA source.
"""
import importlib
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# the module (ops/__init__.py binds the name upfirdn2d to the function)
fir = importlib.import_module("diagan_tpu_torch.ops.upfirdn2d")

CSRC = Path(__file__).resolve().parents[1] / "diagan_tpu_torch" / "csrc" / "upfirdn2d.cu"


def _pads(shape, pad):
    """The fir4x4 call and its backward (ops/upfirdn2d.py _backward_args),
    which is a fir4x4 call too: [(input shape, (x0, x1, y0, y1))]."""
    n, c, h, w = shape
    p = pad if len(pad) == 4 else (pad[0], pad[1], pad[0], pad[1])
    oh, ow = fir._out_size(h, 1, p[2], p[3], 4, 1), fir._out_size(w, 1, p[0], p[1], 4, 1)
    b_up, b_down, g_pad = fir._backward_args((h, w), (oh, ow), 4, 4, 1, 1, pad)
    assert fir.fir_instance(4, 4, b_up, b_down, torch.bfloat16,
                            torch.contiguous_format) == "fir4x4"
    return [(shape, p), ((n, c, oh, ow), g_pad)]


# (shape, pad): the G upsample blur, the D conv and skip blurs, at odd
# widths, 128-129 px rows, 8 and 16 row planes, pads of both parities
VEC_CASES = []
for _shape, _pad in [
    ((1, 2, 17, 257), (1, 1)),     # G upsample blur
    ((1, 2, 16, 256), (2, 2)),     # D conv blur (its backward: 257 -> 256)
    ((1, 2, 16, 257), (1, 1)),     # D skip blur
    ((1, 2, 9, 259), (1, 1)),      # 8 output rows
    ((2, 1, 8, 259), (2, 1, 1, 2)),
    ((1, 3, 16, 129), (1, 1)),     # 128 px rows: two tasks a warp
    ((2, 2, 8, 128), (2, 2)),      # 129 px rows, 8 px planes
    ((1, 2, 17, 255), (2, 1, 0, 3)),
    ((3, 1, 16, 64), (1, 1)),      # 63 px rows
]:
    VEC_CASES += _pads(_shape, _pad)
OFFSETS = [(0, 0), (3, 5), (7, 1)]


@pytest.mark.parametrize("offs", OFFSETS, ids=[f"off{a}-{b}" for a, b in OFFSETS])
@pytest.mark.parametrize("shape,pad", VEC_CASES,
                         ids=[f"fir4x4-{'x'.join(map(str, s))}-{p}" for s, p in VEC_CASES])
def test_vec_plan_against_brute_force(shape, pad, offs):
    x_off, y_off = offs
    n, c, h, w = shape
    oh = fir._out_size(h, 1, pad[2], pad[3], 4, 1)
    ow = fir._out_size(w, 1, pad[0], pad[1], 4, 1)
    v = fir.V
    plan = fir._vec_plan(shape, pad, x_off, y_off)
    n_out = n * c * oh * ow

    # every output computed by exactly one lane
    outs = plan["outputs"][plan["outputs"] >= 0]
    assert np.array_equal(np.bincount(outs - y_off, minlength=n_out), np.ones(n_out, int))
    # ... and written exactly once, inside the output
    written = np.concatenate([plan["vector"].ravel(), plan["scalar"]])
    assert written.min() >= y_off and written.max() < y_off + n_out
    assert np.array_equal(np.bincount(written - y_off, minlength=n_out), np.ones(n_out, int))
    # whole chunks aligned, each element the value its own lane computed,
    # gathered from the same warp (the next lane, or its own extra output);
    # scalars the storing lane's own
    vec, src = plan["vector"], plan["vector_from"]
    assert np.all(vec[:, 0] % v == 0) and np.all(np.diff(vec, axis=1) == 1)
    t, e, f = src[..., 0], src[..., 1], src[..., 2]
    assert np.array_equal(plan["outputs"][t, e, f], vec)
    assert np.array_equal(plan["warp"][t], plan["warp"][t[:, :1]].repeat(v, 1))
    t1, e1, f1 = plan["scalar_from"].T
    assert np.array_equal(plan["outputs"][t1, e1, f1], plan["scalar"])
    assert len(plan["scalar"]) < len(written) or ow < 2 * v

    # loads: chunks of the tensor only, at most NV a row
    loads = plan["loads"]
    x_last = (x_off + n * c * h * w - 1) // 8
    assert loads.max() <= x_last and np.all(loads[loads != -1] >= 0)
    # the window after the shift: the input slice, zero outside the plane
    rows, cols = plan["rows"], plan["cols"]
    first = plan["outputs"].reshape(len(rows), -1).max(1)
    live = first >= 0  # lanes with an output; the others load nothing
    assert np.all(loads[~live] == -1) and np.all(plan["window"][~live] == -1)
    plane = (first - y_off) // (oh * ow)  # the plane of each lane, from its outputs
    inside = (((rows >= 0) & (rows < h))[..., None] & ((cols >= 0) & (cols < w))[:, None, :])
    want = np.where(inside, x_off + plane[:, None, None] * h * w + rows[..., None] * w
                    + cols[:, None, :], -1)
    assert np.array_equal(plan["window"][live], want[live])
    # a row of 2^k + 1 outputs takes no warp of its own: its last lane has an
    # extra output
    if ow % v == 1 and ow > 1:
        assert np.count_nonzero(plan["outputs"][..., v] >= 0) > 0
    # when the row fits one warp and its runs divide 32 (widths 2^k, 2^k +
    # 1, 2^k - 1 at k <= 8), every warp but the last has all its lanes busy
    runs = -(-(ow - (ow % v == 1 and ow > 1)) // v)
    if runs <= 32 and 32 % runs == 0:
        busy = np.bincount(plan["warp"][live], minlength=plan["warp"].max() + 1)
        assert np.all(busy[:-1] == 32), busy


CL_CASES = [(c, itemsize, kh, kw, up, down, pad)
            for c in (64, 128, 256) for itemsize in (4, 2)
            for kh, kw, up, down, pad in [(4, 4, 1, 1, (1, 1)), (4, 4, 1, 1, (2, 2)),
                                          (4, 4, 2, 1, (2, 1)), (4, 4, 1, 2, (1, 1)),
                                          (3, 4, 2, 2, (2, 1)), (1, 12, (2, 1), 1, (6, 5, 0, 0))]]


@pytest.mark.parametrize("c,itemsize,kh,kw,up,down,pad", CL_CASES)
def test_cl_plan_against_brute_force(c, itemsize, kh, kw, up, down, pad):
    shape = (2, c, 7, 5)
    n, _, h, w = shape
    vec = fir.CL_BYTES // itemsize
    strides = (h * w * c, 1, w * c, c)  # channels-last, in elements
    plan = fir._cl_plan(shape, kh, kw, up, down, pad, itemsize)
    (up_x, up_y), (down_x, down_y), (px0, px1, py0, py1) = fir._parse(up, down, pad)
    oh = fir._out_size(h, up_y, py0, py1, kh, down_y)
    ow = fir._out_size(w, up_x, px0, px1, kw, down_x)
    assert plan["fixed"] == ((kh, kw, up, down) == (4, 4, 1, 1))

    # every load one aligned channel vector of a pixel inside the image
    lt, ln, liy, lix, lcv = plan["loads"].T
    assert np.all((liy >= 0) & (liy < h) & (lix >= 0) & (lix < w) & (lcv < c // vec))
    off = ln * strides[0] + liy * strides[2] + lix * strides[3] + lcv * vec
    assert np.all(off % vec == 0)
    thread, outputs = plan["thread"], plan["outputs"]
    assert np.array_equal(thread[lt][:, [0, 3]], np.stack([ln, lcv], -1))
    per_thread = np.bincount(lt, minlength=len(thread))
    if plan["fixed"]:  # each pixel once a thread: CL_R + 3 rows of 4 columns at most
        assert len(np.unique(plan["loads"][:, [0, 2, 3]], axis=0)) == len(lt)
        assert per_thread.max() <= (fir.CL_R + kh - 1) * kw
    # every output (n, oy, ox, channel vector) stored once
    live = outputs[..., 1] >= 0
    cv = np.broadcast_to(thread[:, None, 3], live.shape)
    keys = np.stack([outputs[..., 0][live], outputs[..., 1][live], outputs[..., 2][live],
                     cv[live]], -1)
    assert len(keys) == n * oh * ow * (c // vec) == len(np.unique(keys, axis=0))
    # each output's taps: exactly those on real pixels inside the image
    taps = plan["taps"]
    for t in range(0, len(thread), max(1, len(thread) // 97)):
        for j in range(fir.CL_R):
            oy, ox = outputs[t, j, 1], outputs[t, j, 2]
            got = {tuple(q) for q in taps[t, j].reshape(-1, 4) if q[0] >= 0}
            if oy < 0:
                assert not got
                continue
            want = set()
            for ky in range(kh):
                for kx in range(kw):
                    sy, sx = oy * down_y - py0 + ky, ox * down_x - px0 + kx
                    if sy % up_y or sx % up_x:
                        continue
                    iy, ix = sy // up_y, sx // up_x
                    if 0 <= iy < h and 0 <= ix < w:
                        want.add((ky, kx, iy, ix))
            assert got == want, (t, j)
            if plan["fixed"]:  # the fixed body's loads of this thread cover them
                have = {(a, b) for a, b in plan["loads"][lt == t][:, 2:4]}
                assert {(q[2], q[3]) for q in want} <= have


def _c_expr_to_python(expr, **names):
    """A C++ boolean expression of p's fields and integers, as Python."""
    expr = re.sub(r"reinterpret_cast<uintptr_t>\((\w+)\)", r"\1", expr)
    expr = expr.replace("&&", " and ").replace("||", " or ")
    return eval(f"({expr})", {}, names)  # noqa: S307 - the repo's own source


def test_constants_and_dispatch_match_the_cuda_source():
    src = CSRC.read_text()
    for name in ("WARPS", "VEC_BYTES", "CL_BYTES", "CL_R"):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == getattr(fir, name), name
    assert re.search(r"constexpr int V = VEC_BYTES / 2;", src) and fir.V == fir.VEC_BYTES // 2
    # the bf16 dispatch: fir4x4 alone takes launch_vec<KH, KW, R>, R by the
    # output plane's height
    block = re.search(r"if constexpr \(std::is_same<T, __nv_bfloat16>::value\) \{(.*?)\n  \}",
                      src, re.S).group(1)
    assert re.findall(r"instance == (\w+)", block) == ["FIR4X4"]
    assert "p.OH >= 16 ?" in block
    args = [tuple(int(a) for a in m.split(",")) for m in re.findall(r"launch_vec<([^>]*)>", block)]
    assert args == [(4, 4, fir._vec_rows(16)), (4, 4, fir._vec_rows(15))]
    # channels_last_vec: the C++ test against the mirror's on a grid of cases
    body = re.search(r"bool channels_last_vec\(.*?\{\s*constexpr long long VEC = cl_vec<T>\(\);"
                     r"\s*return (.*?);\s*\}", src, re.S).group(1)
    rng = np.random.default_rng(0)
    seen = set()
    for _ in range(400):
        itemsize = int(rng.choice([2, 4]))
        c = int(rng.choice([3, 4, 8, 16, 64, 128]))
        # channels-last strides of a 5 x 7 image and 16-byte aligned pointers,
        # then one of them changed at random
        sx, sy = [35 * c, 1, 7 * c, c], [35 * c, 1, 7 * c, c]
        xp, yp = 4096, 8192
        which = int(rng.integers(0, 10))
        if which < 4:
            sx[which] = int(rng.choice([1, 2, 4, 8, 3 * c, 64 * c]))
        elif which < 8:
            sy[which - 4] = int(rng.choice([1, 2, 4, 8, 3 * c, 64 * c]))
        elif which == 8:
            xp += int(rng.choice([0, 2, 4, 8]))
        else:
            yp += int(rng.choice([0, 2, 4, 8]))
        sx, sy = tuple(sx), tuple(sy)
        p = SimpleNamespace(C=c, sxn=sx[0], sxc=sx[1], sxh=sx[2], sxw=sx[3],
                            syn=sy[0], syc=sy[1], syh=sy[2], syw=sy[3])
        want = fir._cl_vec_fits(c, sx, sy, xp, yp, itemsize)
        got = _c_expr_to_python(body, p=p, x=xp, y=yp, VEC=fir.CL_BYTES // itemsize,
                                CL_BYTES=fir.CL_BYTES)
        assert got == want
        seen.add(want)
    assert seen == {True, False}
    # the fixed 4x4 body's test in launch_cl
    cond = re.search(r"const bool fixed =\s*(p\.kh == 4 .*?);", src, re.S).group(1)
    for kh, kw, up, down in [(4, 4, 1, 1), (4, 4, 2, 1), (4, 4, 1, 2), (3, 4, 1, 1),
                             (4, 4, (2, 1), 1), (4, 4, 1, (1, 2)), (1, 12, 1, 1)]:
        (ux, uy), (dx, dy) = fir._as_pair(up), fir._as_pair(down)
        p = SimpleNamespace(kh=kh, kw=kw, up_x=ux, up_y=uy, down_x=dx, down_y=dy)
        assert _c_expr_to_python(cond, p=p) == fir._cl_fixed(kh, kw, up, down)
