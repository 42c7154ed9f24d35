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
up or down 1 or 2, ADA's 12-tap passes, the polyphase 6-tap and 6x6 passes,
StyleGAN3-T's 24-tap up-4 passes in float32) and a generic one for anything
else. `fir_instance` chooses it from the arguments alone, so the choice is
testable without a card; each launch also counts under its instance's name
in `_build.FIR_INSTANCES`. Inside a profiler session a launch with 24 taps
and up 4 along one axis counts `fir_up4_calls`, and `fir_up4_family` when it
ran on the up-4 instances (utils/trace.py).

Two plans of the kernel read their inputs as aligned 16-byte vectors: the
bfloat16 instance fir4x4 (fir_vec_kernel), and the generic instance on
channels-last tensors whose channel vectors are 16-byte aligned
(fir_cl_kernel, and fir_cl_fixed_kernel for 4x4 taps at up = down = 1).
`_vec_plan` and `_cl_plan` repeat their index arithmetic in numpy, formula
for formula, so that the CPU tests can hold it against brute force: which
vectors each thread loads and where it shifts them, which outputs it stores
whole and which one by one. Nothing on the main path calls them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from diagan_tpu_torch.ops import _build
from diagan_tpu_torch.utils import trace


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
                 "fir12y_up2", "fir12y_down2", "fir12x_up2", "fir12x_down2", "fir24x_up4",
                 "fir24y_up4")
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
    (1, 24, (4, 1), (1, 1)): "fir24x_up4",
    (24, 1, (1, 4), (1, 1)): "fir24y_up4",
}
# StyleGAN3-T's 24-tap up-4 passes: instances for float32 alone
_UP4 = ("fir24x_up4", "fir24y_up4")
_build.FIR_INSTANCES.update(dict.fromkeys(FIR_INSTANCES, 0))


def fir_instance(kh, kw, up, down, dtype, layout) -> str:
    """The kernel instance for taps (kh, kw), `up` and `down` (int or (x, y)),
    a float32 or bfloat16 `dtype`, and the input's memory `layout`
    (torch.contiguous_format or torch.channels_last): a family's own
    instance for contiguous NCHW ("generic" for bfloat16 at up 4), "generic"
    otherwise. Pads do not matter: every instance takes any pad."""
    (up_x, up_y), (down_x, down_y) = _as_pair(up), _as_pair(down)
    if layout != torch.contiguous_format or dtype not in _DTYPE_CODE:
        return "generic"
    name = _FAMILIES.get((kh, kw, (up_x, up_y), (down_x, down_y)), "generic")
    return "generic" if name in _UP4 and dtype != torch.float32 else name


# csrc/upfirdn2d.cu's vector plans. fir_vec_kernel: WARPS warps a block,
# loads of VEC_BYTES-byte aligned chunks, V output columns and R output rows
# a lane (`_vec_rows`). fir_cl_kernel: CL_BYTES a lane's channel vector,
# CL_R output rows a thread.
WARPS = 8
VEC_BYTES = 16
V = VEC_BYTES // 2
CL_BYTES = 16
CL_R = 8


def _vec_rows(oh):
    """R of fir_vec_kernel on an output plane of oh rows: 8 under 16 rows."""
    return 16 if oh >= 16 else 8


def _vec_plan(shape, pad, x_off=0, y_off=0):
    """fir_vec_kernel's plan for a bfloat16 fir4x4 call on contiguous NCHW
    `shape` with pads (x0, x1, y0, y1), x and y starting x_off and y_off
    elements past a VEC_BYTES boundary. Element indices count from those
    boundaries, and chunk k holds elements 8k .. 8k + 7, as in the kernel.
    Threads are all the lanes of the warps that do not return at once.
    Returns a dict of numpy arrays:
      "rows" (T, NY), "cols" (T, NX): each lane's input rows and columns;
      "loads" (T, NY, NV): the chunk it loads for each row, -1 for none (a
        lane without outputs, a row outside the plane, or a chunk its
        segment does not reach);
      "window" (T, NY, NX): the element its value at (row, column) comes
        from after the shift, -1 where it is zero (masked);
      "outputs" (T, R, V + 1): the element of each output it stores, -1
        where it has none (column V: the extra output of a row's last lane);
      "warp" (T,): its warp;
      "vector" (S, V) and "vector_from" (S, V, 3): the elements written by
        whole-chunk stores, each with the (thread, output row, output column)
        whose value it takes; "scalar" (Q,) and "scalar_from" (Q, 3) those
        written one by one."""
    kh, kw = 4, 4
    n, c, h, w = shape
    px0, px1, py0, py1 = pad
    oh, ow = _out_size(h, 1, py0, py1, kh, 1), _out_size(w, 1, px0, px1, kw, 1)
    v, r = V, _vec_rows(oh)
    # the tiling (launch_vec)
    extra = int(ow % v == 1 and ow > 1)  # the kernel's EXTRA
    runs = (ow - extra + v - 1) // v
    tx = (runs + 31) // 32
    cw = min(runs, 32)
    groups = 32 // cw if tx == 1 else 1
    ty = (oh + r - 1) // r
    tasks = n * c * ty
    edges = not (ow % v == 0 and y_off % v == 0)
    nx = v + extra + kw - 1
    nv = ((nx + 1) // 2 + 4 + 3) // 4
    ny = r + kh - 1
    warps = tx * -(-tasks // groups)
    warp = np.repeat(np.arange(warps), 32)
    lane = np.tile(np.arange(32), warps)
    col = warp % tx
    grp, cl = lane // cw, lane % cw
    run = col * 32 + cl
    task = warp // tx * groups + grp
    live = (grp < groups) & (task < tasks) & (run < runs)
    z, band = np.where(live, task // ty, 0), np.where(live, task % ty, 0)
    is_extra = live & bool(extra) & (run == runs - 1)
    edge = edges & ((cl == 0) | (cl >= cw - 2) | (run >= runs - 2))
    ox0, oy0 = run * v, band * r
    ix0, iy0 = ox0 - px0, oy0 - py0
    # the group's outputs of each row, in the lane's coordinates
    out_a = col * 32 * v - ox0
    out_b = np.minimum((col * 32 + cw) * v + np.where(col == tx - 1, extra, 0), ow) - ox0
    out_b = np.where(live, out_b, out_a)

    rows = iy0[:, None] + np.arange(ny)
    cols = ix0[:, None] + np.arange(nx)
    row_in = live[:, None] & (rows >= 0) & (rows < h)
    col_in = (cols >= 0) & (cols < w)
    g = x_off + z[:, None] * h * w + rows * w + ix0[:, None]  # (row, column ix0)
    s = g % 8
    k = np.arange(nv)
    x_last = (x_off + n * c * h * w - 1) // 8
    need = 8 * k <= s[..., None] + nx - 1
    # a lane whose rows inside the plane all lie inside the tensor's chunks
    # reads them unclamped
    gx = x_off + z * h * w + iy0 * w + ix0
    r_lo, r_hi = np.maximum(-iy0, 0), np.minimum(ny - 1, h - 1 - iy0)
    safe = ((gx + r_lo * w) // 8 >= 0) & ((gx + r_hi * w) // 8 + nv - 1 <= x_last)
    chunk = g[..., None] // 8 + k
    chunk = np.where(safe[:, None, None], chunk, np.clip(chunk, 0, x_last))
    loads = np.where(row_in[..., None] & need, chunk, -1)
    pos = s[..., None] + np.arange(nx)  # the value's place in the loaded chunks
    src = np.take_along_axis(loads, pos // 8, axis=-1) * 8 + pos % 8
    window = np.where(row_in[..., None] & col_in[:, None, :], src, -1)

    oy = oy0[:, None] + np.arange(r)
    oy_in = live[:, None] & (oy >= 0) & (oy < oh)
    f = np.arange(v + 1)
    e_l = y_off + (z[:, None] * oh + oy) * ow + ox0[:, None]  # the lane's output 0
    ok = (f < v) | is_extra[:, None]
    outputs = np.where(oy_in[..., None] & ((f >= out_a[:, None]) & (f < out_b[:, None])
                                           & ok)[:, None, :], e_l[..., None] + f, -1)
    # store_row, in the lane's coordinates
    a = np.broadcast_to(out_a[:, None], oy.shape)
    b = np.where(oy_in, out_b[:, None], a)
    so = e_l % v
    c0 = np.where(so == 0, 0, v - so)
    t_idx, e_idx = np.nonzero((c0 >= a) & (c0 + v <= b))
    q = np.arange(v)
    at = c0[t_idx, e_idx][:, None] + q  # the value's place in [own, next]
    nxt = at >= v
    ext = is_extra[t_idx][:, None] & nxt  # "next" is the lane's own extra output
    from_t = np.where(nxt & ~ext, t_idx[:, None] + 1, t_idx[:, None])
    from_f = np.where(ext, v, at % v)
    vector = e_l[t_idx, e_idx][:, None] + at
    vector_from = np.stack([from_t, np.broadcast_to(e_idx[:, None], at.shape), from_f], -1)
    lo_al = a + ((-(so + a)) & (v - 1))
    hi_al = np.maximum(b - ((so + b) & (v - 1)), lo_al)
    one = (edge[:, None, None] & ok[:, None, :] & (f >= a[..., None]) & (f < b[..., None])
           & ((f < lo_al[..., None]) | (f >= hi_al[..., None])))
    one[..., v] &= bool(extra)
    t1, e1, f1 = np.nonzero(one)
    el = e_l[..., None] + f
    return {"rows": rows, "cols": cols, "loads": loads, "window": window, "outputs": outputs,
            "warp": warp, "vector": vector, "vector_from": vector_from,
            "scalar": el[t1, e1, f1], "scalar_from": np.stack([t1, e1, f1], -1)}


def _cl_vec_fits(c, x_strides, y_strides, x_ptr, y_ptr, itemsize):
    """csrc/upfirdn2d.cu channels_last_vec: the generic instance takes its
    channels-last body when both tensors have unit channel strides, C and
    the other strides are multiples of the CL_BYTES channel vector, and both
    pointers are CL_BYTES-aligned. Strides as torch gives them: (n, c, h, w)."""
    vec = CL_BYTES // itemsize
    (sxn, sxc, sxh, sxw), (syn, syc, syh, syw) = x_strides, y_strides
    return (sxc == 1 and syc == 1 and c % vec == 0
            and all(st % vec == 0 for st in (sxw, sxh, sxn, syw, syh, syn))
            and x_ptr % CL_BYTES == 0 and y_ptr % CL_BYTES == 0)


def _cl_fixed(kh, kw, up, down):
    """Whether the channels-last body takes fir_cl_fixed_kernel (4x4 taps at
    up = down = 1) rather than fir_cl_kernel (taps, up and down at run time)."""
    return (kh, kw, _as_pair(up), _as_pair(down)) == (4, 4, (1, 1), (1, 1))


def _first_tap(s0, up):
    """csrc/upfirdn2d.cu first_tap: the first tap k0 on a real pixel for an
    output whose tap 0 sits at stuffed position s0, and that pixel's index."""
    k0 = (-s0) % up
    return k0, (s0 + k0) // up


def _cl_plan(shape, kh, kw, up, down, pad, itemsize):
    """The channels-last body's plan on a channels-last `shape` (N, C, H, W)
    with C a multiple of the channel vector: one thread per (image, row
    band of CL_R, output column, channel vector), channel vector fastest.
    Returns a dict of numpy arrays:
      "thread" (T, 4): (n, band, ox, cv);
      "outputs" (T, CL_R, 3): (n, oy, ox) of each output row it stores, with
        oy -1 past the plane;
      "taps" (T, CL_R, KY, KX, 4): for each output, the (ky, kx, iy, ix) of
        each tap that lands on a real pixel, -1 where there is none or the
        pixel lies outside the image (read as 0, not loaded);
      "loads" (L, 5): every load as (thread, n, iy, ix, cv), once per load
        (the fixed body loads a pixel once a thread, the run-time body once
        an output that reads it);
      "fixed": whether the fixed 4x4 body runs."""
    (up_x, up_y), (down_x, down_y), (px0, px1, py0, py1) = _parse(up, down, pad)
    n, c, h, w = shape
    oh, ow = _out_size(h, up_y, py0, py1, kh, down_y), _out_size(w, up_x, px0, px1, kw, down_x)
    vec = CL_BYTES // itemsize
    cvs, bands = c // vec, -(-oh // CL_R)
    nn, band, ox, cv = (a.reshape(-1) for a in np.meshgrid(
        np.arange(n), np.arange(bands), np.arange(ow), np.arange(cvs), indexing="ij"))
    oy = band[:, None] * CL_R + np.arange(CL_R)
    outputs = np.stack([np.broadcast_to(nn[:, None], oy.shape), np.where(oy < oh, oy, -1),
                        np.broadcast_to(ox[:, None], oy.shape)], -1)
    kx0, ix0 = _first_tap(ox * down_x - px0, up_x)
    ky0, iy0 = _first_tap(oy * down_y - py0, up_y)
    ky = ky0[..., None] + up_y * np.arange(-(-kh // up_y))  # (T, CL_R, KY)
    kx = kx0[:, None] + up_x * np.arange(-(-kw // up_x))    # (T, KX)
    iy = iy0[..., None] + np.arange(ky.shape[-1])
    ix = ix0[:, None] + np.arange(kx.shape[-1])
    real = ((ky < kh) & (iy >= 0) & (iy < h) & (oy < oh)[..., None])[..., None] & (
        (kx < kw) & (ix >= 0) & (ix < w))[:, None, None, :]
    shp = real.shape
    taps = np.stack([np.broadcast_to(ky[..., None], shp), np.broadcast_to(kx[:, None, None], shp),
                     np.broadcast_to(iy[..., None], shp), np.broadcast_to(ix[:, None, None], shp)],
                    -1)
    taps = np.where(real[..., None], taps, -1)
    fixed = _cl_fixed(kh, kw, up, down)
    if fixed:  # rows iy0 .. iy0 + CL_R + 2, columns ox - px0 .. + 3, each once
        rows = band[:, None] * CL_R - py0 + np.arange(CL_R + kh - 1)
        cols = ox[:, None] - px0 + np.arange(kw)
        ok = ((rows >= 0) & (rows < h))[..., None] & ((cols >= 0) & (cols < w))[:, None, :]
        t, a, b = np.nonzero(ok)
        loads = np.stack([t, nn[t], rows[t, a], cols[t, b], cv[t]], -1)
    else:
        t, j, a, b = np.nonzero(real)
        loads = np.stack([t, nn[t], taps[t, j, a, b, 2], taps[t, j, a, b, 3], cv[t]], -1)
    return {"thread": np.stack([nn, band, ox, cv], -1), "outputs": outputs, "taps": taps,
            "loads": loads, "fixed": fixed}


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
    if (kw, up_x) == (24, 4) or (kh, up_y) == (24, 4):
        trace.count("fir_up4_calls")
        if instance in _UP4:
            trace.count("fir_up4_family")
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
