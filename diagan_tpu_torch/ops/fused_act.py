"""Fused bias-add + LeakyReLU (+ sqrt(2) gain), and its backward.

    y  = scale * leaky_relu(x + bias, negative_slope)
    dx = scale * g * (1 if y > 0 else negative_slope)      (mode 31: mask from
    db = sum of dx over every axis but the channel           the saved output)

with `bias` broadcast over the channel axis: dim 1 of an (N, C, H, W) map or
of an (N, C) matrix (mapping network and discriminator head). Same forward
and backward as the JAX package's fused_leaky_relu and its custom VJP (the
reference's fused_bias_act, act=3, and FusedLeakyReLUFunctionBackward).

Five functions touch a kernel, and each launches its kernel for a CUDA
tensor and runs its plain-torch version for a CPU tensor, and does nothing
else:
  - the forward: the Triton forward kernel (`flr_fwd`);
  - `styled_leaky_relu`: the same kernel with G's StyledConv epilogue
    folded in (below);
  - `clamped_leaky_relu`: the same kernel with no bias and its output
    clamped to [-clamp, clamp] (StyleGAN3's activation, ops/filtered_lrelu.py);
  - `fused_leaky_relu_backward`: the Triton backward kernels (`flr_bwd`
    writes dx and one partial channel sum per program, `flr_db` adds the
    partials in a fixed order);
  - the double backward, which runs `flr_bwd` again without the sums.
`fused_leaky_relu` is the differentiable entry point built from them: its
backward is another autograd.Function whose own backward gives the second
derivative that R1 and path regularisation take.

`styled_leaky_relu` is the forward alone, with autograd off:

    y = scale * leaky_relu(((x * demod) + (noise_weight * noise)) + bias)

with demod (N, C) per map and noise (N, 1, H, W) broadcast over the
channels, each product and the sum rounded to x's dtype, as the three
passes it replaces round them: `flr_fwd` with its STYLED flag, built
without FMA contraction, gives their bits.
"""
from __future__ import annotations

import functools
import math

import torch

_SLOPE = 0.2
_SCALE = math.sqrt(2.0)
_BLOCK = 1024
_PROGRAMS = 2048  # backward: aim for this many (channel, split) programs


def _bias_view(x, bias):
    return bias.reshape((1, -1) + (1,) * (x.ndim - 2))


def fused_leaky_relu_plain(x, bias, negative_slope=_SLOPE, scale=_SCALE):
    """Plain-torch forward: fp32 math, one rounding to x's dtype at the end."""
    y = x.float() + _bias_view(x, bias).float()
    return (torch.where(y > 0, y, y * negative_slope) * scale).to(x.dtype)


def styled_leaky_relu_plain(x, bias, demod, noise, noise_weight, negative_slope=_SLOPE,
                            scale=_SCALE):
    """Plain-torch StyledConv epilogue: the composition it replaces, in its
    order (x * demod, + noise_weight * noise, then the bias-act)."""
    x = x * demod[:, :, None, None] + noise_weight * noise
    return fused_leaky_relu_plain(x, bias, negative_slope, scale)


def clamped_leaky_relu_plain(x, clamp, negative_slope=_SLOPE, scale=_SCALE):
    """Plain-torch clamped activation: the bias-act over a zero bias, then
    the clamp."""
    return torch.clamp(fused_leaky_relu_plain(x, x.new_zeros(x.shape[1]), negative_slope, scale),
                       -clamp, clamp)


def fused_leaky_relu_backward_plain(g, y, negative_slope=_SLOPE, scale=_SCALE, extra=None,
                                    sums=True):
    """Plain-torch backward: (dx, db) with dx in g's dtype and db the fp32 sum
    of the rounded dx over all axes but dim 1 (None when sums=False). `extra`
    (C,), when given, is added to g per channel before the mask (the double
    backward's gg_db)."""
    h = g.float()
    if extra is not None:
        h = h + _bias_view(g, extra).float()
    dx = (torch.where(y > 0, h, h * negative_slope) * scale).to(g.dtype)
    dims = (0,) + tuple(range(2, g.ndim))
    return dx, dx.float().sum(dims) if sums else None


@functools.cache
def _kernels():
    """Compile-on-demand Triton kernels. triton is imported here, at the
    first launch, because machines without a card have no triton; the names
    are bound as module globals so the jitted bodies resolve them."""
    global triton, tl
    import triton
    import triton.language as tl

    @triton.jit
    def flr_fwd(x_ptr, b_ptr, y_ptr, d_ptr, n_ptr, w_ptr, numel, inner, channels, slope,
                scale, clamp, STYLED: tl.constexpr, CLAMP: tl.constexpr, BLOCK: tl.constexpr):
        # Replaces diagan_tpu/ops/fused_act.py:_pallas_forward. Bound: bytes
        # (x read once, y written once, 2 flops per element); one program
        # streams BLOCK contiguous elements, the channel of each comes from
        # its flat offset, and the bias gather hits L1 (C floats).
        # STYLED folds G's StyledConv epilogue in: x * demod[n, c], then
        # + w * noise[n, h, w], each rounded to x's dtype as the separate
        # passes round it (the launch turns FMA contraction off); the noise
        # adds a read of 1/C of the map, the demod gather hits L1.
        # CLAMP clamps the output to [-clamp, clamp] (StyleGAN3's conv_clamp).
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < numel
        ch = (offs // inner) % channels
        x = tl.load(x_ptr + offs, mask=mask).to(tl.float32)
        if STYLED:
            d = tl.load(d_ptr + offs // inner, mask=mask).to(tl.float32)
            x = (x * d).to(x_ptr.dtype.element_ty).to(tl.float32)
            nz = tl.load(n_ptr + (offs // (inner * channels)) * inner + offs % inner,
                         mask=mask).to(tl.float32)
            wn = (tl.load(w_ptr).to(tl.float32) * nz).to(x_ptr.dtype.element_ty)
            x = (x + wn.to(tl.float32)).to(x_ptr.dtype.element_ty).to(tl.float32)
        b = tl.load(b_ptr + ch, mask=mask).to(tl.float32)
        v = x + b
        v = tl.where(v > 0, v, v * slope) * scale
        if CLAMP:
            v = tl.minimum(tl.maximum(v, -clamp), clamp)
        tl.store(y_ptr + offs, v.to(y_ptr.dtype.element_ty), mask=mask)

    @triton.jit
    def flr_bwd(g_ptr, y_ptr, e_ptr, dx_ptr, part_ptr, per_ch, inner, channels,
                splits, slope, scale, HAS_EXTRA: tl.constexpr, SUMS: tl.constexpr,
                BLOCK: tl.constexpr):
        # Replaces diagan_tpu/ops/fused_act.py:_pallas_backward and the db sum
        # the JAX package does outside it (:114). Bound: bytes (g and y read
        # once, dx written once). A fused elementwise pass plus a per-channel
        # reduction: the case Triton serves as well as CUDA C++. Program
        # (c, s) walks channel c's N * inner elements, split s of `splits`,
        # in BLOCK-wide contiguous runs (coalesced within each (n, c) plane);
        # it writes dx and, with SUMS, one partial sum of the rounded dx.
        # The partials are added by flr_db in a fixed order, so db is the
        # same on every run (float atomics would not be).
        c = tl.program_id(0)
        s = tl.program_id(1)
        acc = tl.zeros([BLOCK], dtype=tl.float32)
        if HAS_EXTRA:
            e = tl.load(e_ptr + c).to(tl.float32)
        for start in range(s * BLOCK, per_ch, splits * BLOCK):
            r = start + tl.arange(0, BLOCK)
            mask = r < per_ch
            n = r // inner
            offs = (n.to(tl.int64) * channels + c) * inner + (r - n * inner)
            g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            if HAS_EXTRA:
                g = g + e
            y = tl.load(y_ptr + offs, mask=mask, other=0.0)
            dx = (tl.where(y > 0, g, g * slope) * scale).to(dx_ptr.dtype.element_ty)
            tl.store(dx_ptr + offs, dx, mask=mask)
            if SUMS:
                acc += tl.where(mask, dx.to(tl.float32), 0.0)
        if SUMS:
            tl.store(part_ptr + c * splits + s, tl.sum(acc, axis=0))

    @triton.jit
    def flr_db(part_ptr, db_ptr, splits, SPLITS: tl.constexpr):
        c = tl.program_id(0)
        i = tl.arange(0, SPLITS)
        v = tl.load(part_ptr + c * splits + i, mask=i < splits, other=0.0)
        tl.store(db_ptr + c, tl.sum(v, axis=0).to(db_ptr.dtype.element_ty))

    return flr_fwd, flr_bwd, flr_db


def _check(name, t):
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got {t.dtype}")
    if t.ndim not in (2, 4):
        raise ValueError(f"{name} takes (N, C) or (N, C, H, W), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} kernel takes a contiguous tensor")


def _check_vec(name, v, x):
    c = x.shape[1]
    if v.shape != (c,) or v.device != x.device or not v.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({c},) tensor on the input's device")


def _check_epilogue(x, demod, noise, noise_weight):
    if x.ndim != 4:
        raise ValueError(f"styled_leaky_relu takes an (N, C, H, W) map, got {tuple(x.shape)}")
    n, c = x.shape[:2]
    for name, t, shape in (("demod", demod, (n, c)), ("noise", noise, (n, 1) + x.shape[2:]),
                           ("noise_weight", noise_weight, ())):
        if t.shape != shape or t.dtype != x.dtype or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} tensor of the map's dtype "
                             "and device")


def _launch_forward(x, bias, negative_slope, scale, epilogue=None, clamp=None):
    """flr_fwd on x; with epilogue = (demod, noise, noise_weight) its STYLED
    build, counted apart as `styled_leaky_relu`; with `clamp` its CLAMP
    build, counted apart as `clamped_leaky_relu`."""
    from diagan_tpu_torch.ops import _build

    _check("fused_leaky_relu", x)
    _check_vec("bias", bias, x)
    if epilogue is not None:
        _check_epilogue(x, *epilogue)
    y = torch.empty_like(x)
    numel = x.numel()
    if numel == 0:
        return y
    inner = 1 if x.ndim == 2 else x.shape[2] * x.shape[3]
    grid = (-(-numel // _BLOCK),)
    # the epilogue's roundings hold only without FMA contraction; the plain
    # bias-act has no product to contract and keeps its default build
    styled = epilogue is not None
    fold = {"enable_fp_fusion": False} if styled else {}
    with torch.cuda.device(x.device):
        _kernels()[0][grid](x, bias, y, *(epilogue or (x, x, x)), numel, inner, x.shape[1],
                            float(negative_slope), float(scale), float(clamp or 0.0),
                            STYLED=styled, CLAMP=clamp is not None, BLOCK=_BLOCK, num_warps=4,
                            **fold)
    name = ("styled_leaky_relu" if styled else
            "clamped_leaky_relu" if clamp is not None else "fused_leaky_relu")
    _build.LAUNCHES[name] += 1
    if x.dtype == torch.bfloat16:
        _build.count_bf16(name)
    return y


def _launch_backward(g, y, negative_slope, scale, extra, sums):
    from diagan_tpu_torch.ops import _build

    _check("fused_leaky_relu_backward", g)
    if y.shape != g.shape or y.dtype != g.dtype or y.device != g.device or not y.is_contiguous():
        raise ValueError("y must be a contiguous tensor of g's shape, dtype and device")
    if extra is not None:
        _check_vec("extra", extra, g)
    c = g.shape[1]
    inner = 1 if g.ndim == 2 else g.shape[2] * g.shape[3]
    per_ch = g.shape[0] * inner
    dx = torch.empty_like(g)
    db = torch.empty(c, dtype=torch.float32, device=g.device) if sums else None
    if per_ch == 0 or c == 0:
        return dx, db
    block = _BLOCK if per_ch >= _BLOCK else max(32, 1 << (per_ch - 1).bit_length())
    splits = max(1, min(-(-per_ch // block), -(-_PROGRAMS // c)))
    part = torch.empty((c, splits), dtype=torch.float32, device=g.device)
    _, flr_bwd, flr_db = _kernels()
    with torch.cuda.device(g.device):
        flr_bwd[(c, splits)](g, y, extra if extra is not None else g, dx, part, per_ch, inner,
                             c, splits, float(negative_slope), float(scale),
                             HAS_EXTRA=extra is not None, SUMS=sums, BLOCK=block, num_warps=4)
        if sums:
            flr_db[(c,)](part, db, splits, SPLITS=max(2, 1 << (splits - 1).bit_length()),
                         num_warps=1)
    _build.LAUNCHES["fused_leaky_relu_backward"] += 1
    if sums:
        _build.LAUNCHES["fused_leaky_relu_db"] += 1
    if g.dtype == torch.bfloat16:
        _build.count_bf16("fused_leaky_relu_backward")
        if sums:
            _build.count_bf16("fused_leaky_relu_db")
    return dx, db


def _on(t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_leaky_relu runs on cpu or cuda tensors, got {t.device}")
    return t.device.type == "cuda"


def _forward(x, bias, negative_slope, scale):
    """The forward alone (no autograd): the kernel on CUDA, the plain version on CPU."""
    if _on(x):
        return _launch_forward(x, bias, negative_slope, scale)
    return fused_leaky_relu_plain(x, bias, negative_slope, scale)


def styled_leaky_relu(x, bias, demod, noise, noise_weight, negative_slope=_SLOPE,
                      scale=_SCALE):
    """scale * leaky_relu(((x * demod) + (noise_weight * noise)) + bias), x an
    (N, C, H, W) map, demod (N, C), noise (N, 1, H, W), noise_weight a 0-dim
    tensor, all in x's dtype, bias (C,): the StyledConv epilogue in one pass,
    forward only (the kernel on CUDA, the plain version on CPU). It records
    no autograd graph, so it refuses inputs that need one."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, bias, demod, noise, noise_weight)):
        raise RuntimeError("styled_leaky_relu has no backward: call it with autograd off")
    if _on(x):
        return _launch_forward(x.contiguous(), bias, negative_slope, scale,
                               (demod, noise, noise_weight))
    return styled_leaky_relu_plain(x, bias, demod, noise, noise_weight, negative_slope, scale)


def clamped_leaky_relu(x, clamp, negative_slope=_SLOPE, scale=_SCALE):
    """clamp(scale * leaky_relu(x), -clamp, clamp) over dim 1 of an
    (N, C[, H, W]) tensor in one pass, forward only (the kernel on CUDA, the
    plain version on CPU). It records no autograd graph, so it refuses an
    input that needs one."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("clamped_leaky_relu has no backward: call it with autograd off")
    if _on(x):
        x = x.contiguous()
        return _launch_forward(x, x.new_zeros(x.shape[1]), negative_slope, scale,
                               clamp=float(clamp))
    return clamped_leaky_relu_plain(x, clamp, negative_slope, scale)


def fused_leaky_relu_backward(g, y, negative_slope=_SLOPE, scale=_SCALE, extra=None,
                              sums=True):
    """(dx, db) from the upstream gradient g and the saved output y (no
    autograd): the kernels on CUDA, the plain version on CPU. db is fp32, or
    None when sums=False, which skips the reduction."""
    if _on(g):
        return _launch_backward(g.contiguous(), y, negative_slope, scale, extra, sums)
    return fused_leaky_relu_backward_plain(g, y, negative_slope, scale, extra, sums)


class _FusedLeakyReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias, negative_slope, scale):
        y = _forward(x, bias, negative_slope, scale)
        ctx.save_for_backward(y)
        ctx.args = (negative_slope, scale, bias.dtype)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        slope, scale, bias_dtype = ctx.args
        dx, db = _FusedLeakyReLUBackward.apply(g, y, slope, scale)
        return dx, db.to(bias_dtype), None, None


class _FusedLeakyReLUBackward(torch.autograd.Function):
    """(g, y) -> (dx, db), differentiable once more in g: the grad of g is
    the same mask applied to gg_dx + gg_db (broadcast over N, H, W), times
    the scale; the grad of y is zero (the mask is a step in y)."""

    @staticmethod
    def forward(ctx, g, y, negative_slope, scale):
        dx, db = fused_leaky_relu_backward(g, y, negative_slope, scale)
        ctx.save_for_backward(y)
        ctx.args = (negative_slope, scale)
        return dx, db

    @staticmethod
    def backward(ctx, gg_dx, gg_db):
        (y,) = ctx.saved_tensors
        slope, scale = ctx.args
        if gg_dx is None:
            gg_dx = torch.zeros_like(y)
        extra = None if gg_db is None else gg_db.to(torch.float32).contiguous()
        dg, _ = fused_leaky_relu_backward(gg_dx, y, slope, scale, extra=extra, sums=False)
        return dg, None, None, None


def fused_leaky_relu(x, bias, negative_slope=_SLOPE, scale=_SCALE):
    """y = scale * leaky_relu(x + bias) with bias over dim 1 of (N, C[, H, W]);
    differentiable twice (kernels on CUDA, plain versions on CPU)."""
    _on(x)
    return _FusedLeakyReLU.apply(x, bias, negative_slope, scale)
