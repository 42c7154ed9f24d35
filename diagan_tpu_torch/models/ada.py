"""ADA, adaptive discriminator augmentation (non-leaking), for StyleGAN2.

Counterpart of diagan_tpu/models/ada.py with the same distributions and the
same resampling:
  - `sample_affine_matrices` / `sample_color_matrices`: the composed 3x3
    geometric and 4x4 colour matrices, every transform gated by its own
    Bernoulli(p) (x-flip, 90-degree rotation from {0, 3}, integer translate
    on the pixel grid, isotropic scale, the pre-rotate / anisotropic scale /
    post-rotate sandwich at p_rot = 1 - sqrt(1 - p), fractional translate;
    brightness, contrast, luma flip, hue rotation, saturation);
  - `apply_affine`: reflect pad, sym6 2x up-filter (two 12-tap passes),
    the affine bilinear warp at 2x, sym6 filter + 2x down (two passes),
    crop. sym6 is orthonormal, so the identity transform gives the input
    back exactly. The polyphase form of the same resample (`polyphase=True`,
    or DIAGAN_TPU_ADA_POLYPHASE=1 on the card) holds the 2x buffer as its
    two y-phase planes and the warp output as its four parity quarter
    grids, so every FIR pass is a compact stride-1 one;
  - `apply_color`: per-channel FMAs, out_i = C_i0 r + C_i1 g + C_i2 b + C_i3.

The matrices are drawn on the host, from an explicit CPU torch.Generator:
the pad bucket (the smallest reflect pad that covers the batch's transforms,
`_needed_pad`) is a host decision, so choosing it costs no device sync, and
the warp coefficients and colour matrices reach the card by a non-blocking
copy from pinned memory. The RNG is not JAX's, so tests hand both packages
the same matrices or compare distributions.

Public functions take and return NHWC images as the JAX package does; the
resampling runs on NCHW planes inside.
"""
from __future__ import annotations

import functools
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from diagan_tpu_torch.ops import affine_gather, affine_gather_2phase, upfirdn2d
from diagan_tpu_torch.ops.ada_phase import PARITIES

# sym6 wavelet scaling filter, the reference's antialiasing kernel.
# Orthonormal: sum(k^2) == 1, sum(k) == sqrt(2).
SYM6 = (
    0.015404109327027373,
    0.0034907120842174702,
    -0.11799011114819057,
    -0.048311742585633,
    0.4910559419267466,
    0.787641141030194,
    0.3379294217276218,
    -0.07263752278646252,
    -0.021060292512300564,
    0.04472490177066578,
    0.0017677118642428036,
    -0.007800708325034148,
)
PAD_K = (len(SYM6) + 1) // 2  # 6


# ---------------------------------------------------------------------------
# Transform draws (host, float32)
# ---------------------------------------------------------------------------
def _mat3(rows):
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _rot2d(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(theta), torch.ones_like(theta)
    return _mat3([[c, -s, z], [s, c, z], [z, z, o]])


def _scale2d(sx, sy):
    z, o = torch.zeros_like(sx), torch.ones_like(sx)
    return _mat3([[sx, z, z], [z, sy, z], [z, z, o]])


def _translate2d(tx, ty):
    z, o = torch.zeros_like(tx), torch.ones_like(tx)
    return _mat3([[o, z, tx], [z, o, ty], [z, z, o]])


class _Draws:
    """Host draws from one CPU generator."""

    def __init__(self, n, generator):
        self.n, self.g = n, generator

    def bernoulli(self, prob):
        return (torch.rand(self.n, generator=self.g) < prob).float()

    def uniform(self, lo, hi):
        return torch.rand(self.n, generator=self.g) * (hi - lo) + lo

    def normal(self):
        return torch.randn(self.n, generator=self.g)

    def lognormal2(self, std_log2):
        """2 ** Normal(0, std_log2) (the reference's lognormal_sample)."""
        return 2.0 ** (std_log2 * self.normal())

    def gated(self, prob, M, G):
        """select*M + (1-select)*I, then compose: the gate has its own draw."""
        sel = self.bernoulli(prob)[:, None, None]
        eye = torch.eye(M.shape[-1])[None]
        return (sel * M + (1.0 - sel) * eye) @ G


def sample_affine_matrices(n, p, height, width, generator=None):
    """(n, 3, 3) float32 geometric matrices in [-1, 1] image coordinates, on
    the host, with the JAX sampler's distribution and quirks (rotation
    categories {0, 3}; one translation scalar for both axes)."""
    d = _Draws(n, generator)
    G = torch.eye(3).repeat(n, 1, 1)
    ones = torch.ones(n)
    G = d.gated(p, _scale2d(1.0 - 2.0 * d.bernoulli(0.5), ones), G)  # x-flip
    G = d.gated(p, _rot2d(-(math.pi / 2) * 3.0 * d.bernoulli(0.5)), G)  # 90 degrees
    t = d.uniform(-0.125, 0.125)  # integer translate, on each axis's pixel grid
    G = d.gated(p, _translate2d(torch.round(t * width) / width,
                                torch.round(t * height) / height), G)
    s = d.lognormal2(0.2)  # isotropic scale
    G = d.gated(p, _scale2d(s, s), G)
    p_rot = 1.0 - math.sqrt(min(max(1.0 - p, 0.0), 1.0))
    G = d.gated(p_rot, _rot2d(-d.uniform(-math.pi, math.pi)), G)  # pre-rotate
    s = d.lognormal2(0.2)  # anisotropic scale
    G = d.gated(p, _scale2d(s, 1.0 / s), G)
    G = d.gated(p_rot, _rot2d(-d.uniform(-math.pi, math.pi)), G)  # post-rotate
    t = 0.125 * d.normal()  # fractional translate
    return d.gated(p, _translate2d(t, t), G)


def sample_color_matrices(n, p, generator=None):
    """(n, 4, 4) float32 colour matrices on the host (brightness, contrast,
    luma flip, hue rotation about the luma axis, saturation)."""
    d = _Draws(n, generator)
    C = torch.eye(4).repeat(n, 1, 1)
    eye4 = torch.eye(4)
    v = torch.tensor([1.0, 1.0, 1.0, 0.0]) / math.sqrt(3)
    vv = torch.outer(v, v)

    M = eye4.repeat(n, 1, 1)
    M[:, :3, 3] = (0.2 * d.normal())[:, None]  # brightness
    C = d.gated(p, M, C)

    c = d.lognormal2(0.5)  # contrast
    M = eye4.repeat(n, 1, 1)
    M[:, 0, 0], M[:, 1, 1], M[:, 2, 2] = c, c, c
    C = d.gated(p, M, C)

    i = d.bernoulli(0.5)  # luma flip
    C = d.gated(p, eye4[None] - 2.0 * vv[None] * i[:, None, None], C)

    theta = d.uniform(-math.pi, math.pi)  # hue rotation (Rodrigues)
    axis = v[:3]
    a = float(axis[0])  # (1, 1, 1) / sqrt(3)
    K = torch.tensor([[0.0, -a, a], [a, 0.0, -a], [-a, a, 0.0]])
    ct, st = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    M = eye4.repeat(n, 1, 1)
    M[:, :3, :3] = ct * torch.eye(3)[None] + st * K[None] + (1 - ct) * torch.outer(axis, axis)[None]
    C = d.gated(p, M, C)

    s = d.lognormal2(1.0)  # saturation, over the full 4x4 as the reference
    return d.gated(p, vv[None] + (eye4[None] - vv[None]) * s[:, None, None], C)


def sample_augment(n, p, height, width, generator=None):
    """One augment call's draws: (affine (n, 3, 3), colour (n, 4, 4))."""
    return (sample_affine_matrices(n, p, height, width, generator),
            sample_color_matrices(n, p, generator))


# ---------------------------------------------------------------------------
# Resampling
# ---------------------------------------------------------------------------
def _to(t, device):
    """Host tensor -> device without a sync (pinned, non-blocking)."""
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@functools.cache
def _sym6_taps(device):
    """(y-up, x-up, y-down, x-down) taps on `device`: the up passes use the
    flipped filter, the down passes the filter as it is."""
    k = np.asarray(SYM6, np.float32)
    shapes = ((k[::-1], (-1, 1)), (k[::-1], (1, -1)), (k, (-1, 1)), (k, (1, -1)))
    return tuple(torch.tensor(np.ascontiguousarray(a).reshape(s), device=device)
                 for a, s in shapes)


def _needed_pad(Ginv, h):
    """Smallest reflect pad (pixels, a float) under which this batch's warp
    reads stay inside the padded buffer with a full filter support of margin;
    computed from the P = 0 warp coefficients, since q(P) = q(0) + 2P."""
    win = 2 * h + 2 * PAD_K
    beta = (-PAD_K + 0.5) / h - 1.0

    def minmax(a, b, cbase):
        lo = cbase + torch.clamp(a * (win - 1.0), max=0.0) + torch.clamp(b * (win - 1.0), max=0.0)
        hi = cbase + torch.clamp(a * (win - 1.0), min=0.0) + torch.clamp(b * (win - 1.0), min=0.0)
        return lo, hi

    cy = h * ((Ginv[:, 1, 0] + Ginv[:, 1, 1]) * beta + Ginv[:, 1, 2] + 1.0) - 0.5
    cx = h * ((Ginv[:, 0, 0] + Ginv[:, 0, 1]) * beta + Ginv[:, 0, 2] + 1.0) - 0.5
    ylo, yhi = minmax(Ginv[:, 1, 1], Ginv[:, 1, 0], cy)
    xlo, xhi = minmax(Ginv[:, 0, 1], Ginv[:, 0, 0], cx)
    qmin = torch.minimum(ylo.min(), xlo.min())
    qmax = torch.maximum(yhi.max(), xhi.max())
    need = torch.maximum(-qmin, qmax - 2.0 * h + 2.0) / 2.0
    return float(torch.ceil(torch.clamp(need, min=0.0)) + PAD_K + 1)


def _warp_coef(Ginv, h, P):
    """(n, 6) [ay, by, cy, ax, bx, cx] of the warp at reflect pad P: the
    source point (src + 1) * h + 2P - 0.5 is affine in the output indices."""
    m0 = 2 * P - PAD_K
    beta = (m0 + 0.5 - 2 * P) / h - 1.0
    off = 2 * P - 0.5
    cy = h * ((Ginv[:, 1, 0] + Ginv[:, 1, 1]) * beta + Ginv[:, 1, 2] + 1.0) + off
    cx = h * ((Ginv[:, 0, 0] + Ginv[:, 0, 1]) * beta + Ginv[:, 0, 2] + 1.0) + off
    return torch.stack([Ginv[:, 1, 1], Ginv[:, 1, 0], cy, Ginv[:, 0, 1], Ginv[:, 0, 0], cx], -1)


def _reflect_pad(x, P):
    """x reflect-padded by P on each side, as contiguous NCHW fp32 whatever
    x's layout (the NHWC images arrive as a channels-last view), so that
    every FIR pass takes its family's instance of the upfirdn2d kernel."""
    return F.pad(x.float().contiguous(), (P, P, P, P), mode="reflect")


def _antialiased_resample(x, Ginv, P):
    """The sym6 resample of NCHW x at ONE reflect pad P: pad, 2x up-filter,
    warp, down-filter, crop."""
    n, c, h, w = x.shape
    kyf, kxf, ky, kx = _sym6_taps(x.device)
    coef = _to(_warp_coef(Ginv, h, P).contiguous(), x.device)
    xp = _reflect_pad(x, P)
    x2 = upfirdn2d(xp, kyf, up=(1, 2), pad=(0, 0, PAD_K, PAD_K - 1))
    x2 = upfirdn2d(x2, kxf, up=(2, 1), pad=(PAD_K, PAD_K - 1, 0, 0))
    y = affine_gather(x2, coef, 2 * h + 2 * PAD_K)
    out = upfirdn2d(y, ky, down=(1, 2), pad=(0, 0, PAD_K - 1, PAD_K - 1))
    out = upfirdn2d(out, kx, down=(2, 1), pad=(PAD_K - 1, PAD_K - 1, 0, 0))
    return out[:, :, 3:3 + h, 3:3 + w]


@functools.cache
def _polyphase_taps(device):
    """(y phase 0, y phase 1, the four 6x6 down taps in PARITIES order) on
    `device`. Up: x2[2m + phi] = sum_t k[2t + phi] xp[m + t - d_phi]; down:
    out[o] = sum_t c0[t] Y0[o + t - 2] + c1[t] Y1[o + t - 3] per axis, with
    c0[t] = k[10 - 2t], c1[t] = k[11 - 2t] (diagan_tpu/ops/ada_phase.py has
    the identities). Each is given flipped, as the op convolves."""
    k = np.asarray(SYM6, np.float32)
    c_tap = (k[10::-2], k[11::-2])
    taps = [k[0::2][::-1].reshape(-1, 1), k[1::2][::-1].reshape(-1, 1)]
    taps += [np.outer(c_tap[a][::-1], c_tap[b][::-1]) for a, b in PARITIES]
    return tuple(torch.tensor(np.ascontiguousarray(t), device=device) for t in taps)


def _polyphase_resample(x, Ginv, P):
    """The same sym6 resample as `_antialiased_resample`, at ONE reflect pad
    P, in polyphase form: reflect pad, the 12-tap x up-pass, the two 6-tap
    y-phase passes (the planes v0, v1 of the 2x buffer), the two-phase warp
    into four parity quarter grids, four 6x6 stride-1 FIRs summed, crop.
    Equal to the interleaved form up to fp32 summation order."""
    n, c, h, w = x.shape
    s = h + 2 * P
    kxf = _sym6_taps(x.device)[1]
    b0, b1, *down = _polyphase_taps(x.device)
    coef = _to(_warp_coef(Ginv, h, P).contiguous(), x.device)
    xp = _reflect_pad(x, P)
    a_buf = upfirdn2d(xp, kxf, up=(2, 1), pad=(PAD_K, PAD_K - 1, 0, 0))
    v0 = upfirdn2d(a_buf, b0, pad=(0, 0, 3, 2))
    v1 = upfirdn2d(a_buf, b1, pad=(0, 0, 2, 3))
    ys = affine_gather_2phase(v0, v1, coef, 2 * h + 2 * PAD_K, 2 * s)
    out = None
    for y, (a, b), k2 in zip(ys, PARITIES, down):
        py0, px0 = (2, 3)[a], (2, 3)[b]
        term = upfirdn2d(y, k2, pad=(px0, 5 - px0, py0, 5 - py0))
        out = term if out is None else out + term
    return out[:, :, 3:3 + h, 3:3 + w]


def _polyphase_auto(device):
    """The polyphase opt-in: DIAGAN_TPU_ADA_POLYPHASE=1, honoured for CUDA
    tensors only (the JAX package honours it on its accelerator only, so on
    the CPU both take the interleaved form)."""
    return os.environ.get("DIAGAN_TPU_ADA_POLYPHASE", "0") == "1" and device.type == "cuda"


def pad_buckets_for(pad_frac):
    """The trainer's bucket fractions: those of (0.25, 0.5) below pad_frac
    (None when there are none: one static pad)."""
    return tuple(f for f in (0.25, 0.5) if f < pad_frac) or None


def _apply_affine_nchw(x, G, pad_frac=0.75, pad_buckets=None, polyphase=None):
    n, c, h, w = x.shape
    if h != w:
        raise ValueError(f"ADA's antialiased path takes square images, got {h}x{w}")
    Ginv = torch.linalg.inv(torch.as_tensor(G, dtype=torch.float32, device="cpu"))
    P = min(h - 1, int(pad_frac * h) + PAD_K)
    if polyphase is None:
        polyphase = _polyphase_auto(x.device)
    if polyphase:
        # the largest pad always, as the JAX package: its polyphase branch
        # returns before the pad-bucket switch
        return _polyphase_resample(x, Ginv, P)
    if pad_buckets:
        # smallest static bucket that covers this batch's transforms; the
        # resample costs ~(1 + 2P/h)^2, and outputs are equal within coverage
        Ps = sorted({min(h - 1, int(f * h) + PAD_K) for f in pad_buckets} | {P})
        Ps = [p_ for p_ in Ps if p_ <= P]
        if len(Ps) > 1:
            need = _needed_pad(Ginv, h)
            P = Ps[sum(need > p_ for p_ in Ps[:-1])]
    return _antialiased_resample(x, Ginv, P)


def apply_affine(images, G, pad_frac=0.75, pad_buckets=None, polyphase=None):
    """Apply per-image affine matrices G (n, 3, 3) (output NDC -> input NDC
    through G^-1) to NHWC images with the antialiased sym6 pipeline.
    pad_frac sets the largest reflect pad; pad_buckets (fractions, e.g.
    (0.25, 0.5)) lets each call take the smallest pad that covers its batch.
    polyphase selects the polyphase form of the same resample (None: the
    DIAGAN_TPU_ADA_POLYPHASE=1 opt-in, for CUDA tensors only); it always
    takes the largest pad and ignores pad_buckets, as the JAX package does."""
    out = _apply_affine_nchw(images.permute(0, 3, 1, 2), G, pad_frac, pad_buckets, polyphase)
    return out.permute(0, 2, 3, 1)


def _apply_color_nchw(x, C):
    C = _to(torch.as_tensor(C, dtype=torch.float32).contiguous(), x.device)
    r, g, b = x[:, 0], x[:, 1], x[:, 2]
    cols = [C[:, i, 0, None, None] * r + C[:, i, 1, None, None] * g
            + C[:, i, 2, None, None] * b + C[:, i, 3, None, None] for i in range(3)]
    return torch.stack(cols, 1)


def apply_color(images, C):
    """out[..., i] = sum_j C[i, j] * (r, g, b, 1)[j] on NHWC images, as
    per-channel FMAs."""
    return _apply_color_nchw(images.permute(0, 3, 1, 2), C).permute(0, 2, 3, 1)


def augment(images, p, G, C, pad_frac=0.75, pad_buckets=None):
    """Full ADA pipeline on NHWC images: geometric, then colour (3 channels),
    with the draws G (n, 3, 3) and C (n, 4, 4) of `sample_augment`. p is a
    host float; at p == 0 the images come back untouched."""
    if p == 0:
        return images
    out = _apply_affine_nchw(images.permute(0, 3, 1, 2), G, pad_frac, pad_buckets)
    if images.shape[-1] == 3:
        out = _apply_color_nchw(out, C)
    return out.to(images.dtype).permute(0, 2, 3, 1)


class AdaptiveAugment:
    """Drive p toward the r_t target (reference non_leaking.py:10-43)."""

    def __init__(self, ada_aug_target=0.6, ada_aug_len=500_000, update_every=256):
        self.ada_aug_target = ada_aug_target
        self.ada_aug_len = ada_aug_len
        self.update_every = update_every
        self.ada_aug_buf = [0.0, 0.0]  # (sign sum, count)
        self.r_t_stat = 0.0
        self.ada_aug_p = 0.0

    def tune(self, real_pred_sign_sum, count):
        """Feed (sum of sign(D(real)), count) once per D step; p moves when
        the accumulated image count reaches update_every."""
        self.ada_aug_buf[0] += float(real_pred_sign_sum)
        self.ada_aug_buf[1] += float(count)
        if self.ada_aug_buf[1] > self.update_every - 1:
            sign_sum, n = self.ada_aug_buf
            self.r_t_stat = sign_sum / max(n, 1)
            sign = 1 if self.r_t_stat > self.ada_aug_target else -1
            self.ada_aug_p += sign * n / self.ada_aug_len
            self.ada_aug_p = min(1.0, max(0.0, self.ada_aug_p))
            self.ada_aug_buf = [0.0, 0.0]
        return self.ada_aug_p
