"""Plain StyleGAN2 (config F) generator and discriminator, ADA's non-leaking
augment and the StyleGAN2 losses, in fp32 NCHW, after rosinality's
stylegan2-pytorch (model.py, non_leaking.py, train.py) and the layer
equations of Karras et al. 2020.

The parameter names are those of the configuration's published layout as
the benchmark loads it into the program (`mapping.layers.<i>`,
`synthesis.layers.<conv1|to_rgb1|conv_up_<r>|conv_<r>|to_rgb_<r>>`,
`from_rgb`, `blocks.<i>`, `final_conv`, `final_linear`, `out_linear`), so
one seeded state_dict serves both sides. Images cross the public forwards
NHWC. Departures from the published model, kept because the program
computes the same function: the modulated convolution scales the input by
the style and the output by the demodulation (equal to per-sample weights),
and ADA's geometric pipeline upsamples with sym6 by two 12-tap passes,
warps bilinearly on the 2x grid, and takes the smallest reflect pad of
(0.25, 0.5, 0.75) x size + 6 that covers the batch's transforms (the
output is the same at any covering pad).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.ops import affine_gather, fused_act, resample_kernel, touched_pixels, \
    upfirdn2d

BLUR = (1, 3, 3, 1)


def channels(size, multiplier=2, width_scale=1.0):
    """Channels by resolution; width_scale < 1 narrows every stage (floor 8),
    a knob of the CPU tests only: every configuration runs at 1."""
    ch = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * multiplier, 128: 128 * multiplier,
          256: 64 * multiplier, 512: 32 * multiplier, 1024: 16 * multiplier}
    return ch if width_scale == 1.0 else {k: max(8, int(v * width_scale)) for k, v in ch.items()}


def _p(shape, device):
    return nn.Parameter(torch.empty(shape, device=device))


class EqualDense(nn.Module):
    def __init__(self, cin, cout, lr_mul=1.0, activation=False, device=None):
        super().__init__()
        self.weight, self.bias = _p((cout, cin), device), _p((cout,), device)
        self.scale, self.lr_mul, self.activation = lr_mul / math.sqrt(cin), lr_mul, activation

    def forward(self, x):
        y = F.linear(x, self.weight * self.scale)
        b = self.bias * self.lr_mul
        return fused_act(y, b) if self.activation else y + b


class EqualConv(nn.Module):
    def __init__(self, cin, cout, k, stride=1, bias=True, device=None):
        super().__init__()
        self.weight = _p((cout, cin, k, k), device)
        self.bias = _p((cout,), device) if bias else None
        self.scale, self.stride = 1.0 / math.sqrt(cin * k * k), stride
        self.padding = k // 2 if stride == 1 else 0

    def forward(self, x):
        y = F.conv2d(x, self.weight * self.scale, stride=self.stride, padding=self.padding)
        return y if self.bias is None else y + self.bias[None, :, None, None]


class Blur(nn.Module):
    def __init__(self, pad, factor=1, device=None):
        super().__init__()
        self.register_buffer("kernel", torch.tensor(resample_kernel(BLUR) * factor ** 2,
                                                    device=device), persistent=False)
        self.pad = pad

    def forward(self, x):
        return upfirdn2d(x, self.kernel, pad=self.pad)


class ModulatedConv(nn.Module):
    def __init__(self, cin, cout, style_dim, k, demodulate=True, upsample=False, device=None):
        super().__init__()
        self.weight = _p((cout, cin, k, k), device)
        self.modulation = EqualDense(style_dim, cin, device=device)
        self.scale, self.k = 1.0 / math.sqrt(cin * k * k), k
        self.demodulate, self.upsample = demodulate, upsample
        if upsample:
            p = (len(BLUR) - 2) - (k - 1)
            self.blur = Blur(((p + 1) // 2 + 1, p // 2 + 1), factor=2, device=device)

    def forward(self, x, style):
        s = self.modulation(style)
        w = self.weight * self.scale
        xs = x * s[:, :, None, None]
        if self.upsample:
            y = self.blur(F.conv_transpose2d(xs, w.transpose(0, 1), stride=2))
        else:
            y = F.conv2d(xs, w, padding=self.k // 2)
        if self.demodulate:
            demod = torch.rsqrt((s ** 2) @ (w ** 2).sum((2, 3)).t() + 1e-8)
            y = y * demod[:, :, None, None]
        return y


class NoiseInjection(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.weight = _p((), device)

    def forward(self, x, noise):
        return x + self.weight * noise


class StyledConv(nn.Module):
    def __init__(self, cin, cout, style_dim, upsample=False, device=None):
        super().__init__()
        self.conv = ModulatedConv(cin, cout, style_dim, 3, upsample=upsample, device=device)
        self.noise = NoiseInjection(device)
        self.bias = _p((cout,), device)

    def forward(self, x, style, noise):
        return fused_act(self.noise(self.conv(x, style), noise), self.bias)


class ToRGB(nn.Module):
    def __init__(self, cin, style_dim, device=None):
        super().__init__()
        self.conv = ModulatedConv(cin, 3, style_dim, 1, demodulate=False, device=device)
        self.bias = _p((3,), device)
        self.register_buffer("skip_kernel", torch.tensor(resample_kernel(BLUR) * 4, device=device),
                             persistent=False)

    def forward(self, x, style, skip=None):
        y = self.conv(x, style) + self.bias[None, :, None, None]
        if skip is not None:
            y = y + upfirdn2d(skip, self.skip_kernel, up=2, pad=(2, 1))
        return y


class Mapping(nn.Module):
    def __init__(self, style_dim, n_mlp, lr_mul, device=None):
        super().__init__()
        self.layers = nn.ModuleList(EqualDense(style_dim, style_dim, lr_mul, True, device)
                                    for _ in range(n_mlp))

    def forward(self, z):
        h = z * torch.rsqrt(torch.mean(z ** 2, dim=-1, keepdim=True) + 1e-8)
        for layer in self.layers:
            h = layer(h)
        return h


class Synthesis(nn.Module):
    def __init__(self, size, style_dim, multiplier, width_scale=1.0, device=None):
        super().__init__()
        ch = channels(size, multiplier, width_scale)
        self.size = size
        self.input = _p((1, ch[4], 4, 4), device)
        layers = {"conv1": StyledConv(ch[4], ch[4], style_dim, device=device),
                  "to_rgb1": ToRGB(ch[4], style_dim, device)}
        res = 8
        while res <= size:
            layers[f"conv_up_{res}"] = StyledConv(ch[res // 2], ch[res], style_dim, True, device)
            layers[f"conv_{res}"] = StyledConv(ch[res], ch[res], style_dim, device=device)
            layers[f"to_rgb_{res}"] = ToRGB(ch[res], style_dim, device)
            res *= 2
        self.layers = nn.ModuleDict(layers)

    def forward(self, styles, noises):
        """styles (N, n_latent, style_dim); noises NHWC (N, H, W, 1) list."""
        nz = [t.permute(0, 3, 1, 2) for t in noises]
        L = self.layers
        x = L["conv1"](self.input.repeat(styles.shape[0], 1, 1, 1), styles[:, 0], nz[0])
        skip = L["to_rgb1"](x, styles[:, 1])
        li, res = 1, 8
        while res <= self.size:
            x = L[f"conv_up_{res}"](x, styles[:, li], nz[li])
            x = L[f"conv_{res}"](x, styles[:, li + 1], nz[li + 1])
            skip = L[f"to_rgb_{res}"](x, styles[:, li + 2], skip)
            li, res = li + 2, res * 2
        return skip


def noise_shapes(size, n):
    """NHWC shapes of the per-layer noises, in the order Synthesis takes them."""
    shapes, res = [(n, 4, 4, 1)], 8
    while res <= size:
        shapes += [(n, res, res, 1)] * 2
        res *= 2
    return shapes


class Generator(nn.Module):
    def __init__(self, size=256, style_dim=512, n_mlp=8, channel_multiplier=2, lr_mlp=0.01,
                 width_scale=1.0, device=None):
        super().__init__()
        self.size, self.style_dim = size, style_dim
        self.n_latent = int(math.log2(size)) * 2 - 2
        self.mapping = Mapping(style_dim, n_mlp, lr_mlp, device)
        self.synthesis = Synthesis(size, style_dim, channel_multiplier, width_scale, device)

    def sample(self, zs, cutoff, noises):
        """zs: one or two latent batches; the second takes over at layer
        `cutoff` (n_latent: no mixing). Returns NHWC images."""
        ws = [self.mapping(z) for z in zs]
        styles = ws[0][:, None, :].expand(-1, self.n_latent, -1)
        if len(ws) > 1 and cutoff < self.n_latent:
            styles = torch.cat([styles[:, :cutoff],
                                ws[1][:, None, :].expand(-1, self.n_latent - cutoff, -1)], 1)
        return self.synthesis(styles, noises).permute(0, 2, 3, 1)


class ConvLayer(nn.Module):
    def __init__(self, cin, cout, k, downsample=False, activate=True, device=None):
        super().__init__()
        self.blur = None
        if downsample:
            p = (len(BLUR) - 2) + (k - 1)
            self.blur = Blur(((p + 1) // 2, p // 2), device=device)
        self.conv = EqualConv(cin, cout, k, 2 if downsample else 1, not activate, device)
        self.bias = _p((cout,), device) if activate else None

    def forward(self, x):
        if self.blur is not None:
            x = self.blur(x)
        x = self.conv(x)
        return x if self.bias is None else fused_act(x, self.bias)


class DResBlock(nn.Module):
    def __init__(self, cin, cout, device=None):
        super().__init__()
        self.conv1 = ConvLayer(cin, cin, 3, device=device)
        self.conv2 = ConvLayer(cin, cout, 3, downsample=True, device=device)
        self.skip = ConvLayer(cin, cout, 1, downsample=True, activate=False, device=device)

    def forward(self, x):
        return (self.conv2(self.conv1(x)) + self.skip(x)) / math.sqrt(2)


class Discriminator(nn.Module):
    def __init__(self, size=256, channel_multiplier=2, stddev_group=4, width_scale=1.0,
                 device=None):
        super().__init__()
        ch = channels(size, channel_multiplier, width_scale)
        self.from_rgb = ConvLayer(3, ch[size], 1, device=device)
        self.blocks = nn.ModuleList(DResBlock(ch[r], ch[r // 2], device)
                                    for r in [2 ** j for j in range(int(math.log2(size)), 2, -1)])
        self.final_conv = ConvLayer(ch[4] + 1, ch[4], 3, device=device)
        self.final_linear = EqualDense(ch[4] * 16, ch[4], activation=True, device=device)
        self.out_linear = EqualDense(ch[4], 1, device=device)
        self.stddev_group = stddev_group

    def forward(self, x):
        """x NHWC -> logits (N,)."""
        h = self.from_rgb(x.permute(0, 3, 1, 2))
        for block in self.blocks:
            h = block(h)
        n, c, hh, ww = h.shape
        g = min(self.stddev_group, n)
        y = h.reshape(g, -1, c, hh, ww)
        std = torch.sqrt(y.var(0, unbiased=False) + 1e-8).mean((1, 2, 3), keepdim=True)
        h = self.final_conv(torch.cat([h, std.repeat(g, 1, hh, ww)], 1))
        return self.out_linear(self.final_linear(h.reshape(n, -1))).squeeze(-1)


# --- ADA ----------------------------------------------------------------------
SYM6 = (0.015404109327027373, 0.0034907120842174702, -0.11799011114819057, -0.048311742585633,
        0.4910559419267466, 0.787641141030194, 0.3379294217276218, -0.07263752278646252,
        -0.021060292512300564, 0.04472490177066578, 0.0017677118642428036,
        -0.007800708325034148)
PAD_K = 6
PAD_BUCKETS = (0.25, 0.5)


def _needed_pad(Ginv, h):
    """The smallest reflect pad under which every warp read of the batch stays
    inside the padded buffer with a filter's support of margin."""
    win = 2 * h + 2 * PAD_K
    beta = (-PAD_K + 0.5) / h - 1.0
    lo_hi = []
    for a, b, c in ((Ginv[:, 1, 1], Ginv[:, 1, 0], Ginv[:, 1, 2]),
                    (Ginv[:, 0, 1], Ginv[:, 0, 0], Ginv[:, 0, 2])):
        base = h * ((a + b) * beta + c + 1.0) - 0.5
        lo_hi.append((base + torch.clamp(a * (win - 1.0), max=0.0)
                      + torch.clamp(b * (win - 1.0), max=0.0),
                      base + torch.clamp(a * (win - 1.0), min=0.0)
                      + torch.clamp(b * (win - 1.0), min=0.0)))
    qmin = torch.minimum(lo_hi[0][0].min(), lo_hi[1][0].min())
    qmax = torch.maximum(lo_hi[0][1].max(), lo_hi[1][1].max())
    need = torch.maximum(-qmin, qmax - 2.0 * h + 2.0) / 2.0
    return float(torch.ceil(torch.clamp(need, min=0.0)) + PAD_K + 1)


def choose_pad(G, h, pad_frac=0.75):
    """(G^-1, the reflect pad P) of one augment call's matrices G (n, 3, 3)."""
    Ginv = torch.linalg.inv(torch.as_tensor(G, dtype=torch.float32, device="cpu"))
    P = min(h - 1, int(pad_frac * h) + PAD_K)
    Ps = sorted({min(h - 1, int(f * h) + PAD_K) for f in PAD_BUCKETS if f < pad_frac} | {P})
    if len(Ps) > 1:
        need = _needed_pad(Ginv, h)
        P = Ps[sum(need > p for p in Ps[:-1])]
    return Ginv, P


def warp_coef(Ginv, h, P):
    beta = (2 * P - PAD_K + 0.5 - 2 * P) / h - 1.0
    off = 2 * P - 0.5
    cy = h * ((Ginv[:, 1, 0] + Ginv[:, 1, 1]) * beta + Ginv[:, 1, 2] + 1.0) + off
    cx = h * ((Ginv[:, 0, 0] + Ginv[:, 0, 1]) * beta + Ginv[:, 0, 2] + 1.0) + off
    return torch.stack([Ginv[:, 1, 1], Ginv[:, 1, 0], cy, Ginv[:, 0, 1], Ginv[:, 0, 0], cx], -1)


def augment(images, G, C, pad_frac=0.75, touched=None):
    """ADA's geometric then colour pipeline on NHWC images with one call's
    draws G (n, 3, 3) and C (n, 4, 4), host tensors. `touched`: the warp's
    touched-pixel count (ops.touched_pixels), for a count on the meta device."""
    x = images.permute(0, 3, 1, 2)
    n, c, h, w = x.shape
    Ginv, P = choose_pad(G, h, pad_frac)
    dev = x.device
    k = np.asarray(SYM6, np.float32)
    kyf, kxf = k[::-1].reshape(-1, 1).copy(), k[::-1].reshape(1, -1).copy()
    ky, kx = k.reshape(-1, 1), k.reshape(1, -1)
    coef = warp_coef(Ginv, h, P).to(dev)
    xp = F.pad(x.contiguous(), (P, P, P, P), mode="reflect")
    x2 = upfirdn2d(xp, kyf, up=(1, 2), pad=(0, 0, PAD_K, PAD_K - 1))
    x2 = upfirdn2d(x2, kxf, up=(2, 1), pad=(PAD_K, PAD_K - 1, 0, 0))
    y = affine_gather(x2, coef, 2 * h + 2 * PAD_K, touched)
    y = upfirdn2d(y, ky, down=(1, 2), pad=(0, 0, PAD_K - 1, PAD_K - 1))
    y = upfirdn2d(y, kx, down=(2, 1), pad=(PAD_K - 1, PAD_K - 1, 0, 0))
    y = y[:, :, 3:3 + h, 3:3 + w]
    Cd = torch.as_tensor(C, dtype=torch.float32).to(dev)
    out = torch.stack([Cd[:, i, 0, None, None] * y[:, 0] + Cd[:, i, 1, None, None] * y[:, 1]
                       + Cd[:, i, 2, None, None] * y[:, 2] + Cd[:, i, 3, None, None]
                       for i in range(3)], 1)
    return out.permute(0, 2, 3, 1)


def warp_touched(G, h, pad_frac=0.75, device="cpu"):
    """ops.touched_pixels of the warp of one augment call, on `device`."""
    Ginv, P = choose_pad(G, h, pad_frac)
    s2 = 2 * (h + 2 * P)
    return touched_pixels(warp_coef(Ginv, h, P).to(device), 2 * h + 2 * PAD_K, s2)


class AdaptiveAugment:
    """p moves by +-(images seen) / length toward the sign-of-D(real) target,
    every `update_every` images (rosinality non_leaking.py)."""

    def __init__(self, p, target=0.6, length=500_000, update_every=256):
        self.p, self.target, self.length, self.every = float(p), target, length, update_every
        self.buf = [0.0, 0.0]

    def tune(self, sign_sum, count):
        self.buf[0] += float(sign_sum)
        self.buf[1] += float(count)
        if self.buf[1] > self.every - 1:
            r_t = self.buf[0] / max(self.buf[1], 1)
            self.p = min(1.0, max(0.0, self.p + (1 if r_t > self.target else -1)
                                  * self.buf[1] / self.length))
            self.buf = [0.0, 0.0]
        return self.p


# --- losses -------------------------------------------------------------------
def d_logistic(real, fake):
    return F.softplus(-real).mean() + F.softplus(fake).mean()


def g_nonsaturating(fake):
    return F.softplus(-fake).mean()


def r1_penalty(real_pred, real_img):
    (grad,) = torch.autograd.grad(real_pred.sum(), real_img, create_graph=True)
    return grad.pow(2).sum() / grad.shape[0]


def path_length(imgs, styles, noise, pl_mean, decay=0.01):
    h, w = imgs.shape[1], imgs.shape[2]
    (grad,) = torch.autograd.grad((imgs * (noise / (h * w) ** 0.5)).sum(), styles,
                                  create_graph=True)
    lengths = torch.sqrt(grad.pow(2).sum((1, 2)) + 1e-12)
    new_mean = pl_mean + decay * (lengths.mean() - pl_mean)
    return (lengths - new_mean).pow(2).mean(), new_mean
