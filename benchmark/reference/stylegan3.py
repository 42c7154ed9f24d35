"""Plain StyleGAN3-T generator (Karras et al. 2021, arXiv:2106.12423; NVlabs
stylegan3 training/networks_stylegan3.py, `--cfg=stylegan3-t`) in fp32 NCHW,
with TF32 off, and the count of a DRS proposal batch's work.

  mapping   z * rsqrt(mean z^2 + 1e-8), then 2 layers of
            sqrt(2) * lrelu_0.2(x (W * 0.01 / sqrt(512))^T + 0.01 b); w goes
            to all 16 ws (psi = 1: w_avg unused).
  schedule  for i = 0..14, e = min(i / 12, 1), cutoff 2 * 64^e, stopband
            2^2.1 (128 * 2^0.3 / 2^2.1)^e, sampling rate 2^ceil(log2
            min(2 stopband, 256)), half width max(stopband, sr / 2) - cutoff,
            size sr + 20 (256 for the last two), channels rint(min(16384 /
            cutoff, 512)) (3 for the last); layer i reads layer p = max(i - 1,
            0) at tmp = max(sr_p, sr_i) * 2 (* 1 for ToRGB), up = tmp / sr_p,
            down = tmp / sr_i, 6 * factor taps, firwin filters at fs = tmp,
            pad_total = (size_i - 1) down + 1 - (size_p + k - 1) up + taps - 2,
            pad_lo = (pad_total + up) // 2.
  input     Fourier features: freqs and phases rotated and translated by
            t = affine(ws[0]) / |t[:2]|, amplitudes clamp(1 - (|f| - 2) / 6),
            sin(2 pi (grid f^T + phase)) on affine_grid(diag(0.5 * 36 / 16)),
            then x (W / sqrt(512))^T.
  layer     per-sample weights W' = W * rsqrt(mean W^2) * s * rsqrt(mean s^2)
            (s = affine(w); the mean over the batch, so the reference may run
            in blocks: it moves the output only through the 1e-8 below),
            times rsqrt(sum W'^2 + 1e-8) per output channel, times the input
            gain rsqrt(magnitude_ema), one grouped convolution at padding
            k - 1; then t = y + b, u = upfirdn2d(t, fu (x) fu * up^2, up, pad),
            a = clamp(sqrt(2) lrelu_0.2(u), -256, 256), out = upfirdn2d(a,
            fd (x) fd, down). ToRGB: W * s / sqrt(C_in) * gain, no
            demodulation, out = clamp(y + b, -256, 256); the image is out *
            0.25.

Each upfirdn2d runs as NVlabs' reference runs a 1-D filter, an x pass then a
y pass, through `ops.upfirdn2d`, which logs each as a `fir` call; the
activation logs an `act` call (the bias add before the up pass is not
logged: a plain addition in both sides). Nothing here imports the program.

`calibrate` sets each layer's `magnitude_ema` to the mean square of its
input over one batch, as a trained model's tracked value would be.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import ops
from benchmark.reference.stylegan2 import Discriminator

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CLAMP, GAIN, SLOPE = 256.0, math.sqrt(2.0), 0.2


def _p(shape, device):
    return nn.Parameter(torch.empty(shape, device=device))


def schedule(cfg):
    """(a dict for each layer 0..num_layers, the input's dict) of `cfg`."""
    n, crit = cfg["num_layers"], cfg["num_critical"]
    res = cfg["img_resolution"]
    e = np.minimum(np.arange(n + 1) / (n - crit), 1)
    cut = cfg["first_cutoff"] * (res / 2 / cfg["first_cutoff"]) ** e
    stop = cfg["first_stopband"] * (res / 2 * cfg["last_stopband_rel"]
                                    / cfg["first_stopband"]) ** e
    sr = np.exp2(np.ceil(np.log2(np.minimum(stop * 2, res))))
    half = np.maximum(stop, sr / 2) - cut
    size = sr + 2 * cfg["margin_size"]
    size[-2:] = res
    ch = np.rint(np.minimum(cfg["channel_base"] / 2 / cut, cfg["channel_max"]))
    ch[-1] = 3
    layers = []
    for i in range(n + 1):
        p, rgb = max(i - 1, 0), i == n
        k = 1 if rgb else cfg["conv_kernel"]
        tmp = max(sr[p], sr[i]) * (1 if rgb else cfg["lrelu_upsampling"])
        up, down = int(round(tmp / sr[p])), int(round(tmp / sr[i]))
        ut = cfg["filter_size"] * up if up > 1 and not rgb else 1
        dt = cfg["filter_size"] * down if down > 1 and not rgb else 1
        total = (int(size[i]) - 1) * down + 1 - (int(size[p]) + k - 1) * up + ut + dt - 2
        lo = (total + up) // 2
        layers.append(dict(name=f"L{i}_{int(size[i])}_{int(ch[i])}", rgb=rgb, k=k,
                           cin=int(ch[p]), cout=int(ch[i]), up=up, down=down,
                           pad=(lo, total - lo), fs=tmp, up_taps=ut, down_taps=dt,
                           up_cutoff=cut[p], up_width=2 * half[p],
                           down_cutoff=cut[i], down_width=2 * half[i]))
    inp = dict(channels=int(ch[0]), size=int(size[0]), sr=float(sr[0]), bandwidth=float(cut[0]))
    return layers, inp


def lowpass(numtaps, cutoff, width, fs):
    import scipy.signal
    return scipy.signal.firwin(numtaps, cutoff, width=width, fs=fs).astype(np.float32)


def _act(x):
    """clamp(sqrt(2) * leaky_relu_0.2(x), -256, 256), logged as an `act` call."""
    y = torch.clamp(torch.where(x > 0, x, x * SLOPE) * GAIN, -CLAMP, CLAMP)
    ops._log("act", ops._nbytes(x, y))
    return y


def _fir(x, taps, up, down, pad):
    """upfirdn2d with the 2-D filter outer(taps, taps) (taps a 1-D tensor):
    the x pass, then the y pass; pad (p0, p1) on both axes."""
    x = ops.upfirdn2d(x, taps.reshape(1, -1), (up, 1), (down, 1), (pad[0], pad[1], 0, 0))
    return ops.upfirdn2d(x, taps.reshape(-1, 1), (1, up), (1, down), (0, 0, pad[0], pad[1]))


def filtered_lrelu(t, fu, fd, up, down, pad):
    """The layer's activation on t = y + b (NVlabs _filtered_lrelu_ref)."""
    return _fir(_act(_fir(t, fu * up, up, 1, pad)), fd, 1, down, (0, 0))


class Dense(nn.Module):
    """Equalised dense layer: x (W * lr / sqrt(in))^T + lr * b, with
    sqrt(2) * lrelu_0.2 when `activation`."""

    def __init__(self, cin, cout, lr=1.0, activation=False, device=None):
        super().__init__()
        self.weight, self.bias = _p((cout, cin), device), _p((cout,), device)
        self.gain, self.lr, self.activation = lr / math.sqrt(cin), lr, activation

    def forward(self, x):
        y = x @ (self.weight * self.gain).t() + self.bias * self.lr
        return torch.where(y > 0, y, y * SLOPE) * GAIN if self.activation else y


class Mapping(nn.Module):
    def __init__(self, dim, layers, lr, device=None):
        super().__init__()
        self.n = layers
        for i in range(layers):
            setattr(self, f"fc{i}", Dense(dim, dim, lr, True, device))
        self.register_buffer("w_avg", torch.zeros(dim, device=device))

    def forward(self, z):
        x = z * (z.square().mean(1, keepdim=True) + 1e-8).rsqrt()
        for i in range(self.n):
            x = getattr(self, f"fc{i}")(x)
        return x


class Input(nn.Module):
    def __init__(self, w_dim, channels, size, sr, bandwidth, device=None):
        super().__init__()
        self.c, self.size, self.sr, self.bw = channels, size, sr, bandwidth
        self.weight = _p((channels, channels), device)
        self.affine = Dense(w_dim, 4, device=device)
        self.register_buffer("transform", torch.eye(3, device=device))
        self.register_buffer("freqs", torch.empty((channels, 2), device=device))
        self.register_buffer("phases", torch.empty(channels, device=device))

    def forward(self, w):
        t = self.affine(w)
        t = t / t[:, :2].norm(dim=1, keepdim=True)
        zero, one = torch.zeros_like(t[:, 0]), torch.ones_like(t[:, 0])
        rot = torch.stack([torch.stack([t[:, 0], -t[:, 1], zero], 1),
                           torch.stack([t[:, 1], t[:, 0], zero], 1),
                           torch.stack([zero, zero, one], 1)], 1)
        tr = torch.stack([torch.stack([one, zero, -t[:, 2]], 1),
                          torch.stack([zero, one, -t[:, 3]], 1),
                          torch.stack([zero, zero, one], 1)], 1)
        T = rot @ tr @ self.transform
        phases = self.phases[None] + (self.freqs[None] @ T[:, :2, 2:]).squeeze(2)
        freqs = self.freqs[None] @ T[:, :2, :2]  # (n, C, 2)
        amp = torch.clamp(1 - (freqs.norm(dim=2) - self.bw) / (self.sr / 2 - self.bw), 0, 1)
        theta = torch.tensor([[0.5 * self.size / self.sr, 0, 0], [0, 0.5 * self.size / self.sr, 0]],
                             device=w.device)
        grid = F.affine_grid(theta[None], [1, 1, self.size, self.size], align_corners=False)
        x = torch.einsum("hwk,nck->nhwc", grid[0], freqs) + phases[:, None, None, :]
        x = torch.sin(x * (2 * math.pi)) * amp[:, None, None, :]
        x = x @ (self.weight / math.sqrt(self.c)).t()
        return x.permute(0, 3, 1, 2)


class Layer(nn.Module):
    def __init__(self, spec, w_dim, device=None):
        super().__init__()
        self.s = spec
        self.affine = Dense(w_dim, spec["cin"], device=device)
        self.weight = _p((spec["cout"], spec["cin"], spec["k"], spec["k"]), device)
        self.bias = _p((spec["cout"],), device)
        self.register_buffer("magnitude_ema", torch.ones((), device=device))
        if not spec["rgb"]:
            fu = lowpass(spec["up_taps"], spec["up_cutoff"], spec["up_width"], spec["fs"])
            fd = lowpass(spec["down_taps"], spec["down_cutoff"], spec["down_width"], spec["fs"])
            self.register_buffer("up_filter", torch.tensor(fu, device=device))
            self.register_buffer("down_filter", torch.tensor(fd, device=device))

    def forward(self, x, w):
        s, n = self.affine(w), x.shape[0]
        gain = self.magnitude_ema.rsqrt()
        cin, cout, k = self.s["cin"], self.s["cout"], self.s["k"]
        if self.s["rgb"]:
            wn = self.weight[None] * (s / math.sqrt(cin * k * k))[:, None, :, None, None]
        else:
            W = self.weight * self.weight.square().mean([1, 2, 3], keepdim=True).rsqrt()
            s = s * s.square().mean().rsqrt()
            wn = W[None] * s[:, None, :, None, None]
            wn = wn * (wn.square().sum([2, 3, 4]) + 1e-8).rsqrt()[:, :, None, None, None]
        wn = wn * gain
        y = F.conv2d(x.reshape(1, n * cin, *x.shape[2:]), wn.reshape(n * cout, cin, k, k),
                     padding=k - 1, groups=n)
        t = y.reshape(n, cout, *y.shape[2:]) + self.bias[None, :, None, None]
        if self.s["rgb"]:
            return torch.clamp(t, -CLAMP, CLAMP)
        return filtered_lrelu(t, self.up_filter, self.down_filter, self.s["up"], self.s["down"],
                              self.s["pad"])


class Synthesis(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        specs, inp = schedule(cfg)
        self.input = Input(cfg["w_dim"], device=device, **inp)
        self.names = [s["name"] for s in specs]
        for s in specs:
            setattr(self, s["name"], Layer(s, cfg["w_dim"], device))
        self.output_scale = cfg["output_scale"]

    def layers(self):
        return [getattr(self, n) for n in self.names]

    def forward(self, w):
        x = self.input(w)
        for layer in self.layers():
            x = layer(x, w)
        return x * self.output_scale


class Generator(nn.Module):
    """G(z) -> NHWC images; every layer takes the one w (psi = 1, no mixing)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.mapping = Mapping(cfg["w_dim"], cfg["mapping_layers"], cfg["mapping_lr"], device)
        self.synthesis = Synthesis(cfg, device)

    def forward(self, z):
        return self.synthesis(self.mapping(z)).permute(0, 2, 3, 1)


def models(cfg, device):
    """(G, twin D) of the configuration on `device` (uninitialised)."""
    return (Generator(cfg, device),
            Discriminator(cfg["img_resolution"], cfg["d_channel_multiplier"],
                          width_scale=cfg.get("d_width_scale", 1.0), device=device))


@torch.no_grad()
def calibrate(g, z):
    """{layer name: mean square of its input over the batch z}, set into each
    layer's magnitude_ema in turn (so each layer's input is that of a
    calibrated network)."""
    w = g.mapping(z)
    x = g.synthesis.input(w)
    out = {}
    for name, layer in zip(g.synthesis.names, g.synthesis.layers()):
        out[name] = x.square().mean()
        layer.magnitude_ema.copy_(out[name])
        x = layer(x, w)
    return out


def count_forward(cfg, batch):
    """(FLOPs, op calls) of one DRS proposal batch: G and the twin D forward,
    on the meta device (FlopCounterMode: matrix products and convolutions,
    the FIR passes' depthwise convolutions over their zero-stuffed inputs
    included, x 2 a multiply-add)."""
    from benchmark.reference.sg2_train import flop_counter
    dev = torch.device("meta")
    g, d = models(cfg, dev)
    ops.CALLS = calls = []
    counter = flop_counter()
    try:
        with counter, torch.no_grad():
            d(g(torch.empty((batch, cfg["z_dim"]), device=dev)))
    finally:
        ops.CALLS = None
    return counter.get_total_flops(), calls
