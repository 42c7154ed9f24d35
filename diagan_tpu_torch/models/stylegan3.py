"""StyleGAN3-T, the translation-equivariant ("alias-free") generator, as torch
nn.Modules (Karras et al. 2021, arXiv:2106.12423; NVlabs stylegan3
training/networks_stylegan3.py, `train.py --cfg=stylegan3-t`).

  mapping    z -> w: z * rsqrt(mean z^2 + 1e-8), then MAPPING_LAYERS
             equalised dense layers at lr multiplier 0.01, each
             sqrt(2) * leaky_relu_0.2; w is broadcast to NUM_LAYERS + 2 ws.
             Truncation is psi = 1: the `w_avg` buffer is kept, unused.
  input      Fourier features of `channels[0]` frequencies on a
             size[0]^2 grid at sampling rate sr[0], under a per-sample
             rotation and translation t = affine(ws[0]) / |t[:2]|, then a
             channel mix by weight / sqrt(C).
  layer i    a modulated convolution with pre-normalisation (W to unit mean
             square per output channel, the styles to unit mean square over
             the whole batch), input gain rsqrt(magnitude_ema) and "full"
             padding k - 1, demodulated, plus the bias, then
             ops/filtered_lrelu.py: up by `up` with the Kaiser-windowed
             low-pass `up_filter`, sqrt(2) * leaky_relu_0.2 clamped to
             +-CONV_CLAMP, down by `down` with `down_filter`; each filter
             FILTER_SIZE * factor taps, designed per layer by scipy's
             firwin from the layer's cutoff and transition band.
  ToRGB      the last layer: a 1x1 convolution of styles * 1/sqrt(C_in),
             no demodulation, plus the bias, clamped; the image is that
             times OUTPUT_SCALE.

`synthesis_schedule` computes every layer's sizes, channels, filters'
cutoffs, factors and pads from the published formulas (networks_stylegan3.py
SynthesisNetwork / SynthesisLayer), so a test can pin the table at 256 px.

Parameter and buffer names are NVlabs' (`mapping.fc{i}`, `mapping.w_avg`,
`synthesis.input.{weight, affine, freqs, phases, transform}`,
`synthesis.L{i}_{size}_{channels}.{weight, bias, affine, magnitude_ema,
up_filter, down_filter}`), so that a converted pkl can load into them.

Departures from NVlabs' network, none of which changes the function:
  - every layer runs in fp32 (NVlabs runs the layers whose sampling rate
    exceeds img_resolution / 2^num_fp16_res in fp16 on a card);
  - the modulated convolution is one ordinary convolution of the input
    scaled by style * input gain, with the output scaled by the
    demodulation (the SG2 formulation of models/stylegan2.py), where NVlabs
    builds per-sample weights for a grouped convolution; the demodulation
    and the bias are one torch.addcmul;
  - the filters are applied as separable x and y passes (ops/filtered_lrelu.py),
    which NVlabs' reference upfirdn2d does for 1-D filters too;
  - no magnitude_ema update (sampling only) and no conditioning (c_dim 0).
Images cross the public forward NHWC (N, H, W, 3), as the port's other
generators do.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diagan_tpu_torch.device import resolve_device
from diagan_tpu_torch.ops import fused_leaky_relu
from diagan_tpu_torch.ops.filtered_lrelu import filtered_lrelu

# `train.py --cfg=stylegan3-t`'s network (networks_stylegan3.py defaults)
Z_DIM = W_DIM = 512
MAPPING_LAYERS, MAPPING_LR = 2, 0.01
NUM_LAYERS, NUM_CRITICAL = 14, 2
FIRST_CUTOFF, FIRST_STOPBAND, LAST_STOPBAND_REL = 2, 2 ** 2.1, 2 ** 0.3
MARGIN_SIZE, FILTER_SIZE, LRELU_UPSAMPLING, CONV_KERNEL = 10, 6, 2, 3
CONV_CLAMP, OUTPUT_SCALE, IMG_CHANNELS = 256, 0.25, 3


def synthesis_schedule(img_resolution=256, channel_base=32768, channel_max=512):
    """The input's and each layer's parameters, as NVlabs computes them:
    (input dict: channels, size, sampling_rate, bandwidth; a list of
    NUM_LAYERS + 1 layer dicts: name, torgb, in/out channels, sizes,
    sampling rates, cutoffs and half widths, tmp_sampling_rate, up, down,
    up_taps, down_taps, padding (x0, x1, y0, y1), conv_kernel).
    img_resolution and channel_base are the published configuration's
    knobs; the CPU tests narrow the network through them."""
    last_cutoff = img_resolution / 2
    last_stopband = last_cutoff * LAST_STOPBAND_REL
    exponents = np.minimum(np.arange(NUM_LAYERS + 1) / (NUM_LAYERS - NUM_CRITICAL), 1)
    cutoffs = FIRST_CUTOFF * (last_cutoff / FIRST_CUTOFF) ** exponents
    stopbands = FIRST_STOPBAND * (last_stopband / FIRST_STOPBAND) ** exponents
    rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, img_resolution))))
    half_widths = np.maximum(stopbands, rates / 2) - cutoffs
    sizes = rates + MARGIN_SIZE * 2
    sizes[-2:] = img_resolution
    channels = np.rint(np.minimum((channel_base / 2) / cutoffs, channel_max))
    channels[-1] = IMG_CHANNELS
    inp = dict(channels=int(channels[0]), size=int(sizes[0]), sampling_rate=float(rates[0]),
               bandwidth=float(cutoffs[0]))
    layers = []
    for i in range(NUM_LAYERS + 1):
        p = max(i - 1, 0)
        torgb = i == NUM_LAYERS
        k = 1 if torgb else CONV_KERNEL
        tmp = max(rates[p], rates[i]) * (1 if torgb else LRELU_UPSAMPLING)
        up, down = int(np.rint(tmp / rates[p])), int(np.rint(tmp / rates[i]))
        up_taps = FILTER_SIZE * up if up > 1 and not torgb else 1
        down_taps = FILTER_SIZE * down if down > 1 and not torgb else 1
        pad_total = (int(sizes[i]) - 1) * down + 1
        pad_total -= (int(sizes[p]) + k - 1) * up
        pad_total += up_taps + down_taps - 2
        pad_lo = (pad_total + up) // 2
        pad_hi = pad_total - pad_lo
        layers.append(dict(
            name=f"L{i}_{int(sizes[i])}_{int(channels[i])}", torgb=torgb,
            in_channels=int(channels[p]), out_channels=int(channels[i]),
            in_size=int(sizes[p]), out_size=int(sizes[i]),
            in_sampling_rate=float(rates[p]), out_sampling_rate=float(rates[i]),
            in_cutoff=float(cutoffs[p]), out_cutoff=float(cutoffs[i]),
            in_half_width=float(half_widths[p]), out_half_width=float(half_widths[i]),
            tmp_sampling_rate=float(tmp), up=up, down=down, up_taps=up_taps,
            down_taps=down_taps, padding=(pad_lo, pad_hi, pad_lo, pad_hi), conv_kernel=k))
    return inp, layers


def design_lowpass_filter(numtaps, cutoff, width, fs):
    """A Kaiser-windowed low-pass FIR (scipy.signal.firwin) as float32 taps,
    or None for a single tap (no filtering)."""
    if numtaps == 1:
        return None
    import scipy.signal

    return torch.as_tensor(scipy.signal.firwin(numtaps=numtaps, cutoff=cutoff, width=width,
                                               fs=fs), dtype=torch.float32)


class FullyConnected(nn.Module):
    """NVlabs FullyConnectedLayer: weight (out, in) drawn N(0, 1) *
    weight_init / lr_multiplier, used times lr_multiplier / sqrt(in); bias
    (a number or a list) used times lr_multiplier; with `activation`,
    sqrt(2) * leaky_relu_0.2 (the bias-act kernel)."""

    def __init__(self, in_features, out_features, activation=False, lr_multiplier=1.0,
                 weight_init=1.0, bias_init=0.0, device="cuda"):
        super().__init__()
        self.weight = nn.Parameter(torch.randn((out_features, in_features), device=device)
                                   * (weight_init / lr_multiplier))
        bias = np.broadcast_to(np.asarray(bias_init, dtype=np.float32), [out_features])
        self.bias = nn.Parameter(torch.tensor(bias / lr_multiplier, device=device))
        self.activation = activation
        self.weight_gain = lr_multiplier / math.sqrt(in_features)
        self.bias_gain = lr_multiplier

    def forward(self, x):
        w = self.weight * self.weight_gain
        b = self.bias * self.bias_gain
        if self.activation:
            return fused_leaky_relu(x @ w.t(), b)
        return torch.addmm(b, x, w.t())


class MappingNetwork(nn.Module):
    def __init__(self, device="cuda"):
        super().__init__()
        for i in range(MAPPING_LAYERS):
            setattr(self, f"fc{i}", FullyConnected(Z_DIM if i == 0 else W_DIM, W_DIM, True,
                                                   MAPPING_LR, device=device))
        self.register_buffer("w_avg", torch.zeros([W_DIM], device=device))

    def forward(self, z):
        """z (N, Z_DIM) -> w (N, W_DIM)."""
        x = z.float()
        x = x * (x.square().mean(1, keepdim=True) + 1e-8).rsqrt()
        for i in range(MAPPING_LAYERS):
            x = getattr(self, f"fc{i}")(x)
        return x


class SynthesisInput(nn.Module):
    def __init__(self, channels, size, sampling_rate, bandwidth, device="cuda"):
        super().__init__()
        self.channels, self.size = channels, size
        self.sampling_rate, self.bandwidth = sampling_rate, bandwidth
        freqs = torch.randn([channels, 2], device=device)
        radii = freqs.square().sum(dim=1, keepdim=True).sqrt()
        freqs = freqs / (radii * radii.square().exp().pow(0.25)) * bandwidth
        self.weight = nn.Parameter(torch.randn([channels, channels], device=device))
        self.affine = FullyConnected(W_DIM, 4, weight_init=0.0, bias_init=[1, 0, 0, 0],
                                     device=device)
        self.register_buffer("transform", torch.eye(3, 3, device=device))
        self.register_buffer("freqs", freqs)
        self.register_buffer("phases", torch.rand([channels], device=device) - 0.5)

    def forward(self, w):
        """w (N, W_DIM) -> Fourier features (N, C, size, size)."""
        n = w.shape[0]
        t = self.affine(w)  # (r_c, r_s, t_x, t_y)
        t = t / t[:, :2].norm(dim=1, keepdim=True)
        m_r = torch.eye(3, device=w.device).unsqueeze(0).repeat([n, 1, 1])
        m_r[:, 0, 0], m_r[:, 0, 1] = t[:, 0], -t[:, 1]
        m_r[:, 1, 0], m_r[:, 1, 1] = t[:, 1], t[:, 0]
        m_t = torch.eye(3, device=w.device).unsqueeze(0).repeat([n, 1, 1])
        m_t[:, 0, 2], m_t[:, 1, 2] = -t[:, 2], -t[:, 3]
        transforms = m_r @ m_t @ self.transform.unsqueeze(0)
        freqs = self.freqs.unsqueeze(0)
        phases = self.phases.unsqueeze(0) + (freqs @ transforms[:, :2, 2:]).squeeze(2)
        freqs = freqs @ transforms[:, :2, :2]
        amplitudes = (1 - (freqs.norm(dim=2) - self.bandwidth)
                      / (self.sampling_rate / 2 - self.bandwidth)).clamp(0, 1)
        theta = torch.eye(2, 3, device=w.device)
        theta[0, 0] = theta[1, 1] = 0.5 * self.size / self.sampling_rate
        grids = F.affine_grid(theta.unsqueeze(0), [1, 1, self.size, self.size],
                              align_corners=False)
        x = (grids.unsqueeze(3) @ freqs.permute(0, 2, 1).unsqueeze(1).unsqueeze(2)).squeeze(3)
        x = torch.sin((x + phases.unsqueeze(1).unsqueeze(2)) * (np.pi * 2))
        x = x * amplitudes.unsqueeze(1).unsqueeze(2)
        x = x @ (self.weight / np.sqrt(self.channels)).t()
        return x.permute(0, 3, 1, 2).contiguous()


class SynthesisLayer(nn.Module):
    """One layer of the schedule (`spec`, a synthesis_schedule layer dict)."""

    def __init__(self, spec, device="cuda"):
        super().__init__()
        self.torgb = spec["torgb"]
        self.up, self.down, self.padding = spec["up"], spec["down"], spec["padding"]
        cin, cout, k = spec["in_channels"], spec["out_channels"], spec["conv_kernel"]
        self.affine = FullyConnected(W_DIM, cin, bias_init=1.0, device=device)
        self.weight = nn.Parameter(torch.randn([cout, cin, k, k], device=device))
        self.bias = nn.Parameter(torch.zeros([cout], device=device))
        self.register_buffer("magnitude_ema", torch.ones([], device=device))
        tmp = spec["tmp_sampling_rate"]
        for name, taps, cutoff, half_width in (
                ("up_filter", spec["up_taps"], spec["in_cutoff"], spec["in_half_width"]),
                ("down_filter", spec["down_taps"], spec["out_cutoff"], spec["out_half_width"])):
            f = design_lowpass_filter(taps, cutoff, half_width * 2, tmp)
            self.register_buffer(name, None if f is None else f.to(device))

    def forward(self, x, w):
        """x (N, C_in, H, W) fp32, w (N, W_DIM) -> (N, C_out, H', W')."""
        gain = self.magnitude_ema.rsqrt()
        s = self.affine(w)
        if self.torgb:
            s = s / math.sqrt(self.weight[0].numel())
            y = F.conv2d(x * (s * gain)[:, :, None, None], self.weight)
            return torch.clamp(y + self.bias[None, :, None, None], -CONV_CLAMP, CONV_CLAMP)
        weight = self.weight * self.weight.square().mean([1, 2, 3], keepdim=True).rsqrt()
        s = s * s.square().mean().rsqrt()
        demod = (s.square() @ weight.square().sum([2, 3]).t() + 1e-8).rsqrt()  # (N, C_out)
        t = torch.addcmul(self.bias[None, :, None, None],
                          F.conv2d(x * (s * gain)[:, :, None, None], weight,
                                   padding=weight.shape[-1] - 1),
                          demod[:, :, None, None])
        return filtered_lrelu(t, self.up_filter, self.down_filter, self.up, self.down,
                              self.padding, CONV_CLAMP)


class SynthesisNetwork(nn.Module):
    def __init__(self, img_resolution=256, channel_base=32768, channel_max=512, device="cuda"):
        super().__init__()
        inp, layers = synthesis_schedule(img_resolution, channel_base, channel_max)
        self.num_ws = len(layers) + 1
        self.input = SynthesisInput(device=device, **inp)
        self.layer_names = [spec["name"] for spec in layers]
        for spec in layers:
            setattr(self, spec["name"], SynthesisLayer(spec, device))

    def forward(self, ws):
        """ws (N, num_ws, W_DIM) -> images (N, 3, H, W) fp32."""
        ws = ws.float().unbind(dim=1)
        x = self.input(ws[0])
        for name, w in zip(self.layer_names, ws[1:]):
            x = getattr(self, name)(x, w)
        return x * OUTPUT_SCALE


class StyleGAN3Generator(nn.Module):
    """Mapping + synthesis: forward(z (N, Z_DIM)) returns NHWC images
    (N, H, W, 3)."""

    def __init__(self, img_resolution=256, channel_base=32768, channel_max=512, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.mapping = MappingNetwork(device=device)
        self.synthesis = SynthesisNetwork(img_resolution, channel_base, channel_max, device)

    def forward(self, z):
        w = self.mapping(z)
        ws = w.unsqueeze(1).expand(-1, self.synthesis.num_ws, -1)
        return self.synthesis(ws).permute(0, 2, 3, 1)
