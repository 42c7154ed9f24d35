"""StyleGAN2 generator and discriminator as torch nn.Modules.

Counterpart of diagan_tpu/models/stylegan2.py, layer for layer: the 8-layer
lr_mul=0.01 mapping MLP, modulated 3x3 convs with demodulation, noise
injection and fused LeakyReLU(sqrt 2), the skip ToRGB path with upfirdn2d
upsampling, and the discriminator of blur-downsampled residual blocks,
minibatch stddev and a 2-layer head.

Layouts: the public forwards keep the JAX package's layouts (images NHWC
(N, H, W, 3), noises (N, H, W, 1), logits (N,)); inside, maps are NCHW. Conv
weights are (O, I, kh, kw). The upsampling ModulatedConv weight is used by
F.conv_transpose2d as it is (the reference rosinality layout), so the weight
bridge flips the JAX kernel for those layers.

The modulated conv keeps the JAX formulation: scale the input by the style s,
run one ordinary conv, scale the output by demod (computed in fp32), which
equals the reference's per-sample weights. With autograd off (sampling,
DRS, the D step's fakes) a StyledConv hands the undemodulated conv output,
demod and its noise to one bias-act pass (ops styled_leaky_relu) instead of
three passes over the map, with the same bits. The blur always runs through
upfirdn2d (the JAX blur fold is a TPU MXU trade and is off on its CPU
backend, so the parity tests compare the unfolded form on both sides).

Every module takes `device=` (default "cuda"; G and D check it with
device.py). G's synthesis network and D's backbone take a compute `dtype`
(bf16 for `generate --bf16` and `train_ffhq --bf16`): parameters, the
mapping, the demodulation, D's minibatch-stddev statistics and its dense
head stay fp32, each DResBlock's output is cast back to `dtype`, as the JAX
modules do. G and D take `remat` (`train_ffhq --remat`): under autograd each
StyledConv / ToRGB and each DResBlock runs inside a non-reentrant
`torch.utils.checkpoint`, so its internals are recomputed in the backward
instead of kept. The checkpoint is applied in `forward`, not by wrapping
modules, so the state_dict keys are the same with and without remat; no
random draw happens inside a checkpointed region (the noises are drawn
before it), since the checkpoint does not replay an explicit
torch.Generator.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from diagan_tpu_torch.device import resolve_device
from diagan_tpu_torch.ops import fused_leaky_relu, make_resample_kernel, styled_leaky_relu, \
    upfirdn2d
from diagan_tpu_torch.utils import trace

BLUR_KERNEL = (1, 3, 3, 1)


def _normal(shape, device, std=1.0):
    return nn.Parameter(torch.randn(shape, device=device) * std)


def _maybe_remat(remat, fn, *args):
    """fn(*args), inside a non-reentrant checkpoint when `remat` is set and
    autograd records. fn draws nothing, so no RNG state is stashed."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


class EqualDense(nn.Module):
    """Equalized-LR linear: weight (out, in) stored at N(0, 1/lr_mul), scaled
    by lr_mul/sqrt(in) at use; optional fused bias-LeakyReLU on the output.
    fp32 (the mapping, the modulations and the D head all run in fp32)."""

    def __init__(self, in_features, features, lr_mul=1.0, bias_init_val=0.0,
                 activation=False, device="cuda"):
        super().__init__()
        self.weight = _normal((features, in_features), device, 1.0 / lr_mul)
        self.bias = nn.Parameter(torch.full((features,), float(bias_init_val), device=device))
        self.scale = lr_mul / math.sqrt(in_features)
        self.lr_mul = lr_mul
        self.activation = activation

    def forward(self, x):
        y = F.linear(x.float(), self.weight * self.scale)
        bias = self.bias * self.lr_mul
        if self.activation:
            return fused_leaky_relu(y, bias)
        return y + bias


class EqualConv(nn.Module):
    """Equalized-LR conv, weight (O, I, k, k) scaled by 1/sqrt(I*k*k).
    stride 1 pads "SAME" (odd k); stride 2 expects a pre-blurred input, VALID.
    A bf16 `dtype` casts the input, the scaled weight and the bias (Flax's
    mixed precision); fp32 leaves the parameters' own dtype."""

    def __init__(self, in_features, features, kernel_size=3, stride=1,
                 use_bias=True, dtype=torch.float32, device="cuda"):
        super().__init__()
        self.dtype = dtype
        self.weight = _normal((features, in_features, kernel_size, kernel_size), device)
        self.bias = nn.Parameter(torch.zeros(features, device=device)) if use_bias else None
        self.scale = 1.0 / math.sqrt(in_features * kernel_size * kernel_size)
        self.stride = stride
        self.padding = kernel_size // 2 if stride == 1 else 0

    def forward(self, x):
        w, b = self.weight * self.scale, self.bias
        if self.dtype != torch.float32:
            x, w = x.to(self.dtype), w.to(self.dtype)
            b = None if b is None else b.to(self.dtype)
        y = F.conv2d(x, w, stride=self.stride, padding=self.padding)
        if b is not None:
            y = y + b[None, :, None, None]
        return y


class Blur(nn.Module):
    def __init__(self, kernel=BLUR_KERNEL, pad=(2, 1), upsample_factor=1, device="cuda"):
        super().__init__()
        k = make_resample_kernel(list(kernel)) * upsample_factor**2
        self.register_buffer("kernel", torch.tensor(k, device=device), persistent=False)
        self.pad = tuple(pad)

    def forward(self, x):
        return upfirdn2d(x, self.kernel, pad=self.pad)


class ModulatedConv(nn.Module):
    """Style-modulated conv with optional demodulation and x2 up- or
    downsampling (reference model.py ModulatedConv2d). Weight (O, I, k, k);
    the upsampling form hands it to conv_transpose2d as (I, O, k, k). The
    downsampling form (no caller in either package) is the JAX package's
    unfolded one: the blur with pad ((p + 1) // 2, p // 2), p = len(blur) - 2 +
    k - 1, through kernel A (ops/upfirdn2d.py), then a stride-2 VALID conv.
    The JAX package folds that blur into the conv's kernel by default
    (_fold_blur_enabled): the same function, another rounding."""

    def __init__(self, in_features, features, style_dim, kernel_size=3,
                 demodulate=True, upsample=False, downsample=False, blur_kernel=BLUR_KERNEL,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        self.weight = _normal((features, in_features, kernel_size, kernel_size), device)
        self.modulation = EqualDense(style_dim, in_features, bias_init_val=1.0, device=device)
        self.scale = 1.0 / math.sqrt(in_features * kernel_size * kernel_size)
        self.kernel_size = kernel_size
        self.demodulate = demodulate
        self.upsample = upsample
        self.downsample = downsample and not upsample
        self.dtype = dtype
        if upsample:
            p = (len(blur_kernel) - 2) - (kernel_size - 1)
            self.blur = Blur(blur_kernel, pad=((p + 1) // 2 + 1, p // 2 + 1),
                             upsample_factor=2, device=device)
        elif downsample:
            p = (len(blur_kernel) - 2) + (kernel_size - 1)
            self.blur = Blur(blur_kernel, pad=((p + 1) // 2, p // 2), device=device)

    def forward(self, x, style):
        y, demod = self.modulated(x, style)
        return y if demod is None else y * demod[:, :, None, None]

    def modulated(self, x, style):
        """(y, demod): the conv of the modulated input before demodulation,
        and demod (N, O) in the compute dtype (None without demodulation)."""
        s = self.modulation(style).float()  # (N, I)
        demod = None
        w = self.weight * self.scale  # fp32
        if self.demodulate:
            # d_n = 1/sqrt(sum_{k,I} (w * s_n)^2), in fp32
            sigma = (s**2) @ (w**2).sum((2, 3)).t()  # (N, O)
            demod = torch.rsqrt(sigma + 1e-8).to(self.dtype)
        # conv(x * s_n, w) == conv(x, w * s_n)
        xs = x.to(self.dtype) * s[:, :, None, None].to(self.dtype)
        w = w.to(self.dtype)
        if self.upsample:
            # transposed conv x2 (out = 2*in + k - 2), then the blur
            y = self.blur(F.conv_transpose2d(xs, w.transpose(0, 1), stride=2))
        elif self.downsample:
            y = F.conv2d(self.blur(xs), w, stride=2)
        else:
            y = F.conv2d(xs, w, padding=self.kernel_size // 2)
        return y, demod


class NoiseInjection(nn.Module):
    def __init__(self, device="cuda"):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros((), device=device))

    def forward(self, x, noise=None, generator=None):
        return x + self.weight.to(x.dtype) * self.draw(x, noise, generator)

    @staticmethod
    def draw(x, noise=None, generator=None):
        """The noise for map x in x's dtype: `noise` (N, 1, H, W), or None to
        draw it from `generator`."""
        if noise is None:
            n, _, h, w = x.shape
            noise = torch.randn((n, 1, h, w), generator=generator, device=x.device,
                                dtype=x.dtype)
        return noise.to(x.dtype)


class StyledConv(nn.Module):
    def __init__(self, in_features, features, style_dim, kernel_size=3,
                 upsample=False, blur_kernel=BLUR_KERNEL, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        self.conv = ModulatedConv(in_features, features, style_dim, kernel_size,
                                  upsample=upsample, blur_kernel=blur_kernel,
                                  dtype=dtype, device=device)
        self.noise = NoiseInjection(device=device)
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x, style, noise=None, generator=None):
        """With autograd off the demodulation, the noise and the bias-act run
        as one pass (styled_leaky_relu), with the same bits; under autograd
        they stay three differentiable steps."""
        trace.count("styled_act")
        if torch.is_grad_enabled():
            y = self.noise(self.conv(x, style), noise, generator)
            return fused_leaky_relu(y, self.bias.to(y.dtype))
        trace.count("styled_act_fused")
        y, demod = self.conv.modulated(x, style)
        return styled_leaky_relu(y, self.bias.to(y.dtype), demod,
                                 self.noise.draw(y, noise, generator),
                                 self.noise.weight.to(y.dtype))


class ToRGB(nn.Module):
    def __init__(self, in_features, style_dim, blur_kernel=BLUR_KERNEL,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        self.conv = ModulatedConv(in_features, 3, style_dim, 1, demodulate=False,
                                  dtype=dtype, device=device)
        self.bias = nn.Parameter(torch.zeros(3, device=device))
        k = make_resample_kernel(list(blur_kernel)) * 4
        self.register_buffer("skip_kernel", torch.tensor(k, device=device), persistent=False)

    def forward(self, x, style, skip=None):
        y = self.conv(x, style)
        y = y + self.bias.to(y.dtype)[None, :, None, None]
        if skip is not None:
            y = y + upfirdn2d(skip, self.skip_kernel, up=2, pad=(2, 1))
        return y


class MappingNetwork(nn.Module):
    def __init__(self, style_dim=512, n_layers=8, lr_mul=0.01, device="cuda"):
        super().__init__()
        self.layers = nn.ModuleList(
            EqualDense(style_dim, style_dim, lr_mul=lr_mul, activation=True, device=device)
            for _ in range(n_layers))

    def forward(self, z):
        h = z * torch.rsqrt(torch.mean(z**2, dim=-1, keepdim=True) + 1e-8)  # PixelNorm
        for layer in self.layers:
            h = layer(h)
        return h


def _channels(size, channel_multiplier=2, width_scale=1.0):
    # width_scale < 1 narrows every stage uniformly (floor 8ch): a test knob;
    # the published configurations use 1.0
    base = {
        4: 512, 8: 512, 16: 512, 32: 512,
        64: 256 * channel_multiplier, 128: 128 * channel_multiplier,
        256: 64 * channel_multiplier, 512: 32 * channel_multiplier,
        1024: 16 * channel_multiplier,
    }
    if width_scale != 1.0:
        base = {k: max(8, int(v * width_scale)) for k, v in base.items()}
    return base


class SynthesisNetwork(nn.Module):
    """Layers keep the JAX names (conv1, to_rgb1, conv_up_{res}, conv_{res},
    to_rgb_{res}) so the weight bridge maps them one to one."""

    def __init__(self, size=256, style_dim=512, channel_multiplier=2,
                 width_scale=1.0, blur_kernel=BLUR_KERNEL, dtype=torch.float32,
                 remat=False, device="cuda"):
        super().__init__()
        ch = _channels(size, channel_multiplier, width_scale)
        self.size = size
        self.dtype = dtype
        self.remat = remat
        self.input = _normal((1, ch[4], 4, 4), device)
        kw = dict(blur_kernel=blur_kernel, dtype=dtype, device=device)
        layers = {"conv1": StyledConv(ch[4], ch[4], style_dim, **kw),
                  "to_rgb1": ToRGB(ch[4], style_dim, **kw)}
        res = 8
        while res <= size:
            layers[f"conv_up_{res}"] = StyledConv(ch[res // 2], ch[res], style_dim,
                                                  upsample=True, **kw)
            layers[f"conv_{res}"] = StyledConv(ch[res], ch[res], style_dim, **kw)
            layers[f"to_rgb_{res}"] = ToRGB(ch[res], style_dim, **kw)
            res *= 2
        self.layers = nn.ModuleDict(layers)

    def noise_shapes(self, n):
        """NHWC shapes of the per-layer noises, in the order `forward` takes them."""
        shapes = [(n, 4, 4, 1)]
        res = 8
        while res <= self.size:
            shapes += [(n, res, res, 1)] * 2
            res *= 2
        return shapes

    def forward(self, styles, noises=None, generator=None):
        """styles: (N, n_latent, style_dim). noises: list of (N, H, W, 1), or
        None to draw them from `generator`. Returns (N, 3, H, W) fp32."""
        n = styles.shape[0]
        remat = self.remat and torch.is_grad_enabled()
        if noises is None and remat:
            # drawn before the checkpointed layers, in the order (and dtype)
            # in which each NoiseInjection would draw its own
            noises = [torch.randn(s, generator=generator, device=styles.device,
                                  dtype=self.dtype) for s in self.noise_shapes(n)]
        nz = (None if noises is None
              else [t.permute(0, 3, 1, 2) for t in noises])
        L = self.layers

        def conv(name, x, style, i):
            return _maybe_remat(remat, L[name], x, style, None if nz is None else nz[i],
                                generator)

        x = self.input.to(self.dtype).repeat(n, 1, 1, 1)
        x = conv("conv1", x, styles[:, 0], 0)
        skip = _maybe_remat(remat, L["to_rgb1"], x, styles[:, 1])
        li, ni, res = 1, 1, 8
        while res <= self.size:
            x = conv(f"conv_up_{res}", x, styles[:, li], ni)
            x = conv(f"conv_{res}", x, styles[:, li + 1], ni + 1)
            skip = _maybe_remat(remat, L[f"to_rgb_{res}"], x, styles[:, li + 2], skip)
            li, ni, res = li + 2, ni + 2, res * 2
        return skip.float()


class StyleGAN2Generator(nn.Module):
    """Mapping + synthesis, with style mixing and truncation at sampling time.
    forward(z) and sample(...) return NHWC images (N, size, size, 3)."""

    def __init__(self, size=256, style_dim=512, n_mlp=8, channel_multiplier=2,
                 width_scale=1.0, dtype=torch.float32, remat=False, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.size = size
        self.style_dim = style_dim
        self.n_latent = int(math.log2(size)) * 2 - 2
        self.mapping = MappingNetwork(style_dim, n_mlp, device=device)
        self.synthesis = SynthesisNetwork(size, style_dim, channel_multiplier,
                                          width_scale=width_scale, dtype=dtype,
                                          remat=remat, device=device)

    def forward(self, z, noises=None, generator=None):
        return self.sample([z], noises=noises, generator=generator)

    def sample(self, zs, mixing_cutoff=None, truncation=1.0, w_mean=None,
               noises=None, generator=None):
        """zs: list of 1 or 2 latent batches; mixing_cutoff: layer index at
        which the second style takes over. noises (NHWC list) or `generator`
        supply the per-layer noise."""
        ws = [self.mapping(z) for z in zs]
        if truncation < 1.0 and w_mean is not None:
            ws = [w_mean + truncation * (w - w_mean) for w in ws]
        if len(ws) == 1 or mixing_cutoff is None:
            styles = ws[0][:, None, :].expand(-1, self.n_latent, -1)
        else:
            layer_idx = torch.arange(self.n_latent, device=ws[0].device)[None, :, None]
            mask = (layer_idx < mixing_cutoff).to(ws[0].dtype)
            styles = mask * ws[0][:, None, :] + (1 - mask) * ws[1][:, None, :]
        return self.synthesis(styles, noises, generator).permute(0, 2, 3, 1)

    def mean_latent(self, n_latent=4096, generator=None):
        dev = self.synthesis.input.device
        z = torch.randn((n_latent, self.style_dim), generator=generator, device=dev)
        return self.mapping(z).mean(0, keepdim=True)


class ConvLayer(nn.Module):
    def __init__(self, in_features, features, kernel_size=3, downsample=False,
                 activate=True, blur_kernel=BLUR_KERNEL, dtype=torch.float32, device="cuda"):
        super().__init__()
        if downsample:
            p = (len(blur_kernel) - 2) + (kernel_size - 1)
            self.blur = Blur(blur_kernel, pad=((p + 1) // 2, p // 2), device=device)
        else:
            self.blur = None
        self.conv = EqualConv(in_features, features, kernel_size,
                              stride=2 if downsample else 1,
                              use_bias=not activate, dtype=dtype, device=device)
        self.bias = nn.Parameter(torch.zeros(features, device=device)) if activate else None

    def forward(self, x):
        if self.blur is not None:
            x = self.blur(x)
        x = self.conv(x)
        if self.bias is not None:
            x = fused_leaky_relu(x, self.bias.to(x.dtype))
        return x


class DResBlock(nn.Module):
    def __init__(self, in_features, features, blur_kernel=BLUR_KERNEL, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        self.dtype = dtype
        kw = dict(blur_kernel=blur_kernel, dtype=dtype, device=device)
        self.conv1 = ConvLayer(in_features, in_features, 3, **kw)
        self.conv2 = ConvLayer(in_features, features, 3, downsample=True, **kw)
        self.skip = ConvLayer(in_features, features, 1, downsample=True,
                              activate=False, **kw)

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        out = (out + self.skip(x)) / math.sqrt(2)
        return out if self.dtype == torch.float32 else out.to(self.dtype)


class StyleGAN2Discriminator(nn.Module):
    """forward(x NHWC) -> (logits (N,), {"features": (N, C4)}), both fp32.
    The backbone runs in `dtype`; the minibatch-stddev statistics and the
    dense head in fp32. `remat` checkpoints each DResBlock under autograd."""

    def __init__(self, size=256, channel_multiplier=2, width_scale=1.0,
                 stddev_group=4, dtype=torch.float32, remat=False, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        ch = _channels(size, channel_multiplier, width_scale)
        log_size = int(math.log2(size))
        kw = dict(dtype=dtype, device=device)
        self.from_rgb = ConvLayer(3, ch[size], 1, **kw)
        self.blocks = nn.ModuleList(
            DResBlock(ch[res], ch[res // 2], **kw)
            for res in [2**j for j in range(log_size, 2, -1)])
        self.final_conv = ConvLayer(ch[4] + 1, ch[4], 3, **kw)
        self.final_linear = EqualDense(ch[4] * 16, ch[4], activation=True, device=device)
        self.out_linear = EqualDense(ch[4], 1, device=device)
        self.stddev_group = stddev_group
        self.dtype = dtype
        self.remat = remat

    def forward(self, x):
        h = self.from_rgb(x.permute(0, 3, 1, 2).contiguous())
        for block in self.blocks:
            h = _maybe_remat(self.remat, block, h)
        # minibatch stddev (group 4), its statistics in fp32
        n, c, hh, ww = h.shape
        g = min(self.stddev_group, n)
        y = h.reshape(g, -1, c, hh, ww)
        if self.dtype != torch.float32:
            y = y.float()
        std = torch.sqrt(y.var(0, unbiased=False) + 1e-8).mean((1, 2, 3), keepdim=True)
        h = self.final_conv(torch.cat([h, std.to(h.dtype).repeat(g, 1, hh, ww)], 1))
        h = self.final_linear(h.reshape(n, -1))
        logits = self.out_linear(h)
        return logits.squeeze(-1), {"features": h}
