"""SNGAN building blocks (counterpart of diagan_tpu/models/layers.py), NCHW.

Two layers keep the JAX package's (Flax's) semantics, not torch's:

  - spectral norm (SNConv2d, SNLinear): every forward runs one power
    iteration from the stored u, with or without update_stats:
        v = l2n(W^T u),  u' = l2n(W v),  sigma = u' . (W v),
    with W the weight as an (out, fan_in) matrix, l2n(x) = x / sqrt(|x|^2 +
    1e-12), u' and v without gradient and sigma a function of W, so the
    gradient flows through sigma. The layer divides W by sigma, and stores u'
    only when update_stats is true. u starts as an unnormalised N(0, 1) draw.
    (torch.nn.utils.spectral_norm differs in eval mode and in sigma.) The
    state_dict is torch-mimicry's: the raw `weight` and the buffer `weight_u`.
  - BatchNorm: the running statistics move by momentum 0.99 (torch's
    momentum 0.01) with the biased batch variance, eps 1e-5, and only when
    update_stats is true, so a train-mode forward can use batch statistics
    and leave the buffers alone (the fakes of a D update). In eval mode it
    uses the running statistics. It normalises NCHW per channel and (N, F)
    per feature, as Flax's BatchNorm on the last axis does. The state_dict
    is torch's BatchNorm2d's.

Block layout and initialisation as torch-mimicry's SNGAN (and the JAX
package's): nearest 2x upsample, 2x2 mean pool, global sum pool,
Xavier-uniform weights with gain sqrt(2) on block convs and 1 on shortcuts
and heads, zero biases.

Compute dtype (`dtype`, the JAX package's mixed precision, its layers.py
`dtype`): the convs and dense layers (SNConv2d, SNLinear, Conv2d,
ConvTranspose2d, Linear) take one. torch.float32, the default, computes in
the parameters' dtype, as a plain torch layer does (float64 too, after
`.to(torch.float64)`). torch.bfloat16 casts where Flax's Conv and Dense with
dtype=bfloat16 cast: the input, the weight (the spectral norm's W / sigma,
computed in fp32) and the bias go to bf16 and the bias is added after the op,
in bf16. Parameters stay fp32, and so do the power iteration and BatchNorm,
which upcasts a bf16 input and returns fp32, as Flax's BatchNorm with
dtype=float32 does.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

SQRT2 = math.sqrt(2.0)
_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]
BN_MOMENTUM = 0.99  # Flax's: running = 0.99 * running + 0.01 * batch statistic
BN_EPS = 1e-5
SN_EPS = 1e-12


def variance_scaling_(weight, scale=1.0, fan_in=None, generator=None):
    """Flax's variance_scaling(scale, "fan_in", "truncated_normal") in place
    (scale 1: lecun_normal, Flax's default kernel initialiser); fan_in
    defaults to weight[0].numel(), a conv's or dense layer's."""
    fan_in = weight[0].numel() if fan_in is None else fan_in
    std = math.sqrt(scale / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=generator)


def upcast(x):
    """A bf16 tensor in fp32; any other as it is (fp32, or float64 in the
    tests' float64 runs)."""
    return x.float() if x.dtype == torch.bfloat16 else x


def in_dtype(op, x, weight, bias, dtype, *args):
    """op(x, weight, bias, *args) at the compute dtype (module docstring)."""
    if dtype == torch.float32:
        return op(x, weight, bias, *args)
    y = op(x.to(dtype), weight.to(dtype), None, *args)
    return y if bias is None else y + bias.to(dtype).view(-1, *(1,) * (y.ndim - 2))


def _l2n(x):
    return x * torch.rsqrt((x * x).sum() + SN_EPS)


def upsample_nearest_2x(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def avg_pool_2x(x):
    return F.avg_pool2d(x, 2)


def global_sum_pool(x):
    return x.sum(dim=(2, 3))


class _SpectralNorm(nn.Module):
    """The weight, bias and power-iteration state shared by SNConv2d and
    SNLinear; subclasses apply `normalized_weight(update_stats)`."""

    def _init_sn(self, shape, gain, bias, device, dtype):
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(shape, device=device))
        nn.init.xavier_uniform_(self.weight, gain=gain)
        self.bias = nn.Parameter(torch.zeros(shape[0], device=device)) if bias else None
        self.register_buffer("weight_u", torch.randn(shape[0], device=device))

    def power_iteration(self):
        """(u', sigma) of one power iteration from the stored u; sigma keeps
        the weight's gradient."""
        w = self.weight.reshape(self.weight.shape[0], -1)
        with torch.no_grad():
            v = _l2n(self.weight_u @ w)
        wv = w @ v
        u = _l2n(wv.detach())
        return u, torch.dot(u, wv)

    def normalized_weight(self, update_stats=False):
        u, sigma = self.power_iteration()
        if update_stats:
            with torch.no_grad():
                self.weight_u.copy_(u)
        return self.weight / torch.where(sigma != 0, sigma, torch.ones_like(sigma))


class SNConv2d(_SpectralNorm):
    def __init__(self, in_ch, out_ch, kernel_size=3, padding=None, bias=True, gain=1.0,
                 device=None, stride=1, dtype=torch.float32):
        super().__init__()
        self.padding = kernel_size // 2 if padding is None else padding  # "SAME" at stride 1
        self.stride = stride
        self._init_sn((out_ch, in_ch, kernel_size, kernel_size), gain, bias, device, dtype)

    def forward(self, x, update_stats=False):
        return in_dtype(F.conv2d, x, self.normalized_weight(update_stats), self.bias, self.dtype,
                        self.stride, self.padding)


class SNLinear(_SpectralNorm):
    def __init__(self, in_features, out_features, bias=True, gain=1.0, device=None,
                 dtype=torch.float32):
        super().__init__()
        self._init_sn((out_features, in_features), gain, bias, device, dtype)

    def forward(self, x, update_stats=False):
        return in_dtype(F.linear, x, self.normalized_weight(update_stats), self.bias, self.dtype)


class Conv2d(nn.Conv2d):
    """nn.Conv2d (zero padding mode) at a compute dtype (module docstring)."""

    def __init__(self, *args, dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.dtype = dtype

    def forward(self, x):
        return in_dtype(F.conv2d, x, self.weight, self.bias, self.dtype, self.stride,
                        self.padding, self.dilation, self.groups)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d at a compute dtype (module docstring)."""

    def __init__(self, *args, dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.dtype = dtype

    def forward(self, x):
        return in_dtype(F.conv_transpose2d, x, self.weight, self.bias, self.dtype, self.stride,
                        self.padding, self.output_padding, self.groups, self.dilation)


class Linear(nn.Linear):
    """nn.Linear at a compute dtype (module docstring)."""

    def __init__(self, *args, dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.dtype = dtype

    def forward(self, x):
        return in_dtype(F.linear, x, self.weight, self.bias, self.dtype)


def conv2d(in_ch, out_ch, kernel_size, gain, device=None, dtype=torch.float32):
    """A plain conv with "SAME" padding, Xavier-uniform weight and zero bias."""
    conv = Conv2d(in_ch, out_ch, kernel_size, padding=kernel_size // 2, device=device,
                  dtype=dtype)
    nn.init.xavier_uniform_(conv.weight, gain=gain)
    nn.init.zeros_(conv.bias)
    return conv


def linear(in_features, out_features, gain=1.0, device=None, dtype=torch.float32):
    layer = Linear(in_features, out_features, device=device, dtype=dtype)
    nn.init.xavier_uniform_(layer.weight, gain=gain)
    nn.init.zeros_(layer.bias)
    return layer


class BatchNorm(nn.Module):
    """BatchNorm over NCHW channels or (N, F) features with Flax's semantics
    (module docstring)."""

    def __init__(self, num_features, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean", torch.zeros(num_features, device=device))
        self.register_buffer("running_var", torch.ones(num_features, device=device))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long,
                                                                 device=device))

    def forward(self, x, update_stats=False):
        x = upcast(x)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, BN_EPS)
        if update_stats:
            with torch.no_grad():
                dims = (0,) + tuple(range(2, x.ndim))
                var, mean = torch.var_mean(x, dim=dims, unbiased=False)
                self.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
                self.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1 - BN_MOMENTUM)
                self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, BN_EPS)


class GBlock(nn.Module):
    """BN-ReLU-(up)-conv3x3-BN-ReLU-conv3x3, plus an (up +) 1x1-conv shortcut
    when the block upsamples or changes width (torch-mimicry's b1, c1, b2, c2,
    c_sc)."""

    def __init__(self, in_ch, out_ch, upsample=False, device=None, dtype=torch.float32):
        super().__init__()
        self.upsample = upsample
        self.b1 = BatchNorm(in_ch, device=device)
        self.c1 = conv2d(in_ch, out_ch, 3, SQRT2, device, dtype)
        self.b2 = BatchNorm(out_ch, device=device)
        self.c2 = conv2d(out_ch, out_ch, 3, SQRT2, device, dtype)
        self.c_sc = (conv2d(in_ch, out_ch, 1, 1.0, device, dtype)
                     if in_ch != out_ch or upsample else None)

    def forward(self, x, update_stats=False):
        h = F.relu(self.b1(x, update_stats))
        if self.upsample:
            h = upsample_nearest_2x(h)
        h = self.c1(h)
        h = self.c2(F.relu(self.b2(h, update_stats)))
        sc = upsample_nearest_2x(x) if self.upsample else x
        if self.c_sc is not None:
            sc = self.c_sc(sc)
        return h + sc


class DBlock(nn.Module):
    """ReLU-SNconv3x3-ReLU-SNconv3x3-(pool), plus a 1x1 SNconv (+ pool)
    shortcut when the block downsamples or changes width."""

    def __init__(self, in_ch, out_ch, downsample=False, device=None, dtype=torch.float32):
        super().__init__()
        self.downsample = downsample
        self.c1 = SNConv2d(in_ch, out_ch, 3, gain=SQRT2, device=device, dtype=dtype)
        self.c2 = SNConv2d(out_ch, out_ch, 3, gain=SQRT2, device=device, dtype=dtype)
        self.c_sc = (SNConv2d(in_ch, out_ch, 1, gain=1.0, device=device, dtype=dtype)
                     if in_ch != out_ch or downsample else None)

    def forward(self, x, update_stats=False):
        h = self.c1(F.relu(x), update_stats)
        h = self.c2(F.relu(h), update_stats)
        if self.downsample:
            h = avg_pool_2x(h)
        sc = x
        if self.c_sc is not None:
            sc = self.c_sc(sc, update_stats)
            if self.downsample:
                sc = avg_pool_2x(sc)
        return h + sc


class DBlockOptimized(nn.Module):
    """The first D block: SNconv3x3-ReLU-SNconv3x3-pool, plus a pool + 1x1
    SNconv shortcut."""

    def __init__(self, in_ch, out_ch, device=None, dtype=torch.float32):
        super().__init__()
        self.c1 = SNConv2d(in_ch, out_ch, 3, gain=SQRT2, device=device, dtype=dtype)
        self.c2 = SNConv2d(out_ch, out_ch, 3, gain=SQRT2, device=device, dtype=dtype)
        self.c_sc = SNConv2d(in_ch, out_ch, 1, gain=1.0, device=device, dtype=dtype)

    def forward(self, x, update_stats=False):
        h = self.c2(F.relu(self.c1(x, update_stats)), update_stats)
        h = avg_pool_2x(h)
        return h + self.c_sc(avg_pool_2x(x), update_stats)
