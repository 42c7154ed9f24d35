"""Convolutional autoencoders of the reconstruction-error protocol
(counterpart of diagan_tpu/models/cae.py), NCHW inside; images cross the
module boundary NHWC in [-1, 1], as the port's other models take them.

CAE32: three stages of [conv 3x3 stride 2, BatchNorm, ReLU] (widths
64/128/256, 32 -> 4 px), a dense layer to a 256-d tanh code, and the mirrored
decoder: dense to top_nf x 4 x 4, BatchNorm, ReLU, transposed convs 3x3
stride 2 with BatchNorm and ReLU (128, 64), a last transposed conv to nc and
tanh. CAE64 has a fourth stage (512; 64 -> 4 px).

The JAX package's (Flax's) semantics, not torch's usual forms:
  - the encoder's stride-2 "SAME" conv on an even input pads (0, 1): one
    zero row and column after the image, none before (XLA's split of the
    total padding of 1). torch's padding=1 would shift the window grid by a
    pixel;
  - Flax's "SAME" transposed conv (k 3, stride 2) is torch's
    conv_transpose2d with padding 0 and its (2H + 1)-px output cropped to
    the top-left 2H x 2W, with the kernel flipped in both spatial axes
    (utils/jax_params.py cae_state_dict flips it). torch's padding=1,
    output_padding=1 form is one pixel off;
  - the encoder flattens, and the decoder reshapes, in torch's (C, H, W)
    order; the weight bridge permutes the JAX package's (H, W, C) rows and
    columns instead. The decoder's first BatchNorm normalises the dense
    output per feature (4096 for CAE32, 8192 for CAE64) before the reshape,
    so the bridge permutes its parameters and statistics with them;
  - BatchNorm is models/layers.py's (momentum 0.99, biased running
    variance, eps 1e-5). Every train-mode forward moves the running
    statistics, as the JAX train_cae applies the CAE with its batch_stats
    mutable; eval mode uses them;
  - initialisation as Flax's defaults: conv, transposed-conv and dense
    kernels lecun-normal (a normal truncated at 2 sigma, variance
    1 / fan_in), zero biases, BatchNorm scale 1 and bias 0, drawn on the CPU
    from a torch.Generator seeded with `seed` (a run's own: the JAX package
    draws other weights from its key).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from diagan_tpu_torch.device import resolve_device
from diagan_tpu_torch.models.layers import BatchNorm, variance_scaling_


def _tconv_same(tconv, h):
    """Flax's "SAME" transposed conv, k 3, stride 2: H -> 2H."""
    return tconv(h)[:, :, :2 * h.shape[2], :2 * h.shape[3]]


class CAE(nn.Module):
    def __init__(self, in_channels=3, rep_dim=256, num_stages=3, nf=64, seed=0,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        widths = [nf * 2**s for s in range(num_stages)]
        self.top_nf = widths[-1]
        self.convs = nn.ModuleList(nn.Conv2d(c_in, c_out, 3, stride=2) for c_in, c_out in
                                   zip([in_channels] + widths[:-1], widths))
        self.bns = nn.ModuleList(BatchNorm(w) for w in widths)
        self.fc_enc = nn.Linear(self.top_nf * 16, rep_dim)
        self.fc_dec = nn.Linear(rep_dim, self.top_nf * 16)
        self.bn_dec = BatchNorm(self.top_nf * 16)
        up = widths[::-1]  # top_nf, ..., nf
        self.tconvs = nn.ModuleList(nn.ConvTranspose2d(c_in, c_out, 3, stride=2)
                                    for c_in, c_out in zip(up[:-1], up[1:]))
        self.tbns = nn.ModuleList(BatchNorm(w) for w in up[1:])
        self.tconv_out = nn.ConvTranspose2d(nf, in_channels, 3, stride=2)
        g = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                kh_kw = m.weight[0, 0].numel() if m.weight.ndim == 4 else 1
                c_in = m.in_channels if m.weight.ndim == 4 else m.in_features
                variance_scaling_(m.weight, fan_in=c_in * kh_kw, generator=g)
                nn.init.zeros_(m.bias)
        self.to(device)

    def encode(self, x):
        h = x.permute(0, 3, 1, 2)
        for conv, bn in zip(self.convs, self.bns):
            h = F.relu(bn(conv(F.pad(h, (0, 1, 0, 1))), self.training))
        return torch.tanh(self.fc_enc(h.flatten(1)))

    def decode(self, rep):
        h = F.relu(self.bn_dec(self.fc_dec(rep), self.training))
        h = h.view(-1, self.top_nf, 4, 4)
        for tconv, bn in zip(self.tconvs, self.tbns):
            h = F.relu(bn(_tconv_same(tconv, h), self.training))
        return torch.tanh(_tconv_same(self.tconv_out, h)).permute(0, 2, 3, 1)

    def forward(self, x):
        return self.decode(self.encode(x))


def CAE32(in_channels=3, rep_dim=256, seed=0, device="cuda"):
    return CAE(in_channels, rep_dim, num_stages=3, seed=seed, device=device)


def CAE64(in_channels=3, rep_dim=256, seed=0, device="cuda"):
    return CAE(in_channels, rep_dim, num_stages=4, seed=seed, device=device)


def get_ae_model(dataset_name, in_channels=3, seed=0, device="cuda"):
    """Dataset -> CAE (reference auto_encoder.py:201-206): cifar10 and
    color_mnist CAE32 with `in_channels`, mnist_fmnist CAE32 with one
    channel, celeba CAE64."""
    if dataset_name in ("cifar10", "color_mnist", "mnist_fmnist"):
        nc = 1 if dataset_name == "mnist_fmnist" else in_channels
        return CAE32(nc, seed=seed, device=device)
    if dataset_name == "celeba":
        return CAE64(in_channels, seed=seed, device=device)
    raise ValueError(dataset_name)
