"""Small classifiers for the bias-probe tooling and the CelebA attribute
study (counterpart of diagan_tpu/models/convnets.py).

  SimpleConvNet: conv0..conv3 (k x k, SAME, widths 16/32/64/128, each with
                 bn0..bn3 and ReLU), global mean pool, fc; returns (logits,
                 L2-normalised features, + 1e-8)
  SimpleNet:     fc0..fc2 (Dense dim + ReLU) on the flattened input, fc3
                 head; returns (logits, last hidden)
  AttrClassifier: four VGG-style stages of two 3x3 conv + BN + ReLU
                 (conv0..conv7, bn0..bn7, widths 64/128/256/512), each
                 followed by a 2x2 max pool (VALID, floor), global mean
                 pool, fc1 (512) + ReLU, dropout 0.5, fc2 head; returns
                 (logits, pooled features)
  Simple3DNet:   SimpleConvNet with kernel 3

Images cross the module boundary NHWC, as the port's SNGAN and StyleGAN2
modules take them; SimpleNet flattens its input as given, so its first
layer sees the JAX package's NHWC order and its weights need no permutation.

Flax's semantics, not torch's: BatchNorm is models/layers.py's (momentum
0.99, eps 1e-5, biased running variance), and in train mode (module.train())
every forward normalises by the batch statistics and advances the running
ones, as a Flax apply with mutable batch_stats does; eval mode uses the
running statistics. Dropout keeps a unit with probability 0.5 and scales it
by 2; AttrClassifier.forward takes the keep mask (bool, (N, 512)) so that a
trainer can hold one mask for a whole run (train/classifier.py), and draws a
fresh one from torch's global generator when none is given. Initialisation
as Flax's defaults: truncated-normal variance scaling on fan-in (lecun
normal, scale 1; SimpleConvNet's convs kaiming normal, scale 2), zero biases.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from diagan_tpu_torch.device import resolve_device
from diagan_tpu_torch.models.layers import BatchNorm, variance_scaling_


def _conv(cin, cout, k, scale, device):
    conv = nn.Conv2d(cin, cout, k, padding=k // 2, device=device)
    variance_scaling_(conv.weight, scale)
    nn.init.zeros_(conv.bias)
    return conv


def _dense(cin, cout, device):
    fc = nn.Linear(cin, cout, device=device)
    variance_scaling_(fc.weight, 1.0)
    nn.init.zeros_(fc.bias)
    return fc


class _ConvStack(nn.Module):
    """conv{i} -> bn{i} -> ReLU for each width (and a max pool after every
    `pool_every` of them); forward returns NCHW."""

    def __init__(self, widths, k, scale, pool_every, device, in_ch=3):
        super().__init__()
        self.n, self.pool_every = len(widths), pool_every
        for i, (cin, cout) in enumerate(zip((in_ch, *widths[:-1]), widths)):
            self.add_module(f"conv{i}", _conv(cin, cout, k, scale, device))
            self.add_module(f"bn{i}", BatchNorm(cout, device=device))

    def _stack(self, x):
        x = x.permute(0, 3, 1, 2)
        for i in range(self.n):
            x = getattr(self, f"conv{i}")(x)
            x = F.relu(getattr(self, f"bn{i}")(x, update_stats=self.training))
            if self.pool_every and (i + 1) % self.pool_every == 0:
                x = F.max_pool2d(x, 2, 2)
        return x


class SimpleConvNet(_ConvStack):
    def __init__(self, num_labels=10, kernel_size=7, device="cuda", in_ch=3):
        """`in_ch`: the images' channels (Flax infers them at init; 1 for
        MNIST-FMNIST)."""
        device = resolve_device(device)
        super().__init__((16, 32, 64, 128), kernel_size, 2.0, 0, device, in_ch)
        self.fc = _dense(128, num_labels, device)

    def forward(self, x):
        feat = self._stack(x).mean(dim=(2, 3))
        logits = self.fc(feat)
        return logits, feat / (torch.linalg.vector_norm(feat, dim=-1, keepdim=True) + 1e-8)


class Simple3DNet(SimpleConvNet):
    """SimpleConvNet with kernel 3 (the JAX package's surface-parity class)."""

    def __init__(self, num_labels=10, device="cuda"):
        super().__init__(num_labels=num_labels, kernel_size=3, device=device)


class SimpleNet(nn.Module):
    def __init__(self, in_features, num_labels=10, dim=256, device="cuda"):
        """`in_features` is the flattened input's width (Flax infers it at
        init)."""
        super().__init__()
        device = resolve_device(device)
        for i, cin in enumerate((in_features, dim, dim)):
            self.add_module(f"fc{i}", _dense(cin, dim, device))
        self.fc3 = _dense(dim, num_labels, device)

    def forward(self, x):
        h = x.reshape(x.shape[0], -1)
        for i in range(3):
            h = F.relu(getattr(self, f"fc{i}")(h))
        return self.fc3(h), h


class AttrClassifier(_ConvStack):
    """CelebA attribute classifier (the JAX package's stand-in for the
    reference's torchvision vgg16)."""

    def __init__(self, num_attrs=40, device="cuda"):
        device = resolve_device(device)
        super().__init__((64, 64, 128, 128, 256, 256, 512, 512), 3, 1.0, 2, device)
        self.fc1 = _dense(512, 512, device)
        self.fc2 = _dense(512, num_attrs, device)

    def forward(self, x, dropout_mask=None):
        feat = self._stack(x).mean(dim=(2, 3))
        h = F.relu(self.fc1(feat))
        if self.training:
            if dropout_mask is None:
                dropout_mask = torch.rand(h.shape, device=h.device) < 0.5
            h = torch.where(dropout_mask, h / 0.5, torch.zeros_like(h))
        return self.fc2(h), feat
