"""The DCGAN of Colored-MNIST and MNIST-FMNIST, with PacGAN packing
(counterpart of diagan_tpu/models/mnist_dcgan.py), NCHW inside, in the
reference's torch layout (diagan-pkg/diagan/models/mnist.py:47-223), which
diagan_tpu/utils/torch_import.py reads:

  Generator:     fc (z(100) -> 384), tconv = [ConvTranspose2d 384->192 k4
                 s1 p0, BN, ReLU, ConvTranspose2d ->96 k4 s2 p1, BN, ReLU,
                 ->48, BN, ReLU, ->nc, Tanh] (tconv.{0,3,6,9}, BN at
                 tconv.{1,4,7}); bias-free transposed convs
  Discriminator: conv = six [Conv2d 3x3 (widths 16/32/64/128/256/512,
                 strides 2/1/2/1/2/1, padding 1, bias-free; SNConv2d with
                 use_sn), BN (from the second on), LeakyReLU(0.2),
                 Dropout(0.5)] (conv.{0,3,7,11,15,19}, BN at
                 conv.{4,8,12,16,20}), out_d (Linear over the 512 x 4 x 4
                 CHW flatten -> 1)

Images cross the module boundary NHWC, as the port's other models take them:
G returns (N, 32, 32, nc) in [-1, 1]; D takes (N, 32, 32, nc) and returns
(logits (N,), {"features": (N, 8192) CHW flatten}). PacGAN: D splits the
batch into `num_pack` consecutive chunks and stacks them on channels before
conv.0, so its first conv reads nc x num_pack channels.

The JAX package's semantics, not torch's:
  - a ConvTranspose2d (k4, s2, p1) equals Flax's "SAME" transposed conv up
    to the spatial flip of its kernel (utils/jax_params.py flips it), and
    (k4, s1, p0) on the 1 x 1 input its "VALID" one;
  - D's convs pad (1, 1) on each side, as the JAX D does explicitly
    (mnist_dcgan.py:66-71): torch's window grid, not XLA's stride-2 SAME;
  - BatchNorm is models/layers.py's (Flax's momentum 0.99, biased running
    variance): train mode normalises by the batch statistics and moves the
    running ones only with update_stats; eval mode uses the running ones;
  - initialisation N(0, 0.02) for every weight and every BN scale, zero
    biases (SNConv2d: Xavier-uniform, gain 1, as the JAX SNConv);
  - dropout keeps a unit with probability 0.5 and scales it by 2, in train
    mode only. forward takes the six keep masks (bool, NCHW, the shapes
    `dropout_shapes` gives) so that a step can hand the same masks to every
    D forward of an iteration, as the JAX step's one dropout key does; with
    none it draws fresh ones from torch's global generator;
  - dtype=torch.bfloat16 (get_gan_model(..., bf16=True)) runs the convs,
    transposed convs and G's fc in bf16 (models/layers.py), as the JAX
    package's dtype does; the parameters, BatchNorm (and what follows it up
    to the next conv), D's flatten and head, and G's images stay fp32.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from diagan_tpu_torch.device import resolve_device
from diagan_tpu_torch.models.layers import (
    BatchNorm,
    Conv2d,
    ConvTranspose2d,
    Linear,
    SNConv2d,
    upcast,
)

INIT_STD = 0.02
D_SPECS = ((16, 2), (32, 1), (64, 2), (128, 1), (256, 2), (512, 1))  # (width, stride)
IMAGE_SIZE = 32


def _normal_(*tensors):
    for t in tensors:
        nn.init.normal_(t, 0.0, INIT_STD)


def _bn(width, device):
    bn = BatchNorm(width, device=device)
    _normal_(bn.weight)
    return bn


def _apply(layer, h, update_stats):
    if isinstance(layer, (BatchNorm, SNConv2d)):
        return layer(h, update_stats)
    if isinstance(layer, nn.Tanh):  # images leave G in fp32 whatever the compute dtype
        return layer(upcast(h))
    return layer(h)


class MNISTDCGANGenerator(nn.Module):
    def __init__(self, nz=100, nc=3, device="cuda", dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.nz = nz
        self.fc = Linear(nz, 384, device=device, dtype=dtype)
        _normal_(self.fc.weight)
        nn.init.zeros_(self.fc.bias)
        layers = []
        for cin, cout, stride, pad in ((384, 192, 1, 0), (192, 96, 2, 1), (96, 48, 2, 1)):
            layers += [ConvTranspose2d(cin, cout, 4, stride, pad, bias=False, device=device,
                                       dtype=dtype),
                       _bn(cout, device), nn.ReLU()]
        layers += [ConvTranspose2d(48, nc, 4, 2, 1, bias=False, device=device, dtype=dtype),
                   nn.Tanh()]
        self.tconv = nn.Sequential(*layers)
        for layer in self.tconv:
            if isinstance(layer, nn.ConvTranspose2d):
                _normal_(layer.weight)

    def forward(self, z, update_stats=False):
        h = self.fc(z).view(-1, 384, 1, 1)
        for layer in self.tconv:
            h = _apply(layer, h, update_stats)
        return h.permute(0, 2, 3, 1)


class MNISTDCGANDiscriminator(nn.Module):
    def __init__(self, nc=3, num_pack=1, use_sn=False, device="cuda", dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.num_pack = num_pack
        layers, cin = [], nc * num_pack
        for j, (width, stride) in enumerate(D_SPECS):
            if use_sn:
                conv = SNConv2d(cin, width, 3, padding=1, bias=False, gain=1.0, device=device,
                                stride=stride, dtype=dtype)
            else:
                conv = Conv2d(cin, width, 3, stride, 1, bias=False, device=device, dtype=dtype)
                _normal_(conv.weight)
            layers.append(conv)
            if j > 0:  # the first conv has no BatchNorm (reference mnist.py:163-166)
                layers.append(_bn(width, device))
            layers += [nn.LeakyReLU(0.2), nn.Dropout(0.5)]
            cin = width
        self.conv = nn.Sequential(*layers)
        self.out_d = nn.Linear(512 * 4 * 4, 1, device=device)
        _normal_(self.out_d.weight)
        nn.init.zeros_(self.out_d.bias)

    def dropout_shapes(self, n):
        """The NCHW shapes of the six dropout masks of a forward on n images."""
        shapes, size = [], IMAGE_SIZE
        for width, stride in D_SPECS:
            size = (size - 1) // stride + 1  # 3x3, padding 1
            shapes.append((n // self.num_pack, width, size, size))
        return shapes

    def forward(self, x, update_stats=False, dropout_masks=None):
        if self.num_pack > 1:  # PacGAN (reference mnist.py:213-218)
            n = x.shape[0] // self.num_pack
            x = torch.cat([x[i * n:(i + 1) * n] for i in range(self.num_pack)], dim=-1)
        h = x.permute(0, 3, 1, 2)
        masks = iter(dropout_masks) if dropout_masks is not None else None
        for layer in self.conv:
            if not isinstance(layer, nn.Dropout):
                h = _apply(layer, h, update_stats)
            elif self.training:
                keep = next(masks) if masks is not None else torch.rand_like(h) < 0.5
                h = torch.where(keep, h / 0.5, torch.zeros((), dtype=h.dtype, device=h.device))
        feat = upcast(h.flatten(1))
        return self.out_d(feat).squeeze(-1), {"features": feat}
