"""SNGAN ResNet generators and discriminators, 32 px and 64 px (counterpart
of diagan_tpu/models/sngan.py), with torch-mimicry's module names:

  Generator32:  l1 (z(128) -> 4*4*ngf), block2..block4 (GBlock, up), b5 (BN),
                c5 (conv3x3 -> 3), tanh; ngf 256
  Discriminator32: block1 (DBlockOptimized, ndf), block2 (DBlock, down),
                block3, block4 (DBlock), ReLU, global sum pool, l5 (SN
                linear -> 1); ndf 128
  Generator64:  l1 (z -> 4*4*ngf), block2..block5 (GBlock, up, widths
                ngf/2 .. ngf/16), b6, c6, tanh; ngf 1024
  Discriminator64: block1 (DBlockOptimized, ndf/16), block2..block5 (DBlock,
                down, ndf/8 .. ndf), ReLU, global sum pool, l6; ndf 1024

so diagan_tpu/utils/mimicry_import.py reads their state_dicts. l1's output
is reshaped channels first, (N, ngf, 4, 4), as in torch-mimicry (the Flax
generator reshapes (N, 4, 4, ngf); utils/jax_params.py permutes between them).

Images cross the module boundary NHWC, as the JAX package's and the port's
StyleGAN2 modules take them: G returns (N, H, W, 3) in [-1, 1] (a view of its
NCHW output) and D takes (N, H, W, 3). D returns (logits (N,), {"features":
(N, C) pooled features, "local": (N, h, w, C) last block after ReLU}).

Train mode (module.train()) runs G's BatchNorms on batch statistics;
update_stats=True also advances their running statistics (G) or the spectral
norms' u (D). Eval mode uses the running statistics; D's layers still run
their power iteration, and store nothing unless update_stats is true.
fp32 only (the JAX package's bf16 option is not in the port yet).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from diagan_tpu_torch.device import resolve_device
from diagan_tpu_torch.models.layers import (
    BatchNorm,
    DBlock,
    DBlockOptimized,
    GBlock,
    SNLinear,
    conv2d,
    global_sum_pool,
    linear,
)


class _SNGANGenerator(nn.Module):
    def __init__(self, nz, ngf, widths, bottom_width, device):
        super().__init__()
        device = resolve_device(device)
        self.nz, self.ngf, self.bottom_width = nz, ngf, bottom_width
        self.l1 = linear(nz, bottom_width * bottom_width * ngf, device=device)
        ins = [ngf, *widths[:-1]]
        self.blocks = [f"block{k + 2}" for k in range(len(widths))]
        for name, cin, cout in zip(self.blocks, ins, widths):
            self.add_module(name, GBlock(cin, cout, upsample=True, device=device))
        top = len(widths) + 2
        self.bn_name, self.conv_name = f"b{top}", f"c{top}"
        self.add_module(self.bn_name, BatchNorm(widths[-1], device=device))
        self.add_module(self.conv_name, conv2d(widths[-1], 3, 3, 1.0, device))

    def forward(self, z, update_stats=False):
        b = self.bottom_width
        h = self.l1(z).view(-1, self.ngf, b, b)
        for name in self.blocks:
            h = getattr(self, name)(h, update_stats)
        h = F.relu(getattr(self, self.bn_name)(h, update_stats))
        return torch.tanh(getattr(self, self.conv_name)(h)).permute(0, 2, 3, 1)


class _SNGANDiscriminator(nn.Module):
    def __init__(self, widths, downsample, device):
        super().__init__()
        device = resolve_device(device)
        self.block1 = DBlockOptimized(3, widths[0], device=device)
        self.blocks = ["block1"]
        for k, (cin, cout, down) in enumerate(zip(widths, widths[1:], downsample)):
            self.blocks.append(f"block{k + 2}")
            self.add_module(self.blocks[-1], DBlock(cin, cout, downsample=down, device=device))
        self.head_name = f"l{len(widths) + 1}"
        self.add_module(self.head_name, SNLinear(widths[-1], 1, gain=1.0, device=device))

    def forward(self, x, update_stats=False):
        h = x.permute(0, 3, 1, 2).contiguous()
        for name in self.blocks:
            h = getattr(self, name)(h, update_stats)
        local = F.relu(h)
        feat = global_sum_pool(local)
        logits = getattr(self, self.head_name)(feat, update_stats)
        return logits.squeeze(-1), {"features": feat, "local": local.permute(0, 2, 3, 1)}


class SNGANGenerator32(_SNGANGenerator):
    def __init__(self, nz=128, ngf=256, bottom_width=4, device="cuda"):
        super().__init__(nz, ngf, [ngf] * 3, bottom_width, device)


class SNGANDiscriminator32(_SNGANDiscriminator):
    def __init__(self, ndf=128, device="cuda"):
        super().__init__([ndf] * 4, [True, False, False], device)


class SNGANGenerator64(_SNGANGenerator):
    def __init__(self, nz=128, ngf=1024, bottom_width=4, device="cuda"):
        super().__init__(nz, ngf, [ngf >> k for k in range(1, 5)], bottom_width, device)


class SNGANDiscriminator64(_SNGANDiscriminator):
    def __init__(self, ndf=1024, device="cuda"):
        super().__init__([ndf >> k for k in (4, 3, 2, 1, 0)], [True] * 4, device)
