"""InfoMax-GAN: the SNGAN backbone plus local and global projectors into an
RKHS of dim `nrkhs` (counterpart of diagan_tpu/models/infomax.py), in
torch-mimicry's layout.

The discriminators are the port's SNGANDiscriminator{32,64} with
  local_nn:  SNConv2d C -> nrkhs, 1x1, over the local map (after its ReLU),
             reshaped (N, h*w, nrkhs) in NHWC (row-major) order;
  global_nn: Sequential(SNLinear C -> nrkhs, ReLU, SNLinear nrkhs -> nrkhs)
             over the pooled features (keys global_nn.0.*, global_nn.2.*),
each layer Xavier gain 1, so that diagan_tpu/utils/mimicry_import.py reads
their state_dicts. Both projections are L2-normalised as x / (|x| + 1e-8)
(not F.normalize, which clamps the norm at eps) into aux["local_proj"]
(N, h*w, nrkhs) and aux["global_proj"] (N, nrkhs). The heads run in fp32
whatever the backbone's compute dtype, as in the JAX package. D and G each
add InfoNCE at scale 0.2: train/steps.py. The generators are SNGAN's.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from diagan_tpu_torch.device import resolve_device
from diagan_tpu_torch.models.layers import SNConv2d, SNLinear
from diagan_tpu_torch.models.sngan import (
    SNGANDiscriminator32,
    SNGANDiscriminator64,
    SNGANGenerator32,
    SNGANGenerator64,
)

INFOMAX_LOSS_SCALE = 0.2

InfoMaxGANGenerator32 = SNGANGenerator32
InfoMaxGANGenerator64 = SNGANGenerator64


def _l2n(x):
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


class _InfoMaxHeads:
    def _add_heads(self, width, nrkhs, device):
        device = resolve_device(device)
        self.local_nn = SNConv2d(width, nrkhs, 1, padding=0, gain=1.0, device=device)
        self.global_nn = nn.Sequential(SNLinear(width, nrkhs, gain=1.0, device=device),
                                       nn.ReLU(),
                                       SNLinear(nrkhs, nrkhs, gain=1.0, device=device))

    def forward(self, x, update_stats=False):
        logits, aux = super().forward(x, update_stats)
        local = self.local_nn(aux["local"].permute(0, 3, 1, 2), update_stats)
        n, d = local.shape[:2]
        lin, relu, lout = self.global_nn
        g = lout(relu(lin(aux["features"], update_stats)), update_stats)
        aux["local_proj"] = _l2n(local.permute(0, 2, 3, 1).reshape(n, -1, d))
        aux["global_proj"] = _l2n(g)
        return logits, aux


class InfoMaxGANDiscriminator32(_InfoMaxHeads, SNGANDiscriminator32):
    def __init__(self, ndf=128, nrkhs=1024, device="cuda", dtype=torch.float32):
        super().__init__(ndf, device, dtype)
        self._add_heads(ndf, nrkhs, device)


class InfoMaxGANDiscriminator64(_InfoMaxHeads, SNGANDiscriminator64):
    def __init__(self, ndf=1024, nrkhs=1024, device="cuda", dtype=torch.float32):
        super().__init__(ndf, device, dtype)
        self._add_heads(ndf, nrkhs, device)
