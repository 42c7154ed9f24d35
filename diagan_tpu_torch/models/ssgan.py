"""SSGAN: the SNGAN backbone plus a 4-way rotation head (counterpart of
diagan_tpu/models/ssgan.py), in torch-mimicry's layout.

The discriminators are the port's SNGANDiscriminator{32,64} with the head
`l_y` (SNLinear C -> 4, Xavier gain 1) over the pooled features, so that
diagan_tpu/utils/mimicry_import.py reads their state_dicts (the backbone's
keys as SNGAN's, plus l_y.*). D returns (logits, aux) with
aux["ss_logits"] (N, 4) beside SNGAN's aux. The head runs in fp32 whatever
the backbone's compute dtype, as in the JAX package. D classifies the
rotation of real images (loss scale 1.0) and G adds the rotation loss on
its fakes (0.2): train/steps.py. The generators are SNGAN's.
"""
from __future__ import annotations

import torch

from diagan_tpu_torch.device import resolve_device
from diagan_tpu_torch.models.layers import SNLinear
from diagan_tpu_torch.models.sngan import (
    SNGANDiscriminator32,
    SNGANDiscriminator64,
    SNGANGenerator32,
    SNGANGenerator64,
)

SS_LOSS_SCALE_D = 1.0
SS_LOSS_SCALE_G = 0.2
NUM_ROTATIONS = 4

SSGANGenerator32 = SNGANGenerator32
SSGANGenerator64 = SNGANGenerator64


class _RotationHead:
    def _add_head(self, width, device):
        self.l_y = SNLinear(width, NUM_ROTATIONS, gain=1.0, device=resolve_device(device))

    def forward(self, x, update_stats=False):
        logits, aux = super().forward(x, update_stats)
        aux["ss_logits"] = self.l_y(aux["features"], update_stats)
        return logits, aux


class SSGANDiscriminator32(_RotationHead, SNGANDiscriminator32):
    def __init__(self, ndf=128, device="cuda", dtype=torch.float32):
        super().__init__(ndf, device, dtype)
        self._add_head(ndf, device)


class SSGANDiscriminator64(_RotationHead, SNGANDiscriminator64):
    def __init__(self, ndf=1024, device="cuda", dtype=torch.float32):
        super().__init__(ndf, device, dtype)
        self._add_head(ndf, device)
