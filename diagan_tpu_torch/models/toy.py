"""MLP generator and discriminator of the 25-Gaussians toy (counterpart of
diagan_tpu/models/toy.py; reference diagan-pkg/diagan/models/toy.py:27-66):

  ToyGenerator:     fc0..fc2 (Linear -> 256, ReLU), fc3 (-> nc = 2)
  ToyDiscriminator: fc0..fc2 (Linear -> 256, ReLU; SNLinear with use_sn),
                    fc3 (Linear -> 1); returns (logits (N,), {"features":
                    (N, 256) last hidden})

Weights N(0, 0.02) and zero biases, as the JAX package's (SNLinear:
Xavier-uniform, gain 1, as its SNDense). No BatchNorm or dropout, so train
and eval mode are one forward; update_stats only stores the spectral norms'
u (models/layers.py).
"""
from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from diagan_tpu_torch.device import resolve_device
from diagan_tpu_torch.models.layers import SNLinear

INIT_STD = 0.02


def _linear(cin, cout, device):
    layer = nn.Linear(cin, cout, device=device)
    nn.init.normal_(layer.weight, 0.0, INIT_STD)
    nn.init.zeros_(layer.bias)
    return layer


class ToyGenerator(nn.Module):
    def __init__(self, nz=2, nc=2, dim=256, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.nz = nz
        for i, cin in enumerate((nz, dim, dim)):
            self.add_module(f"fc{i}", _linear(cin, dim, device))
        self.fc3 = _linear(dim, nc, device)

    def forward(self, z, update_stats=False):
        h = z
        for i in range(3):
            h = F.relu(getattr(self, f"fc{i}")(h))
        return self.fc3(h)


class ToyDiscriminator(nn.Module):
    def __init__(self, nc=2, dim=256, use_sn=False, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.use_sn = use_sn
        for i, cin in enumerate((nc, dim, dim)):
            layer = (SNLinear(cin, dim, gain=1.0, device=device) if use_sn
                     else _linear(cin, dim, device))
            self.add_module(f"fc{i}", layer)
        self.fc3 = _linear(dim, 1, device)

    def forward(self, x, update_stats=False):
        h = x
        for i in range(3):
            layer = getattr(self, f"fc{i}")
            h = F.relu(layer(h, update_stats) if self.use_sn else layer(h))
        return self.fc3(h).squeeze(-1), {"features": h}
