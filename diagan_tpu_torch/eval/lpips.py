"""LPIPS perceptual distance (Zhang et al. 2018), counterpart of
diagan_tpu/eval/lpips.py.

A VGG16 feature stack (13 3x3 convs, ReLU, 2x2 max pools) tapped after
relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3 (`_TAPS`, the conv indices
1, 3, 6, 9, 12). Inputs in [-1, 1] are shifted and scaled as lpips does;
each tap's features are divided by their channel norm + 1e-10, and the
squared differences are averaged over (H, W, C) without heads, or weighted
by the per-layer linear head, summed over C and averaged over (H, W) with
heads. The per-sample distance is the sum over the five taps.

Weights: `_load_vgg` takes a torchvision VGG16 state_dict file, its 4-d
".weight" tensors and 1-d ".bias" tensors each in the file's key order (as
the JAX package takes them, so the classifier's biases after the 13 conv
biases are ignored); `_load_lins` takes the lpips heads' file, its "weight"
keys in sorted order (lin0.model.1.weight ... lin4). Without a VGG file the
convs are drawn from a torch.Generator seeded with `seed` (lecun-normal
kernels, zero biases), a valid but untrained metric, and `weights_kind`
says "random". The JAX package's random init draws from jax.random, so the
two random metrics differ; utils/jax_params.py lpips_state_dict carries the
JAX variables over.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from diagan_tpu_torch.device import resolve_device

_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512]
# the convs after whose ReLU features are tapped (relu1_2 ... relu5_3)
_TAPS = (1, 3, 6, 9, 12)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPS(nn.Module):
    def __init__(self, weights_path=None, lin_path=None, seed=0, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.convs = nn.ModuleList()
        cin = 3
        for v in _VGG_CFG:
            if v != "M":
                self.convs.append(nn.Conv2d(cin, v, 3, padding=1, device=device))
                cin = v
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for conv in self.convs:
                fan_in = conv.weight[0].numel()
                conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen)
                                  / math.sqrt(fan_in))
                conv.bias.zero_()
        self.register_buffer("shift", torch.tensor(_SHIFT, device=device).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE, device=device).view(1, 3, 1, 1),
                             persistent=False)
        self.weights_kind = "random"
        self.lins = None  # per-layer channel weights; None -> the plain mean
        if weights_path:
            self._load_vgg(weights_path)
        if lin_path:
            self._load_lins(lin_path)
        self.eval()

    def _device(self):
        return self.shift.device

    def _load_vgg(self, path):
        sd = torch.load(path, map_location="cpu", weights_only=False)
        ws = [v for k, v in sd.items() if k.endswith(".weight") and v.ndim == 4]
        bs = [v for k, v in sd.items() if k.endswith(".bias") and v.ndim == 1]
        with torch.no_grad():
            for i, conv in enumerate(self.convs):
                if tuple(ws[i].shape) != tuple(conv.weight.shape):
                    raise ValueError(f"VGG conv {i}: {tuple(ws[i].shape)} in the file, "
                                     f"{tuple(conv.weight.shape)} here")
                conv.weight.copy_(ws[i])
                conv.bias.copy_(bs[i])
        self.weights_kind = "loaded"

    def _load_lins(self, path):
        sd = torch.load(path, map_location="cpu", weights_only=False)
        self.lins = [v.reshape(-1).float().to(self._device())
                     for k, v in sorted(sd.items()) if "weight" in k]

    def features(self, x):
        """The five tapped feature maps of NCHW x (already shifted and scaled)."""
        feats, i = [], 0
        for v in _VGG_CFG:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(self.convs[i](x))
                if i in _TAPS:
                    feats.append(x)
                i += 1
        return feats

    @torch.no_grad()
    def forward(self, x, y):
        """x, y: (N, 3, H, W) tensors in [-1, 1], or the JAX package's (N, H,
        W, 3) numpy arrays (the result is then numpy). Returns the
        per-sample distance (N,)."""
        as_numpy = isinstance(x, np.ndarray)
        if as_numpy:
            x, y = (torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)
                                                          .transpose(0, 3, 1, 2)))
                    .to(self._device()) for a in (x, y))
        fx = self.features((x - self.shift) / self.scale)
        fy = self.features((y - self.shift) / self.scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            a = a / (torch.linalg.vector_norm(a, dim=1, keepdim=True) + 1e-10)
            b = b / (torch.linalg.vector_norm(b, dim=1, keepdim=True) + 1e-10)
            d = (a - b) ** 2
            if self.lins is not None:
                d = d * self.lins[i][None, :, None, None]
                total = total + d.sum(1).mean((1, 2))
            else:
                total = total + d.mean((1, 2, 3))
        return total.cpu().numpy() if as_numpy else total
