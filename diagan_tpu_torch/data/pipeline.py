"""Device-resident input pipeline (counterpart of diagan_tpu/data/pipeline.py).

The whole dataset lives on the device as uint8 (CIFAR-10: 150 MB), and a
batch is a gather and a dequantize in fp32:

    batch = images[idx].float() / 127.5 - 1

the JAX package's formula, with the bits of its eager form (jitted on the
CPU, XLA rounds 205 of the 256 codes one ulp away from this division). The
25-Gaussians toy set holds float32 points (N, 2), which a batch gathers as
they are (`quantized` False, as the JAX source's `_quantized`). Indices
are drawn on the device from an explicit torch.Generator: uniform with
replacement, or, with weights, with replacement in proportion to the
eps-floored weights (data/sampler.py).
"""
from __future__ import annotations

import numpy as np
import torch

from diagan_tpu_torch.data.sampler import (
    sample_uniform_indices,
    sample_weighted_indices,
    weights_from_scores,
)
from diagan_tpu_torch.device import resolve_device


class DeviceDataSource:
    """Whole-dataset-on-the-device batch source.

    images: uint8 (N, H, W, C) tensor on the device, or float32 (N, D)
    points. weights: float32 (N,) tensor of eps-floored resampling weights,
    or None for uniform draws."""

    def __init__(self, dataset, weights=None, eps=1e-6, device="cuda"):
        self.device = resolve_device(device)
        self.dataset = dataset
        imgs = np.asarray(dataset.images)
        self.quantized = imgs.dtype == np.uint8
        if not self.quantized and imgs.dtype != np.float32:
            raise ValueError(f"DeviceDataSource takes uint8 images or float32 points, "
                             f"got {imgs.dtype}")
        self.images = torch.from_numpy(np.ascontiguousarray(imgs)).to(self.device)
        self.num_data = len(dataset)
        self.weights = (weights_from_scores(weights, self.device, eps=eps)
                        if weights is not None else None)

    def sample_indices(self, n, generator):
        if self.weights is None:
            return sample_uniform_indices(self.num_data, n, generator, self.device)
        return sample_weighted_indices(self.weights, n, generator)

    def gather(self, idx):
        """Gather and dequantize to [-1, 1] fp32, NHWC (points as they are)."""
        batch = self.images[idx]
        return batch.float() / 127.5 - 1.0 if self.quantized else batch
