"""25-Gaussians toy dataset (the port's copy of diagan_tpu/data/gaussian.py).

A 5 x 5 grid of Gaussians at spacing 2 with sigma 0.05, n points in all,
grid label 5 (x + 2) + (y + 2), shuffled and scaled by 1 / 2.828: the JAX
package's RandomState draws, so both packages build the same float32 points.
"""
from __future__ import annotations

import numpy as np

from diagan_tpu_torch.data.arrays import ArrayDataset


def build_25gaussian(n_samples=10000, seed=1):
    """Returns (points float32 [n, 2], labels int64 [n])."""
    rng = np.random.RandomState(seed)
    pts, labels = [], []
    for _ in range(n_samples // 25):
        for x in range(-2, 3):
            for y in range(-2, 3):
                p = rng.randn(2) * 0.05
                p[0] += 2 * x
                p[1] += 2 * y
                pts.append(p)
                labels.append(5 * (x + 2) + (y + 2))
    pts = np.asarray(pts, np.float32)
    labels = np.asarray(labels, np.int64)
    order = rng.permutation(len(pts))
    return pts[order] / 2.828, labels[order]


class GaussianDataset(ArrayDataset):
    """ArrayDataset holding float32 points (N, 2) in place of uint8 images;
    data.pipeline.DeviceDataSource gathers them as they are."""

    def __post_init__(self):  # no uint8 / 4-D invariant
        assert self.images.ndim == 2

    @classmethod
    def build(cls, n_samples=10000, seed=1):
        pts, labels = build_25gaussian(n_samples, seed)
        return cls(images=pts, targets=labels, labels=np.zeros(len(pts), np.int64),
                   weights=np.ones(len(pts), np.float64), name="25gaussian")
