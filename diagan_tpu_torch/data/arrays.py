"""Array-backed dataset container (the port's copy of
diagan_tpu/data/arrays.py).

Replaces the reference's `WeightedDataset` wrapper
(reference diagan-pkg/diagan/datasets/predefined.py:17-27), whose only job
is to make `__getitem__` return `(img, target, weight, index)` so that
per-example logit recording can key by dataset index. Here the dataset
is a plain struct of arrays; *every batch carries its index
array by construction* because batches are gathered from an on-device
array by an index vector (see pipeline.DeviceDataSource), so the 4-tuple
plumbing disappears.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ArrayDataset:
    """A dataset fully materialized as host numpy arrays.

    images: uint8 (N, H, W, C) — raw pixel space.
    targets: int64 (N,) class labels (zeros if the source has none).
    labels: int64 (N,) bias/minority labels (majority=0, minority=1) used by
      the Colored-MNIST / MNIST-FMNIST diagnosis protocols (reference
      color_mnist.py `biased_targets`); zeros when not applicable.
    weights: float64 (N,) per-example resampling weights (uniform = ones).
    """

    images: np.ndarray
    targets: np.ndarray
    labels: np.ndarray
    weights: np.ndarray
    name: str = "dataset"

    def __post_init__(self):
        n = len(self.images)
        assert self.images.dtype == np.uint8, self.images.dtype
        assert self.images.ndim == 4, self.images.shape
        for f in ("targets", "labels", "weights"):
            assert len(getattr(self, f)) == n, f

    def __len__(self):
        return len(self.images)

    @property
    def image_shape(self):
        return self.images.shape[1:]

    @classmethod
    def from_images(cls, images, targets=None, labels=None, weights=None, name="dataset"):
        n = len(images)
        return cls(
            images=np.ascontiguousarray(images, dtype=np.uint8),
            targets=np.zeros(n, np.int64) if targets is None else np.asarray(targets, np.int64),
            labels=np.zeros(n, np.int64) if labels is None else np.asarray(labels, np.int64),
            weights=np.ones(n, np.float64) if weights is None else np.asarray(weights, np.float64),
            name=name,
        )
