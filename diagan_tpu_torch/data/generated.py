"""Generated-image dataset (counterpart of diagan_tpu/data/generated.py):
pickled uint8 samples from a (DRS-wrapped) G, consumed by the CAE
reconstruction-error protocol.

The pickle holds one uint8 (N, H, W, C) numpy array in [0, 255], as the JAX
package and the reference write it (reference diagan/datasets/generated.py:
10-38, train_cae.py:96-110); a pickle the JAX package wrote is the same
bytes. load_generated also takes an NCHW pickle.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from diagan_tpu_torch.data.arrays import ArrayDataset


def save_generated(path, images_uint8: np.ndarray):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(np.ascontiguousarray(images_uint8, dtype=np.uint8), f)


def load_generated(path) -> ArrayDataset:
    with open(path, "rb") as f:
        images = pickle.load(f)
    images = np.asarray(images, dtype=np.uint8)
    if images.ndim == 4 and images.shape[1] in (1, 3) and images.shape[-1] not in (1, 3):
        images = images.transpose(0, 2, 3, 1)  # an NCHW pickle
    return ArrayDataset.from_images(images, name="generated")
