"""MNIST-FMNIST (MixedMNIST): majority MNIST digits and a minority of
FashionMNIST items (the port's copy of diagan_tpu/data/mnist_fmnist.py).

`major_ratio` of `num_data` examples come from MNIST (mixed label 0), the
rest from FashionMNIST (mixed label 1); shuffled and cached under
`{root}/mnist_fmnist-{major_ratio}-n{num_data}/{data,targets,
mixed_targets}.pkl`, the JAX package's layout and numpy draws. Images stay
grayscale: (N, 32, 32, 1) after the resize.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from diagan_tpu_torch.data.arrays import ArrayDataset
from diagan_tpu_torch.data.sources import load_fmnist, load_mnist
from diagan_tpu_torch.data.transform import resize_center_crop


def build_mnist_fmnist(root, major_ratio=0.9, num_data=60000, size=32, seed=None,
                       fmnist_root=None) -> ArrayDataset:
    root = Path(root)
    cache = root / f"mnist_fmnist-{major_ratio}-n{num_data}"
    if cache.is_dir():
        with open(cache / "data.pkl", "rb") as f:
            data = np.asarray(pickle.load(f), dtype=np.uint8)
        with open(cache / "targets.pkl", "rb") as f:
            targets = np.asarray(pickle.load(f))
        with open(cache / "mixed_targets.pkl", "rb") as f:
            mixed = np.asarray(pickle.load(f))
    else:
        rng = np.random.default_rng(seed)
        mnist_imgs, mnist_targets = load_mnist(root, train=True)
        fmnist_imgs, fmnist_targets = load_fmnist(fmnist_root or root, train=True)

        num_major = int(num_data * major_ratio)
        num_minor = num_data - num_major
        data = np.concatenate([mnist_imgs[:num_major], fmnist_imgs[:num_minor]])
        targets = np.concatenate([mnist_targets[:num_major], fmnist_targets[:num_minor]])
        mixed = np.concatenate([np.zeros(num_major, np.int64), np.ones(num_minor, np.int64)])
        order = rng.permutation(num_data)
        data, targets, mixed = data[order], targets[order], mixed[order]

        cache.mkdir(parents=True, exist_ok=True)
        for name, arr in (("data", data), ("targets", targets), ("mixed_targets", mixed)):
            with open(cache / f"{name}.pkl", "wb") as f:
                pickle.dump(arr, f)

    data = resize_center_crop(data, size)
    if data.ndim == 3:
        data = data[..., None]
    return ArrayDataset.from_images(data, targets=targets, labels=mixed, name="mnist_fmnist")
