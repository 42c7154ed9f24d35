"""Colored-MNIST (BiasedMNIST), the paper's controlled minority benchmark
(the port's copy of diagan_tpu/data/color_mnist.py).

Take the first `num_data` MNIST digits, binarise them (pixel != 0), colour
a random `major_ratio` share red [255, 0, 0] (bias label 0) and the rest
green [0, 255, 0] (bias label 1), shuffle, and cache the result as pickles
under `{root}/color_mnist-rd{major_ratio}-n{num_data}/{data,targets,
biased_targets}.pkl`: the JAX package's (and the reference's) cache layout
and numpy draws, so a cache either package builds loads in the other.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from diagan_tpu_torch.data.arrays import ArrayDataset
from diagan_tpu_torch.data.sources import load_mnist
from diagan_tpu_torch.data.transform import resize_center_crop

COLOUR_MAP = np.array([[255, 0, 0], [0, 255, 0]], dtype=np.uint8)


def build_colored_mnist(root, major_ratio=0.99, num_data=10000, size=32,
                        seed=None) -> ArrayDataset:
    root = Path(root)
    cache = root / f"color_mnist-rd{major_ratio}-n{num_data}"
    if cache.is_dir():
        with open(cache / "data.pkl", "rb") as f:
            data = np.asarray(pickle.load(f), dtype=np.uint8)
        with open(cache / "targets.pkl", "rb") as f:
            targets = np.asarray(pickle.load(f))
        with open(cache / "biased_targets.pkl", "rb") as f:
            biased = np.asarray(pickle.load(f))
    else:
        rng = np.random.default_rng(seed)
        digits, targets_all = load_mnist(root, train=True)
        digits, targets_all = digits[:num_data], targets_all[:num_data]

        perm = rng.permutation(num_data)
        bias = np.ones(num_data, np.int64)
        bias[perm[:int(num_data * major_ratio)]] = 0

        binary = (digits != 0).astype(np.uint8)[..., None]  # (N, 28, 28, 1)
        data = binary * COLOUR_MAP[bias][:, None, None, :]
        order = rng.permutation(num_data)
        data, targets, biased = data[order], targets_all[order], bias[order]

        cache.mkdir(parents=True, exist_ok=True)
        for name, arr in (("data", data), ("targets", targets), ("biased_targets", biased)):
            with open(cache / f"{name}.pkl", "wb") as f:
                pickle.dump(arr, f)

    data = resize_center_crop(data, size)
    return ArrayDataset.from_images(data, targets=targets, labels=biased, name="color_mnist")
