"""Dataset dispatch: name -> built ArrayDataset (counterpart of
diagan_tpu/data/predefined.py).

celeba carries its attributes as `ds.attrs` (int8 [N, 40] in {-1, +1};
zeros without list_attr_celeba.txt); color_mnist and mnist_fmnist take
major_ratio, num_data, size and seed, 25gaussian n_samples and seed, as
keyword arguments.
"""
from __future__ import annotations

import numpy as np

from diagan_tpu_torch.data.arrays import ArrayDataset
from diagan_tpu_torch.data.color_mnist import build_colored_mnist
from diagan_tpu_torch.data.gaussian import GaussianDataset
from diagan_tpu_torch.data.mnist_fmnist import build_mnist_fmnist
from diagan_tpu_torch.data.sources import load_celeba, load_cifar10


def get_predefined_dataset(dataset_name, root, weights=None, **kwargs):
    if dataset_name == "cifar10":
        images, targets = load_cifar10(root, train=True)
        ds = ArrayDataset.from_images(images, targets=targets, name="cifar10")
    elif dataset_name == "celeba":
        images, attrs = load_celeba(root, size=64)
        ds = ArrayDataset.from_images(images, name="celeba")
        ds.attrs = attrs
    elif dataset_name == "color_mnist":
        ds = build_colored_mnist(root, **kwargs)
    elif dataset_name == "mnist_fmnist":
        ds = build_mnist_fmnist(root, **kwargs)
    elif dataset_name == "25gaussian":
        ds = GaussianDataset.build(**kwargs)
    elif dataset_name == "ffhq":
        from diagan_tpu_torch.data.ffhq import load_ffhq

        images = load_ffhq(root, size=kwargs.get("size", 256))
        ds = ArrayDataset.from_images(np.asarray(images), name="ffhq")
    else:
        raise ValueError(f"unknown dataset: {dataset_name}")
    if weights is not None:
        ds.weights = np.asarray(weights, np.float64)
    return ds
