"""Dataset dispatch: name -> built ArrayDataset (counterpart of
diagan_tpu/data/predefined.py).

cifar10, celeba and ffhq are in the port; celeba carries its attributes as
`ds.attrs` (int8 [N, 40] in {-1, +1}; zeros without list_attr_celeba.txt).
The MNIST families and the 25-Gaussians toy set have no port yet: each of
these raises.
"""
from __future__ import annotations

import numpy as np

from diagan_tpu_torch.data.arrays import ArrayDataset
from diagan_tpu_torch.data.sources import load_celeba, load_cifar10

NOT_PORTED = ("color_mnist", "mnist_fmnist", "25gaussian")


def get_predefined_dataset(dataset_name, root, weights=None, **kwargs):
    if dataset_name == "cifar10":
        images, targets = load_cifar10(root, train=True)
        ds = ArrayDataset.from_images(images, targets=targets, name="cifar10")
    elif dataset_name == "celeba":
        images, attrs = load_celeba(root, size=64)
        ds = ArrayDataset.from_images(images, name="celeba")
        ds.attrs = attrs
    elif dataset_name == "ffhq":
        from diagan_tpu_torch.data.ffhq import load_ffhq

        images = load_ffhq(root, size=kwargs.get("size", 256))
        ds = ArrayDataset.from_images(np.asarray(images), name="ffhq")
    elif dataset_name in NOT_PORTED:
        raise NotImplementedError(f"dataset {dataset_name!r}: not in the port yet "
                                  "(see ROADMAP.md, Queue A)")
    else:
        raise ValueError(f"unknown dataset: {dataset_name}")
    if weights is not None:
        ds.weights = np.asarray(weights, np.float64)
    return ds
