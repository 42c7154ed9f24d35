"""By-index real-image loaders for the metrics (counterpart of
diagan_tpu/data/index_loader.py; reference
diagan-pkg/diagan/datasets/image_loader_with_index.py: :14-34
get_index_images, :37-92 imagenet, :95-120 lsun-bedroom, and the celeba
variant below them).

They load exactly the real examples at `index`, as (N, H, W, 3) uint8
arrays, for an index-sliced FID (eval.inception.InceptionFeaturizer takes
them as they are). The imagenet and lsun-bedroom loaders have no caller in
the reference; they are kept for the inventory. Each falls back to the
procedural images of data/synthetic.py when its directory is absent, with
the JAX package's seeds, so the arrays are the JAX package's byte for byte.
Image files are read with Pillow, imported where a file is read.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from diagan_tpu_torch.data import synthetic
from diagan_tpu_torch.data.sources import load_celeba


def get_index_images(dataset, index):
    """The images at `index` of an array (one take) or of a sequence whose
    items are an image or an (image, ...) tuple (the reference's per-item
    loop), as one (len(index), H, W, C) batch."""
    index = np.asarray(index)
    if isinstance(dataset, np.ndarray):
        return dataset[index]
    images = []
    for i in index:
        item = dataset[int(i)]
        img = np.asarray(item[0] if isinstance(item, tuple) else item)
        images.append(img[None])
    return np.concatenate(images, axis=0)


def _read_image(path, size, crop=None):
    """An image file as (size, size, 3) uint8: center-cropped to `crop`
    first when given, resized bilinearly; grayscale to RGB, RGBA to RGB."""
    from PIL import Image

    img = Image.open(path)
    if crop:
        w, h = img.size
        left, top = (w - crop) // 2, (h - crop) // 2
        img = img.crop((left, top, left + crop, top + crop))
    img = img.resize((size, size), Image.BILINEAR)
    arr = np.asarray(img)
    if arr.ndim == 2:  # grayscale -> rgb (reference :72-75)
        arr = np.stack([arr] * 3, axis=2)
    elif arr.shape[2] == 4:  # rgba (reference :77-78)
        arr = arr[:, :, :3]
    return arr


def get_imagenet_images_with_index(index, root="./dataset", size=32):
    """For every class directory of {root}/imagenet/train (sorted), its
    files[i] for i in `index` (sorted names), CenterCrop(224) then Resize(size),
    concatenated over the classes. Refuses fewer than 1000 indices, as the
    reference does. Synthetic fallback (seed 11) without the directory."""
    index = np.asarray(index)
    if len(index) < 1000:
        raise ValueError(
            "length of index {} must be at least 1000 to ensure images are "
            "sampled from each class.".format(len(index))
        )
    data_dir = Path(root) / "imagenet" / "train"
    if not data_dir.is_dir():
        images, _ = synthetic.synthetic_natural(int(index.max()) + 1, size, seed=11)
        return images[index]
    images = []
    for class_dir in sorted(os.listdir(data_dir)):
        files = sorted(os.path.join(data_dir, class_dir, n)
                       for n in os.listdir(data_dir / class_dir))
        for i in index:
            images.append(_read_image(files[int(i)], size, crop=224)[None])
    return np.concatenate(images, axis=0)


def get_lsun_bedroom_images_with_index(index, root="./dataset", size=128, **kwargs):
    """LSUN-bedroom images at `index`: from {root}/lsun/lsun_bedroom_{size}.npy
    when present, else the sorted image files of {root}/lsun/bedroom_train/,
    else the synthetic images (seed 12)."""
    index = np.asarray(index)
    base = Path(root) / "lsun"
    cache = base / f"lsun_bedroom_{size}.npy"
    if cache.is_file():
        return np.load(cache, mmap_mode="r")[index]
    img_dir = base / "bedroom_train"
    if img_dir.is_dir():
        files = sorted(p for p in img_dir.iterdir()
                       if p.suffix.lower() in (".jpg", ".jpeg", ".png", ".webp"))
        return np.stack([_read_image(files[int(i)], size) for i in index])
    images, _ = synthetic.synthetic_natural(int(index.max()) + 1, size, seed=12)
    return images[index]


def get_celeba_images_with_index(index, root="./dataset", size=128, **kwargs):
    """CelebA images at `index`, through data/sources.py load_celeba on
    {root}/celeba (its npy cache, its img_align_celeba/ directory, or its
    synthetic fallback of max(index) + 1 images)."""
    index = np.asarray(index)
    images, _ = load_celeba(Path(root) / "celeba", size=size, fallback_n=int(index.max()) + 1)
    return np.asarray(images)[index]
