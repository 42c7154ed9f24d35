"""Raw-source loaders: read standard on-disk formats, fall back to synthetic
(the port's copy of diagan_tpu/data/sources.py).

Loader precedence per source:
  MNIST/FashionMNIST: idx-ubyte files (raw/ train-images-idx3-ubyte[.gz])
  CIFAR-10:           python-pickle batches (cifar-10-batches-py/)
  CelebA:             img_align_celeba/ image dir or celeba_64.npy
falling back to diagan_tpu_torch.data.synthetic generators (zero-egress container).
"""
from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path

import numpy as np

from diagan_tpu_torch.data import synthetic

# Sizes mirror the real datasets so schedules (steps/epochs) are faithful.
_MNIST_N = 60000
_CIFAR_N = 50000
_CELEBA_N = 202599


def _read_idx(path: Path) -> np.ndarray:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


def _find_idx(root: Path, stem: str) -> Path | None:
    for sub in ("", "raw", "MNIST/raw", "FashionMNIST/raw"):
        for suffix in ("", ".gz"):
            p = root / sub / (stem + suffix)
            if p.is_file():
                return p
    return None


def load_mnist(root, train=True, fallback_n=_MNIST_N, seed=0):
    """(images uint8 [N,28,28], targets int64 [N])."""
    root = Path(root)
    split = "train" if train else "t10k"
    img_p = _find_idx(root, f"{split}-images-idx3-ubyte")
    lbl_p = _find_idx(root, f"{split}-labels-idx1-ubyte")
    if img_p and lbl_p:
        return _read_idx(img_p), _read_idx(lbl_p).astype(np.int64)
    return synthetic.synthetic_mnist(fallback_n, seed=seed)


def load_fmnist(root, train=True, fallback_n=_MNIST_N, seed=1):
    root = Path(root)
    split = "train" if train else "t10k"
    img_p = _find_idx(root, f"{split}-images-idx3-ubyte")
    lbl_p = _find_idx(root, f"{split}-labels-idx1-ubyte")
    if img_p and lbl_p:
        return _read_idx(img_p), _read_idx(lbl_p).astype(np.int64)
    return synthetic.synthetic_fmnist(fallback_n, seed=seed)


def load_cifar10(root, train=True, fallback_n=_CIFAR_N, seed=2):
    """(images uint8 [N,32,32,3], targets int64 [N])."""
    import pickle

    root = Path(root)
    for base in (root, root / "cifar-10-batches-py"):
        batch1 = base / "data_batch_1"
        if batch1.is_file():
            names = (
                [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
            )
            imgs, targets = [], []
            for name in names:
                with open(base / name, "rb") as f:
                    d = pickle.load(f, encoding="bytes")
                imgs.append(
                    d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
                )
                targets.extend(d[b"labels"])
            return (
                np.concatenate(imgs).astype(np.uint8),
                np.asarray(targets, np.int64),
            )
    return synthetic.synthetic_natural(fallback_n, 32, seed=seed)


def load_celeba(root, size=64, fallback_n=20000, seed=3):
    """(images uint8 [N,size,size,3], attrs int8 [N,40] or zeros).

    Real-data paths: a pre-resized `celeba_{size}.npy` cache, or the
    standard `img_align_celeba/` jpg directory (resized + center-cropped
    here, then cached). Synthetic fallback uses a reduced N for memory.
    """
    root = Path(root)
    cache = root / f"celeba_{size}.npy"
    attr_file = root / "list_attr_celeba.txt"
    if cache.is_file():
        images = np.load(cache, mmap_mode="r")
        attrs = load_celeba_attrs(attr_file, len(images))
        return np.asarray(images), attrs
    img_dir = root / "img_align_celeba"
    if img_dir.is_dir():
        from PIL import Image

        files = sorted(img_dir.glob("*.jpg"))
        images = np.empty((len(files), size, size, 3), np.uint8)
        for i, f in enumerate(files):
            im = Image.open(f).convert("RGB")
            # reference transform: Resize(size) then CenterCrop(size)
            # (diagan-pkg/diagan/datasets/transform.py:43-52)
            w, h = im.size
            s = size / min(w, h)
            im = im.resize((round(w * s), round(h * s)), Image.BILINEAR)
            w, h = im.size
            left, top = (w - size) // 2, (h - size) // 2
            images[i] = np.asarray(im.crop((left, top, left + size, top + size)))
        os.makedirs(root, exist_ok=True)
        np.save(cache, images)
        return images, load_celeba_attrs(attr_file, len(images))
    images, _ = synthetic.synthetic_natural(fallback_n, size, seed=seed)
    return images, synthetic_celeba_attrs(images, seed=seed)


def synthetic_celeba_attrs(images: np.ndarray, seed: int = 0) -> np.ndarray:
    """Deterministic pseudo-attributes for the synthetic CelebA fallback.

    Each of the 40 attributes is the sign of a (seeded) random projection
    of simple per-image statistics (region brightness, channel means,
    contrast), thresholded at its median. This keeps the attribute tooling
    (train_convnet_celeba / count_attr_celeba / disc_score / partial
    recall) exercisable offline: attrs are a learnable function of the
    image, each ~50/50 except Bald/Mustache-style rarities which use a
    90th-percentile threshold to mimic imbalanced real attributes.
    Flagged synthetic — real runs parse list_attr_celeba.txt instead.
    """
    x = images.astype(np.float32) / 255.0
    h = x.shape[1] // 2
    w = x.shape[2] // 2
    feats = np.stack(
        [
            x.mean(axis=(1, 2, 3)),
            x[:, :h].mean(axis=(1, 2, 3)),
            x[:, h:].mean(axis=(1, 2, 3)),
            x[:, :, :w].mean(axis=(1, 2, 3)),
            x[:, :, w:].mean(axis=(1, 2, 3)),
            x[..., 0].mean(axis=(1, 2)),
            x[..., 1].mean(axis=(1, 2)),
            x[..., 2].mean(axis=(1, 2)),
            x.std(axis=(1, 2, 3)),
            np.abs(np.diff(x, axis=1)).mean(axis=(1, 2, 3)),
        ],
        axis=1,
    )
    feats = (feats - feats.mean(0)) / (feats.std(0) + 1e-8)
    rng = np.random.default_rng(1000 + seed)
    proj = rng.normal(size=(feats.shape[1], 40)).astype(np.float32)
    scores = feats @ proj
    # rare attributes (10% positive), matching CelebA's skewed columns
    rare = {4, 13, 14, 16, 17, 22, 35, 38}  # Bald, Chubby, Double_Chin, ...
    attrs = np.empty((len(images), 40), np.int8)
    for j in range(40):
        q = 90.0 if j in rare else 50.0
        attrs[:, j] = np.where(scores[:, j] > np.percentile(scores[:, j], q),
                               1, -1)
    return attrs


def load_celeba_attrs(attr_file, n: int) -> np.ndarray:
    """Parse list_attr_celeba.txt into int8 [N, 40] in {-1, +1} (zeros when
    absent). Parity: reference get_celeba_index_with_attr.py:5-25."""
    attr_file = Path(attr_file)
    if not attr_file.is_file():
        return np.zeros((n, 40), np.int8)
    # the count line, the 40 names, then "<file> a_1 ... a_40" per image (the
    # JAX package parses it with pandas, which the port does not need)
    return np.loadtxt(attr_file, dtype=np.int8, skiprows=2, usecols=range(1, 41), max_rows=n,
                      ndmin=2)


CELEBA_ATTR_NAMES = [
    "5_o_Clock_Shadow", "Arched_Eyebrows", "Attractive", "Bags_Under_Eyes",
    "Bald", "Bangs", "Big_Lips", "Big_Nose", "Black_Hair", "Blond_Hair",
    "Blurry", "Brown_Hair", "Bushy_Eyebrows", "Chubby", "Double_Chin",
    "Eyeglasses", "Goatee", "Gray_Hair", "Heavy_Makeup", "High_Cheekbones",
    "Male", "Mouth_Slightly_Open", "Mustache", "Narrow_Eyes", "No_Beard",
    "Oval_Face", "Pale_Skin", "Pointy_Nose", "Receding_Hairline",
    "Rosy_Cheeks", "Sideburns", "Smiling", "Straight_Hair", "Wavy_Hair",
    "Wearing_Earrings", "Wearing_Hat", "Wearing_Lipstick",
    "Wearing_Necklace", "Wearing_Necktie", "Young",
]
