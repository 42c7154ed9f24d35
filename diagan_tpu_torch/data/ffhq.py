"""FFHQ storage and loading (the port's copy of diagan_tpu/data/ffhq.py).

Precedence: the flat uint8 `ffhq_{size}.npy` cache (memory-mapped), an LMDB
directory, a directory of images, and the procedural fallback. The LMDB and
image-directory readers (and `prepare_npy`, which writes the npy cache
from an image directory) need lmdb and Pillow, which are imported only on
those branches: the card's machine has neither, and the npy cache and the
fallback need nothing beyond numpy.
"""
from __future__ import annotations

import io
from pathlib import Path

import numpy as np

BLACKLIST = {40650}  # reference stylegan2/dataset.py:29-31


def load_ffhq(root, size=256, fallback_n=2048, seed=7):
    """uint8 (N, size, size, 3)."""
    root = Path(root)
    cache = root / f"ffhq_{size}.npy"
    if cache.is_file():
        return np.load(cache, mmap_mode="r")
    if (root / "data.mdb").is_file():
        try:
            return _load_lmdb(root, size)
        except ImportError:
            raise RuntimeError(
                f"{root} is an LMDB but the lmdb package is unavailable; "
                f"convert it to {cache.name} where lmdb is installed"
            )
    if root.is_dir() and (any(root.glob("*.png")) or any(root.glob("*.jpg"))):
        return prepare_npy(root, root, sizes=(size,))[size]
    from diagan_tpu_torch.data.synthetic import synthetic_natural

    images, _ = synthetic_natural(fallback_n, size, seed=seed)
    return images


def _load_lmdb(root, size):
    import lmdb
    from PIL import Image

    env = lmdb.open(str(root), readonly=True, lock=False)
    with env.begin(write=False) as txn:
        n = int(txn.get("length".encode("utf-8")).decode("utf-8"))
        out = np.empty((n - len(BLACKLIST), size, size, 3), np.uint8)
        j = 0
        for i in range(n):
            if i in BLACKLIST:
                continue
            key = f"{size}-{i + (1 if i > max(BLACKLIST) else 0):05d}"
            img = Image.open(io.BytesIO(txn.get(key.encode("utf-8"))))
            out[j] = np.asarray(img.convert("RGB"))
            j += 1
    return out


def prepare_npy(img_dir, out_dir, sizes=(128, 256, 512, 1024)):
    """Resize (Lanczos, shorter side to `size`) and centre-crop every image of
    a directory into `out_dir/ffhq_{size}.npy` per size: the bytes of
    diagan_tpu/data/ffhq.py:prepare_npy, written through a memory map so
    that a 1024 px pass never holds the whole array. Returns {size: the
    array, memory-mapped read-only}."""
    from PIL import Image

    img_dir, out_dir = Path(img_dir), Path(out_dir)
    files = sorted(p for p in img_dir.iterdir()
                   if p.suffix.lower() in (".png", ".jpg", ".jpeg", ".webp"))
    out_dir.mkdir(parents=True, exist_ok=True)
    out = {}
    for size in sizes:
        path = out_dir / f"ffhq_{size}.npy"
        arr = np.lib.format.open_memmap(path, mode="w+", dtype=np.uint8,
                                        shape=(len(files), size, size, 3))
        for i, f in enumerate(files):
            im = Image.open(f).convert("RGB")
            w, h = im.size
            s = size / min(w, h)
            im = im.resize((round(w * s), round(h * s)), Image.LANCZOS)
            w, h = im.size
            left, top = (w - size) // 2, (h - size) // 2
            arr[i] = np.asarray(im.crop((left, top, left + size, top + size)))
        arr.flush()
        del arr
        out[size] = np.load(path, mmap_mode="r")
    return out
