"""Image-grid output: uint8 quantization and a PNG writer.

The PNG is written with zlib and struct alone (8-bit grayscale or RGB, no
filtering), so the port needs no imaging library; the machine with the card
has none. Same grid layout as diagan_tpu/train/logger.py:save_image_grid.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def to_uint8(images):
    return np.clip((np.asarray(images) + 1.0) * 127.5, 0, 255).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path, img):
    """Write a uint8 (H, W) grayscale or (H, W, 3) RGB array as a PNG."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"write_png takes (H, W) or (H, W, 3), got {img.shape}")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    # each scanline starts with its filter type, 0 (none)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))
    return path


def save_image_grid(images, path, nrow: int = 8, pad: int = 2):
    """(N, H, W, C) in [-1, 1], C in (1, 3) -> single PNG grid file."""
    imgs = to_uint8(images)
    n, h, w, c = imgs.shape
    ncol = nrow
    nrows = -(-n // ncol)
    grid = np.zeros((nrows * (h + pad) + pad, ncol * (w + pad) + pad, c), np.uint8)
    for i in range(n):
        r, col = divmod(i, ncol)
        y, x = pad + r * (h + pad), pad + col * (w + pad)
        grid[y: y + h, x: x + w] = imgs[i]
    if c == 1:
        grid = grid[..., 0]
    return write_png(path, grid)
