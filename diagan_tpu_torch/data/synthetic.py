"""Deterministic procedural stand-in datasets (the port's copy of
diagan_tpu/data/synthetic.py, which the tests hold byte for byte against the
JAX package's).

The card's machine has no network and no dataset files, so every dataset
loader first looks for real data on disk and falls back to these generators:
digit-like glyphs, textured blobs and natural-image-statistics noise, with the
real datasets' shapes, dtypes and label distributions. Metric values on
synthetic data are not comparable to the reference's.
"""
from __future__ import annotations

import numpy as np

# 5x7 bitmap font for digits 0-9 (rows of 5 bits, MSB left).
_DIGIT_FONT = {
    0: ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    1: ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    2: ["01110", "10001", "00001", "00010", "00100", "01000", "11111"],
    3: ["11110", "00001", "00001", "01110", "00001", "00001", "11110"],
    4: ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    5: ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    6: ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],
    7: ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    8: ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    9: ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],
}


def _glyph(digit: int) -> np.ndarray:
    rows = _DIGIT_FONT[digit]
    return np.array([[int(c) for c in r] for r in rows], dtype=np.float32)


def synthetic_mnist(n: int, seed: int = 0, size: int = 28):
    """Digit-like grayscale glyphs with random placement/thickness jitter.

    Returns (images uint8 [n, size, size], targets int64 [n]).
    """
    rng = np.random.default_rng(seed)
    targets = rng.integers(0, 10, size=n)
    images = np.zeros((n, size, size), dtype=np.uint8)
    for i, t in enumerate(targets):
        g = _glyph(int(t))
        # upsample the 5x7 glyph by an integer factor with jitter
        fy = int(rng.integers(2, 4))
        fx = int(rng.integers(2, 4))
        big = np.kron(g, np.ones((fy, fx), np.float32))
        h, w = big.shape
        oy = int(rng.integers(2, max(3, size - h - 1)))
        ox = int(rng.integers(2, max(3, size - w - 1)))
        canvas = np.zeros((size, size), np.float32)
        canvas[oy : oy + h, ox : ox + w] = big
        intensity = rng.uniform(0.7, 1.0)
        noise = rng.uniform(0, 0.08, size=(size, size))
        img = np.clip(canvas * intensity + noise, 0, 1)
        images[i] = (img * 255).astype(np.uint8)
    return images, targets.astype(np.int64)


def synthetic_fmnist(n: int, seed: int = 1, size: int = 28):
    """Fashion-like textured blobs (distinct statistics from digit glyphs)."""
    rng = np.random.default_rng(seed)
    targets = rng.integers(0, 10, size=n)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    images = np.zeros((n, size, size), dtype=np.uint8)
    for i, t in enumerate(targets):
        cy, cx = rng.uniform(0.35, 0.65, 2)
        ry, rx = rng.uniform(0.2, 0.42, 2)
        blob = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) < 1.0
        stripes = 0.5 + 0.5 * np.sin(2 * np.pi * (t + 2) * (xx * np.cos(t) + yy * np.sin(t)))
        img = blob * (0.4 + 0.6 * stripes) * rng.uniform(0.6, 1.0)
        img = np.clip(img + rng.uniform(0, 0.05, size=(size, size)), 0, 1)
        images[i] = (img * 255).astype(np.uint8)
    return images, targets.astype(np.int64)


def synthetic_natural(n: int, size: int, seed: int = 2, channels: int = 3):
    """1/f-spectrum color noise — natural-image-like second-order statistics.

    Used as the CIFAR-10 / CelebA stand-in.
    """
    rng = np.random.default_rng(seed)
    fy = np.fft.fftfreq(size)[:, None]
    fx = np.fft.fftfreq(size)[None, :]
    amp = 1.0 / np.sqrt(fy**2 + fx**2 + (1.0 / size) ** 2)
    images = np.empty((n, size, size, channels), dtype=np.uint8)
    for i in range(n):
        img = np.empty((size, size, channels), np.float32)
        base_phase = rng.uniform(0, 2 * np.pi, size=(size, size))
        for c in range(channels):
            phase = base_phase + rng.normal(0, 0.35, size=(size, size))
            spec = amp * np.exp(1j * phase)
            x = np.real(np.fft.ifft2(spec))
            x = (x - x.min()) / (x.max() - x.min() + 1e-9)
            img[..., c] = x
        images[i] = (img * 255).astype(np.uint8)
    targets = rng.integers(0, 10, size=n).astype(np.int64)
    return images, targets
