"""Deterministic procedural stand-in images (the port's copy of
`synthetic_natural` in diagan_tpu/data/synthetic.py, which the tests hold
byte for byte against the JAX package's). Used when no dataset is on disk:
the card's machine has no network and no image files."""
from __future__ import annotations

import numpy as np


def synthetic_natural(n: int, size: int, seed: int = 2, channels: int = 3):
    """1/f-spectrum colour noise with natural-image-like second-order
    statistics. Returns (images uint8 [n, size, size, channels], targets
    int64 [n])."""
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
