"""Pixel-space transforms applied at dataset build time (the port's copy of
diagan_tpu/data/transform.py).

resize_center_crop resizes the shorter side to `size` with jax.image.resize's
"bilinear" (eval/inception.py:resize_bilinear: a triangle kernel, widened by
1/scale when shrinking), then centre-crops; uint8 in, round-half-even and
clip to uint8 out. The JAX package runs its resize eagerly, whose weights
and sums round differently in float32 from the port's matrices (sample
positions rounded once, as under jit): the float results differ by a few
ulps, which moves a pixel by one LSB where it lies within them of a .5
(tests/test_torch_port_celeba_data.py states the share).
"""
from __future__ import annotations

import numpy as np
import torch

from diagan_tpu_torch.eval.inception import resize_bilinear


def resize_center_crop(images: np.ndarray, size: int) -> np.ndarray:
    """Resize shorter side to `size` (bilinear) then center-crop, batch uint8
    NHWC (or NHW for grayscale)."""
    gray = images.ndim == 3
    if gray:
        images = images[..., None]
    n, h, w, c = images.shape
    if h == size and w == size:
        return images[..., 0] if gray else images
    scale = size / min(h, w)
    nh, nw = round(h * scale), round(w * scale)
    x = _bilinear_resize(images, nh, nw)
    top, left = (nh - size) // 2, (nw - size) // 2
    x = x[:, top : top + size, left : left + size, :]
    return x[..., 0] if gray else x


def _bilinear_resize(images: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """uint8 NHWC -> uint8 (N, nh, nw, C)."""
    x = torch.from_numpy(np.ascontiguousarray(images)).permute(0, 3, 1, 2).float()
    x = resize_bilinear(x, (nh, nw))
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8).permute(0, 2, 3, 1).numpy()


def grayscale_to_rgb(images: np.ndarray) -> np.ndarray:
    if images.ndim == 3:
        images = images[..., None]
    if images.shape[-1] == 1:
        images = np.repeat(images, 3, axis=-1)
    return images


def remove_outliers(images: np.ndarray, z_thresh: float = 3.0) -> np.ndarray:
    """Drop images whose mean intensity is a z-score outlier — numpy
    equivalent of the reference's unused cv2 helper
    (diagan-pkg/diagan/datasets/utils.py:4-21)."""
    means = images.reshape(len(images), -1).mean(1).astype(np.float64)
    z = np.abs(means - means.mean()) / (means.std() + 1e-12)
    return images[z < z_thresh]
