"""Training logger and image-grid output (counterpart of
diagan_tpu/train/logger.py).

Logger: stdout, JSONL scalars (the reference's names: errD, errG, errD_drs,
D(x), D(G(z)), lr_{i}, topk_rate), PNG sample grids under `{log_dir}/images/`,
and TensorBoard only where torch's SummaryWriter imports (the card's machine
has no TensorBoard).

The PNG is written with zlib and struct alone (8-bit grayscale or RGB, no
filtering), so the port needs no imaging library; the machine with the card
has none. Same grid layout as diagan_tpu/train/logger.py:save_image_grid.
"""
from __future__ import annotations

import json
import struct
import time
import zlib
from pathlib import Path

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


class Logger:
    def __init__(self, log_dir, use_tensorboard=True):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.log_dir / "scalars.jsonl", "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(str(self.log_dir / "tb"), flush_secs=30)

    def write_scalars(self, step: int, scalars: dict):
        rec = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            rec[k] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(k, float(v), int(step))
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def print_log(self, step: int, num_steps: int, scalars: dict, time_taken: float):
        parts = " | ".join(f"{k}: {float(v):.4f}" for k, v in scalars.items())
        print(f"INFO: [Step {step}/{num_steps}] {parts} ({time_taken:.4f} sec/idx)", flush=True)

    def vis_images(self, step: int, images, nrow: int = 8, name="fake_samples"):
        """images: (N, H, W, C) in [-1, 1] -> one PNG grid."""
        path = self.log_dir / "images" / f"{name}_step_{step}.png"
        path.parent.mkdir(parents=True, exist_ok=True)
        save_image_grid(np.asarray(images), path, nrow=nrow)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
