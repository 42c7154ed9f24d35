"""Diagnostic outputs of the training scripts (the part of
diagan_tpu/utils/plot.py that the SNGAN path uses).

Parameter counts, and grids of the lowest- and highest-scored real examples
written by the port's PNG writer. No matplotlib: the card's machine has none.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from diagan_tpu_torch.train.logger import save_image_grid


def print_num_params(netG, netD):
    ng = sum(p.numel() for p in netG.parameters())
    nd = sum(p.numel() for p in netD.parameters())
    print(f"INFO: netG params: {ng / 1e6:.2f}M, netD params: {nd / 1e6:.2f}M")


def show_sorted_score_samples(dataset, score, save_path, score_name="score",
                              plot_name="sorted", num_shown=100):
    """Grids of the lowest- and highest-scored real examples
    (reference plot.py:94-104)."""
    save_path = Path(save_path)
    save_path.mkdir(parents=True, exist_ok=True)
    order = np.argsort(np.asarray(score))
    imgs = dataset.images
    lo = imgs[order[:num_shown]].astype(np.float32) / 127.5 - 1.0
    hi = imgs[order[-num_shown:]].astype(np.float32) / 127.5 - 1.0
    save_image_grid(lo, save_path / f"{plot_name}_{score_name}_low.png", nrow=10)
    save_image_grid(hi, save_path / f"{plot_name}_{score_name}_high.png", nrow=10)
