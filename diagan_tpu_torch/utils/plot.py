"""Diagnostic outputs of the training scripts (counterpart of
diagan_tpu/utils/plot.py).

Each function computes the JAX function's numbers (sort orders and bar
colours, red/green counts, histograms) and returns them, and draws its
figure with numpy into a PNG through train/logger.py's writer: the card's
machine has no matplotlib. The file stems are the JAX package's; the
figures are `.png` where the JAX package writes `.jpg`. The drawings are
plain (white canvas, no axes or legend text); the returned numbers are what
a test or a script compares.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from diagan_tpu_torch.train.logger import save_image_grid, to_uint8, write_png

COLOURS = {"red": (220, 30, 30), "green": (30, 160, 30), "blue": (40, 80, 220),
           "gray": (160, 160, 160), "tab:blue": (31, 119, 180)}


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


def _canvas(h, w):
    return np.full((h, w, 3), 255, np.uint8)


def _scale(v, lo, hi, n):
    """Data values -> pixel indices in [0, n)."""
    span = hi - lo if hi > lo else 1.0
    return np.clip(((np.asarray(v, np.float64) - lo) / span * (n - 1)).round(), 0,
                   n - 1).astype(np.int64)


def _lines(img, xs, ys, colour):
    """A polyline through pixel points (xs, ys), rows counted from the top."""
    for x0, y0, x1, y1 in zip(xs[:-1], ys[:-1], xs[1:], ys[1:]):
        n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
        t = np.linspace(0.0, 1.0, n)
        img[np.round(y0 + t * (y1 - y0)).astype(int),
            np.round(x0 + t * (x1 - x0)).astype(int)] = colour


def plot_score_sort(dataset, score_dict, save_path, phase="p1",
                    metrics=("ldr", "ldrm", "ldrv", "ldrd")):
    """Sorted per-example score bars, red for the minority (label 1), blue
    otherwise (reference plot.py:153-174): one column per example. Returns
    {metric: (order, colours)}."""
    save_path = Path(save_path)
    save_path.mkdir(parents=True, exist_ok=True)
    labels = np.asarray(dataset.labels)
    out = {}
    for name in metrics:
        metric = np.asarray(score_dict[name])
        order = np.argsort(metric)
        colours = np.where(labels[order] == 1, "red", "blue")
        h = 256
        lo, hi = min(0.0, float(metric.min())), max(0.0, float(metric.max()))
        top, base = _scale(metric[order], lo, hi, h), _scale(0.0, lo, hi, h)
        img = _canvas(h, len(metric))
        rows = np.arange(h)[:, None]
        bar = (rows >= np.minimum(top, base)) & (rows <= np.maximum(top, base))
        rgb = np.where((colours == "red")[:, None], COLOURS["red"], COLOURS["blue"])
        img[bar] = np.broadcast_to(rgb[None], (h,) + rgb.shape)[bar]
        write_png(save_path / f"{phase}_{name}_sort.png", img[::-1])
        out[name] = (order, colours)
    return out


def plot_logit_trajectories(logits_dict, save_path, indices=None, name="ldr"):
    """Per-example logit time series over the recording window (reference
    plot.py:121-151). Returns (steps, logits [T, len(indices)])."""
    save_path = Path(save_path)
    save_path.mkdir(parents=True, exist_ok=True)
    steps = sorted(logits_dict)
    arr = np.stack([logits_dict[s] for s in steps])  # [T, N]
    if indices is None:
        indices = np.arange(min(50, arr.shape[1]))
    sel = arr[:, indices]
    h, w = 360, 600
    img = _canvas(h, w)
    xs = _scale(steps, min(steps), max(steps), w)
    for i in range(sel.shape[1]):
        _lines(img, xs, h - 1 - _scale(sel[:, i], sel.min(), sel.max(), h), COLOURS["tab:blue"])
    write_png(save_path / f"{name}_trajectories.png", img)
    return np.asarray(steps), sel


def plot_color_mnist_generator(generate_images_fn, save_path, file_name="eval",
                               num_images=1000):
    """Channel dominance of generated images: how many are red-dominant and
    how many green-dominant (reference plot.py:269-318), as a bar chart, and
    a grid of the first 100. Returns [red count, green count]."""
    save_path = Path(save_path)
    save_path.mkdir(parents=True, exist_ok=True)
    imgs = to_uint8(generate_images_fn(num_images))
    red = (imgs[..., 0].astype(np.int64) - imgs[..., 1]).reshape(len(imgs), -1).mean(1)
    counts = [int((red > 0).sum()), int((red <= 0).sum())]
    h, w = 200, 200
    img = _canvas(h, w)
    for k, (count, colour) in enumerate(zip(counts, ("red", "green"))):
        top = h - 1 - _scale(count, 0, max(counts), h)
        img[top:, 30 + 80 * k: 90 + 80 * k] = COLOURS[colour]
    write_png(save_path / f"{file_name}_channel_counts.png", img)
    save_image_grid(imgs[:100].astype(np.float32) / 127.5 - 1.0,
                    save_path / f"{file_name}_samples.png", nrow=10)
    return counts


def plot_gaussian_samples(points, save_path, global_step=0, real_points=None):
    """25-Gaussians scatter of G's points (blue) over real ones (gray)
    (reference plot.py:56-67). Returns the PNG's path."""
    save_path = Path(save_path)
    save_path.mkdir(parents=True, exist_ok=True)
    n = 400
    clouds = [np.asarray(points, np.float64)]
    if real_points is not None:
        clouds.insert(0, np.asarray(real_points, np.float64))
    both = np.concatenate(clouds)
    lo, hi = float(both.min()), float(both.max())
    img = _canvas(n, n)
    for cloud, colour in zip(clouds, (["gray"] if real_points is not None else []) + ["tab:blue"]):
        img[n - 1 - _scale(cloud[:, 1], lo, hi, n), _scale(cloud[:, 0], lo, hi, n)] = \
            COLOURS[colour]
    return write_png(save_path / f"gaussian_step_{global_step}.png", img)


def plot_intensity_histogram(sample_weights, dataset, save_path, prefix=""):
    """Pixel-intensity histograms of the 100 lowest and highest scored
    examples (reference plot.py:251-267), blue and red. Returns (low, high),
    each a 256-bin count."""
    save_path = Path(save_path)
    save_path.mkdir(parents=True, exist_ok=True)
    order = np.argsort(np.asarray(sample_weights))
    imgs = dataset.images
    lo = np.bincount(imgs[order[:100]].reshape(-1), minlength=256)
    hi = np.bincount(imgs[order[-100:]].reshape(-1), minlength=256)
    h, w = 280, 512
    img = _canvas(h, w)
    top = max(int(lo.max()), int(hi.max()))
    for counts, colour in ((lo, "blue"), (hi, "red")):
        _lines(img, np.arange(256) * 2, h - 1 - _scale(counts, 0, top, h), COLOURS[colour])
    write_png(save_path / f"{prefix}_intensity_hist.png", img)
    return lo, hi
