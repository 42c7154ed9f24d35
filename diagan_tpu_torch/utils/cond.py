"""Otsu-threshold index split (counterpart of diagan_tpu/utils/cond.py;
reference diagan-pkg/diagan/utils/cond.py:4-12 `get_index_group`): scores
split into a low and a high group at the threshold that maximises the
between-class variance of their 256-bin histogram. numpy on the host, as
there.
"""
from __future__ import annotations

import numpy as np


def otsu_threshold(scores, bins=256):
    """The bin centre that maximises the between-class variance."""
    hist, edges = np.histogram(np.asarray(scores, np.float64), bins=bins)
    p = hist.astype(np.float64) / max(hist.sum(), 1)
    centers = (edges[:-1] + edges[1:]) / 2
    w0 = np.cumsum(p)
    w1 = 1 - w0
    mu = np.cumsum(p * centers)
    with np.errstate(divide="ignore", invalid="ignore"):
        var_between = (mu[-1] * w0 - mu) ** 2 / (w0 * w1)
    var_between[~np.isfinite(var_between)] = -1
    return centers[int(np.argmax(var_between))]


def get_index_group(scores):
    """(low_index, high_index): the indices at or below the Otsu threshold,
    and those above it."""
    scores = np.asarray(scores)
    t = otsu_threshold(scores)
    return np.where(scores <= t)[0], np.where(scores > t)[0]
