"""LDR discrepancy scoring, the diagnosis step between phase 1 and phase 2.

The port's own copy of diagan_tpu/score/score.py (numpy only; the tests hold
every key of its output against the JAX package's). Given the per-example
logit time series the phase-1 trainer records (step -> float[N]):

  ldr    last recorded logit
  ldrd   mean absolute step-to-step change
  ldrv   variance over the window (ddof=1)
  ldrm   mean over the window
  ldr_conf_{t:.1f}_ratio_50, t in 0.1..9.9
         clip_max_ratio(clip_min(mean + t*std(ddof=1), 1e-2), ratio=50)

The 99 ldr_conf variants are made on access from the shared (mean, std).
"""
from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np

_CONF_RE = re.compile(r"^ldr_conf_(\d+\.\d)_ratio_(\d+)$")


def clip_min(score, lower_bd=1e-2):
    """Floor scores at lower_bd (reference plot.py:230-231)."""
    return np.clip(score, lower_bd, None)


def clip_max_ratio(score, ratio=20):
    """Cap scores at min(score)*ratio (reference plot.py:226-228)."""
    return np.clip(score, None, np.min(score) * ratio)


def ldr_conf_score(mean, std, t, ratio=50, floor=1e-2):
    """The shipping score family: clip_max_ratio(clip_min(mean + t*std))."""
    return clip_max_ratio(clip_min(mean + t * std, floor), ratio=ratio)


class _ScoreDict(Mapping):
    """Lazy mapping over the score family.

    Base scores (ldr/ldrd/ldrv/ldrm) are precomputed; the 99
    `ldr_conf_{t}_ratio_{r}` variants are derived on access from the shared
    (mean, std) statistics. Iteration lists the same key set the reference
    materializes eagerly.
    """

    def __init__(self, base: dict, mean, std):
        self._base = base
        self._mean = mean
        self._std = std
        self._conf_keys = [f"ldr_conf_{t:.1f}_ratio_50" for t in np.arange(0.1, 10.0, 0.1)]

    def __getitem__(self, key):
        if key in self._base:
            return self._base[key]
        m = _CONF_RE.match(key)
        if m:
            t = float(m.group(1))
            ratio = int(m.group(2))
            return np.asarray(ldr_conf_score(self._mean, self._std, t, ratio=ratio))
        raise KeyError(key)

    def __iter__(self):
        yield from self._base
        yield from self._conf_keys

    def __len__(self):
        return len(self._base) + len(self._conf_keys)


def _window_stack(logits, start_step, end_step):
    """Select snapshots with start <= step < end, ordered by step.

    Accepts either the reference pickle format ({step: float[N]}) or the
    JAX recorder's buffer format (steps int[S], buffer float[S, N]) with unused slots
    marked step < 0.
    """
    if isinstance(logits, dict):
        steps = sorted(k for k in logits if start_step <= k < end_step)
        return np.stack([np.asarray(logits[k]) for k in steps])
    steps, buf = logits
    steps = np.asarray(steps)
    mask = (steps >= start_step) & (steps < end_step)
    order = np.argsort(steps[mask], kind="stable")
    return np.asarray(buf)[mask][order]


def calculate_scores(logits, start_epoch=50, end_epoch=75, clip_val=1.5,
                     conf=1, normalize_logits=False):
    """Compute the LDR score family over a window of logit snapshots.

    Signature kept flag-for-flag with the reference (start/end named
    'epoch' though they are global steps; clip_val/conf vestigial).

    normalize_logits=True is a DOCUMENTED DEVIATION (off by default): it
    shifts each snapshot by its across-examples median before scoring.
    Rationale: when D's real logits sit far above ~0.5, the ldr_conf
    family saturates — every score clears the clip_min floor of 1e-2, any
    example AT the floor pins clip_max_ratio's cap to floor*ratio, and the
    weights flatten toward uniform (observed on easy synthetic data,
    docs/VALIDATION.md). Median-centering restores the intended dynamic
    range while preserving each snapshot's across-example ordering; it
    also removes common-mode temporal drift of D's logit scale from the
    time-series scores (ldrd/ldrv), leaving per-example discrepancy.
    """
    arr = _window_stack(logits, start_epoch, end_epoch)
    if normalize_logits:
        arr = arr - np.median(arr, axis=1, keepdims=True)
    if arr.shape[0] < 2:
        raise ValueError(
            f"need >=2 logit snapshots in window [{start_epoch}, {end_epoch}), "
            f"got {arr.shape[0]}"
        )
    mean = np.mean(arr, axis=0)
    std = np.std(arr, axis=0, ddof=1)
    base = {
        "ldr": np.asarray(arr[-1]),
        "ldrd": np.asarray(np.mean(np.abs(arr[1:] - arr[:-1]), axis=0)),
        "ldrv": np.asarray(std**2),
        "ldrm": np.asarray(mean),
    }
    return _ScoreDict(base, mean, std)


def warn_if_degenerate_weights(weights, score_name, ratio_threshold=1.05):
    """Loud warning when resampling weights are near-uniform.

    The ldr_conf family saturates when D's real logits sit high (every
    score clears the clip_min floor and the cap pins to floor*ratio,
    docs/VALIDATION.md): phase 2 then silently trains with ~uniform
    weights — indistinguishable from the baseline, discovered only after
    the full run. Returns True when degenerate (max/min <= threshold).
    """
    w = np.asarray(weights, dtype=np.float64)
    lo = float(w.min())
    ratio = float(w.max() / lo) if lo > 0 else float("inf")
    if ratio <= ratio_threshold:
        import warnings

        warnings.warn(
            f"resample weights for '{score_name}' are near-uniform "
            f"(max/min = {ratio:.4f} <= {ratio_threshold}): phase 2 will "
            "behave like the unweighted baseline. D's logits likely "
            "saturate the ldr_conf clip window on this dataset — consider "
            "--normalize_logits or a variance score (ldrv).",
            RuntimeWarning, stacklevel=2,
        )
        return True
    return False


def prepare_sample_weights(weights, eps=1e-6, clip_var=False):
    """Floor resampling weights at eps (reference train_mimicry_phase2.py:21-23).

    With clip_var=True also clip to mean +/- 2*var — the MNIST-variant
    phase-2 scripts' extra guard
    (reference train_mimicry_color_mnist_phase2.py:24-37).
    """
    w = np.asarray(weights, dtype=np.float64)
    if clip_var:
        ub = w.mean() + 2 * w.var()
        lb = w.mean() - 2 * w.var()
        w = np.clip(w, lb, ub)
    return np.where(w < eps, eps, w)
