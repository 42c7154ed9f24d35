"""FID / Inception Score / KID / precision-recall (counterpart of
diagan_tpu/eval/metrics.py).

Framework-free copies, held to exact equality with the JAX package:
normalize_images, activation_statistics (float64, NaN/Inf rows dropped),
frechet_distance (scipy sqrtm with the eps-jitter retry), load_stats /
save_stats (.npz with mu, sigma), fid_from_features and kid_from_features
(polynomial-kernel MMD, degree 3, block estimator from
np.random.default_rng(seed)).

In torch: the Inception Score's softmax (float32, then the numpy splits) and
precision/recall, on the features' device. The distances keep the reference's
float32 form ||x||^2 - 2 x.y + ||y||^2 (compute_pr.py:11-31); the radius is the
(k+1)-th smallest distance including the self-distance, and membership is a
strict <. torch.cdist or a float64 path would move the radii. Run with TF32
off on the card (torch.backends.cuda.matmul.allow_tf32 = False): TF32 rounds
x.y to 10 mantissa bits.
"""
from __future__ import annotations

import warnings
from pathlib import Path

import numpy as np
import torch


# ---- FID -----------------------------------------------------------------

def normalize_images(images):
    """Min-max normalize float images to uint8 per the reference
    (_normalize_images, fid_score.py:77-101)."""
    images = np.asarray(images, np.float32)
    axis = tuple(range(1, images.ndim))
    mn = images.min(axis=axis, keepdims=True)
    mx = images.max(axis=axis, keepdims=True)
    return (255 * (images - mn) / (mx - mn + 1e-9)).astype(np.uint8)


def activation_statistics(features):
    """(mu, sigma) with NaN/Inf rows dropped (fid_utils.py:86-88)."""
    feats = np.asarray(features, np.float64)
    keep = np.isfinite(feats).all(axis=1)
    feats = feats[keep]
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6):
    """scipy-sqrtm Frechet distance with the reference's jitter fallback
    (fid_utils.py:11-67)."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    with warnings.catch_warnings():
        # singular products raise LinAlgWarning under scipy>=1.17; the
        # isfinite check below handles that case by the eps jitter. Other
        # warnings stay visible.
        warnings.simplefilter("ignore", linalg.LinAlgWarning)
        covmean = linalg.sqrtm(sigma1.dot(sigma2))  # non-finite if singular
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(
        diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean)
    )


def load_stats(path):
    with np.load(path) as f:
        return f["mu"], f["sigma"]


def save_stats(path, mu, sigma):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, mu=mu, sigma=sigma)


def fid_from_features(real_features=None, fake_features=None, stats_file=None):
    if stats_file is not None:
        mu1, s1 = load_stats(stats_file)
    else:
        mu1, s1 = activation_statistics(real_features)
    mu2, s2 = activation_statistics(fake_features)
    return frechet_distance(mu1, s1, mu2, s2)


# ---- Inception Score -----------------------------------------------------

def inception_score_from_logits(logits, splits=10):
    probs = torch.softmax(torch.as_tensor(logits, dtype=torch.float32), dim=-1)
    probs = probs.cpu().numpy()
    n = len(probs)
    scores = []
    for i in range(splits):
        part = probs[i * n // splits: (i + 1) * n // splits]
        kl = part * (np.log(part + 1e-12) - np.log(part.mean(0, keepdims=True) + 1e-12))
        scores.append(np.exp(kl.sum(1).mean()))
    return float(np.mean(scores)), float(np.std(scores))


# ---- KID -----------------------------------------------------------------

def kid_from_features(real_features, fake_features, num_subsets=10,
                      subset_size=1000, seed=0):
    """Block polynomial-kernel MMD^2 estimate (mean, std over subsets)."""
    rng = np.random.default_rng(seed)
    real = np.asarray(real_features, np.float64)
    fake = np.asarray(fake_features, np.float64)
    d = real.shape[1]
    m = min(subset_size, len(real), len(fake))
    scores = []
    for _ in range(num_subsets):
        x = real[rng.choice(len(real), m, replace=False)]
        y = fake[rng.choice(len(fake), m, replace=False)]
        kxx = (x @ x.T / d + 1) ** 3
        kyy = (y @ y.T / d + 1) ** 3
        kxy = (x @ y.T / d + 1) ** 3
        mmd = (
            (kxx.sum() - np.trace(kxx)) / (m * (m - 1))
            + (kyy.sum() - np.trace(kyy)) / (m * (m - 1))
            - 2 * kxy.mean()
        )
        scores.append(mmd)
    return float(np.mean(scores)), float(np.std(scores))


# ---- precision / recall --------------------------------------------------

def _as_f32(x):
    """float32 tensor on x's device (numpy arrays: the CPU)."""
    return torch.as_tensor(x, dtype=torch.float32)


def _fraction(mask):
    """The float32 mean of a boolean vector as jnp.mean rounds it: the count
    times the float32 reciprocal of the length (XLA multiplies by it)."""
    return float(mask.sum().to(torch.float32) * np.float32(1.0 / mask.numel()))


def _pairwise_sq_dists(x, y):
    """Squared euclidean distances in float32, in the reference's
    ||x||^2 - 2 x.y + ||y||^2 form."""
    nx = torch.sum(x * x, dim=1)[:, None]
    ny = torch.sum(y * y, dim=1)[None, :]
    return nx - 2 * x @ y.T + ny


def _knn_radii(features, nearest_k):
    d = _pairwise_sq_dists(features, features)
    # the (k+1) smallest, the self-distance included (compute_pr.py:34-62)
    return torch.topk(d, nearest_k + 1, dim=1, largest=False).values[:, -1]


def compute_pr(real_features, fake_features, nearest_k=3):
    """Precision and recall of the fakes against the reals' k-NN manifold
    (and the reverse). Features are numpy arrays (computed on the CPU) or
    tensors (computed on their device)."""
    real = _as_f32(real_features)
    fake = _as_f32(fake_features)
    real_r = _knn_radii(real, nearest_k)
    fake_r = _knn_radii(fake, nearest_k)
    d = _pairwise_sq_dists(real, fake)
    precision = _fraction(torch.any(d < real_r[:, None], dim=0))
    recall = _fraction(torch.any(d < fake_r[None, :], dim=1))
    return {"precision": precision, "recall": recall}


def compute_partial_recall(partial_real_features, fake_features, nearest_k=3):
    fake = _as_f32(fake_features)
    fake_r = _knn_radii(fake, nearest_k)
    d = _pairwise_sq_dists(_as_f32(partial_real_features).to(fake.device), fake)
    return {"recall": _fraction(torch.any(d < fake_r[None, :], dim=1))}
