"""StyleGAN2 losses and regularisers (counterparts of the StyleGAN2 part of
diagan_tpu/models/losses.py and of the penalties in
diagan_tpu/train/stylegan2_trainer.py)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def d_logistic_loss(real_pred, fake_pred):
    """softplus(-real) + softplus(fake), each averaged."""
    return F.softplus(-real_pred).mean() + F.softplus(fake_pred).mean()


def g_nonsaturating_loss(fake_pred):
    return F.softplus(-fake_pred).mean()


def r1_penalty(real_pred, real_img):
    """sum of squared gradients of sum(D(x)) with respect to x, over the
    batch size. The graph is kept, so the penalty is differentiable in D's
    parameters (a second derivative through D)."""
    (grad,) = torch.autograd.grad(real_pred.sum(), real_img, create_graph=True)
    return grad.pow(2).sum() / grad.shape[0]


def path_length_penalty(imgs, styles, noise, pl_mean, decay=0.01):
    """Path-length penalty of images (N, H, W, C) with respect to the
    per-layer styles (N, n_latent, style_dim) they were made from.

    noise is (N, H, W, C) standard normal; it is divided by sqrt(H*W) here.
    Returns (penalty, lengths, new_pl_mean); new_pl_mean keeps its graph, as
    in the JAX trainer, and the caller stores it detached."""
    h, w = imgs.shape[1], imgs.shape[2]
    (grad,) = torch.autograd.grad((imgs * (noise / (h * w) ** 0.5)).sum(), styles,
                                  create_graph=True)
    lengths = torch.sqrt(grad.pow(2).sum((1, 2)) + 1e-12)
    new_mean = pl_mean + decay * (lengths.mean() - pl_mean)
    return (lengths - new_mean).pow(2).mean(), lengths, new_mean
