"""GAN losses: StyleGAN2's losses and regularisers (counterparts of the
StyleGAN2 part of diagan_tpu/models/losses.py and of the penalties in
diagan_tpu/train/stylegan2_trainer.py), and the SNGAN family's hinge, ns /
minimax and wasserstein losses with GOLD's fake-term weights and top-k."""
from __future__ import annotations

import numpy as np
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


# ---- SNGAN-family losses (counterparts of the torch-mimicry part of
# diagan_tpu/models/losses.py and of `_d_loss` in diagan_tpu/train/steps.py)

def bce_with_logits(logits, label):
    """Elementwise, in the JAX package's stable form."""
    return torch.clamp_min(logits, 0) - logits * label + torch.log1p(torch.exp(-logits.abs()))


def d_loss(loss_type, logits_real, logits_fake, gold=False):
    """The discriminator's loss: hinge, ns / minimax or wasserstein. With gold,
    each fake term is weighted by its own logit without gradient (GOLD's
    weight, reference gold_reweight_models.py:10-13: the raw logit, not a
    probability)."""
    if loss_type == "hinge":
        real_term = torch.clamp_min(1.0 - logits_real, 0).mean()
        fake_per = torch.clamp_min(1.0 + logits_fake, 0)
    elif loss_type in ("ns", "minimax"):
        real_term = bce_with_logits(logits_real, 1.0).mean()
        fake_per = bce_with_logits(logits_fake, 0.0)
    elif loss_type == "wasserstein":
        real_term = -logits_real.mean()
        fake_per = logits_fake
    else:
        raise ValueError(loss_type)
    if gold:
        fake_per = logits_fake.detach() * fake_per
    return real_term + fake_per.mean()


def _gen_per_example(loss_type, logits_fake):
    if loss_type in ("hinge", "wasserstein"):
        return -logits_fake
    if loss_type in ("ns", "minimax"):
        return bce_with_logits(logits_fake, 1.0)
    raise ValueError(loss_type)


def g_loss(loss_type, logits_fake):
    return _gen_per_example(loss_type, logits_fake).mean()


def topk_rate_at(step, epoch_steps, decay_rate=0.99, min_rate=0.5):
    """max(0.99 ** (step // epoch_steps), 0.5) (reference topk_models.py:22-28),
    in fp32 as the JAX package computes it."""
    epoch = np.float32(step // epoch_steps)
    return float(max(np.float32(decay_rate) ** epoch, np.float32(min_rate)))


def topk_filter(logits_fake, topk_rate):
    """The fake logits sorted in descending order and a mask that keeps the
    first floor(rate * N) of them (reference topk_models.py:29-37)."""
    n = logits_fake.shape[0]
    sorted_logits = torch.sort(logits_fake.reshape(-1), descending=True).values
    k = int(np.floor(np.float32(topk_rate) * np.float32(n)))
    mask = (torch.arange(n, device=logits_fake.device) < k).to(sorted_logits.dtype)
    return sorted_logits, mask


def masked_gen_loss(loss_type, sorted_logits, mask):
    """The generator's loss over the top-k masked logits."""
    per = _gen_per_example(loss_type, sorted_logits)
    return (per * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
