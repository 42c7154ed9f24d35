"""Discriminator Rejection Sampling (Azadi et al. 2019) as Dia-GAN runs it,
in plain torch: the running maximum of the logits (set by the warm-up
batches, then raised by each proposal batch before its test),
F = (l - max) - log(1 - exp(l - max - 1e-6)), gamma the `percentile`-th
percentile of F over the batch (linear interpolation), and each sample
accepted with probability sigmoid(F - gamma). Accepted samples leave in
their proposal order, as uint8 codes floor(clamp((x + 1) * 127.5, 0, 255)).
"""
from __future__ import annotations

import torch


def accept_prob(ldr, maximum, percentile):
    """(probabilities of acceptance (N,), the new running max); ldr (N,)
    float64 logits, maximum the running max before this batch."""
    m = max(float(maximum), float(ldr.max()))
    x = ldr - m
    F = x - torch.log(1 - torch.exp(x - 1e-6))
    gamma = torch.quantile(F, percentile / 100.0)
    return torch.sigmoid(F - gamma), m


def to_uint8(images):
    """NHWC images in [-1, 1] -> uint8 codes, as a numpy array."""
    return torch.clamp((images + 1) * 127.5, 0, 255).to(torch.uint8).cpu().numpy()


def codes(images):
    """The float codes (x + 1) * 127.5 clamped to [0, 255] of NHWC images; a
    served uint8 code c is right where c <= code < c + 1."""
    return torch.clamp((images.double() + 1) * 127.5, 0, 255)
