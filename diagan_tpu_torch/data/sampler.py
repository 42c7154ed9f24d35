"""On-device index samplers (counterpart of diagan_tpu/data/sampler.py).

Uniform draws with replacement (`torch.randint`) for phase 1 and the twin
DRS discriminator, and weighted draws with replacement (`torch.multinomial`
over the eps-floored score weights) for phase 2, both from an explicit
torch.Generator on the dataset's device.
"""
from __future__ import annotations

import numpy as np
import torch


def weights_from_scores(weights, device, eps=1e-6):
    """Resampling weights as a float32 tensor on `device`, floored at eps
    (reference train_mimicry_phase2.py:21-23)."""
    w = np.asarray(weights, dtype=np.float32)
    return torch.from_numpy(np.where(w < eps, eps, w).astype(np.float32)).to(device)


def sample_uniform_indices(num_data, n, generator, device):
    return torch.randint(0, num_data, (n,), generator=generator, device=device)


def sample_weighted_indices(weights, n, generator):
    """n indices drawn with replacement, P(i) proportional to weights[i]."""
    return torch.multinomial(weights, n, replacement=True, generator=generator)
