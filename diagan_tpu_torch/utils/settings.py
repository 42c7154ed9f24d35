"""Seeding (counterpart of diagan_tpu/utils/settings.py): python's, numpy's
and torch's generators (the card's too), and PYTHONHASHSEED."""
from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_seed(seed: int):
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return seed
