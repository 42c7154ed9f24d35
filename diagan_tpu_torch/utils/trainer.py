"""Classifier training utilities (counterpart of diagan_tpu/utils/trainer.py;
reference diagan-pkg/diagan/utils/trainer.py:4-42): a running average,
top-k accuracy in percent and an .npy writer, in numpy on the host.
"""
from __future__ import annotations

import numpy as np


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def accuracy(output, target, topk=(1,)):
    """Top-k accuracy percentages; output (N, C) logits, target (N,) (numpy
    arrays or CPU tensors)."""
    output = np.asarray(output)
    target = np.asarray(target)
    pred = np.argsort(-output, axis=1)[:, :max(topk)]
    correct = pred == target[:, None]
    return [float(correct[:, :k].any(axis=1).mean() * 100.0) for k in topk]


def save_np_arr(arr, path):
    np.save(path, np.asarray(arr))
