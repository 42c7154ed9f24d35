"""Per-example logit recorder, the phase-1 diagnosis instrument
(counterpart of diagan_tpu/train/logit_recorder.py).

Every sweep runs the whole dataset through D (eval mode, update_stats off:
D's state never moves) and writes one row of a [snapshots, N] fp32 buffer
on the device. The sweep walks the dataset in order, in batches of
`batch_size` with a shorter last one (the JAX package pads the last batch
and masks it; D has no batch coupling in eval mode, so the row is the same
either way). Only pickling touches the host: `as_dict` gives the reference's
{int step: np.float64[N]}, `save` pickles it, and `state_dict` /
`load_state_dict` carry the buffer through a checkpoint.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch


class LogitRecorder:
    def __init__(self, num_data, max_snapshots, batch_size=256, device="cuda"):
        self.num_data = num_data
        self.max_snapshots = max_snapshots
        self.batch_size = batch_size
        self.buffer = torch.zeros((max_snapshots, num_data), dtype=torch.float32, device=device)
        self.steps = np.full((max_snapshots,), -1, np.int64)
        self.count = 0

    @torch.no_grad()
    def sweep(self, disc, source):
        """One fp32 row of D's logits over the whole dataset, D in eval mode."""
        was_training = disc.training
        disc.eval()
        row = torch.empty(self.num_data, dtype=torch.float32, device=self.buffer.device)
        for lo in range(0, self.num_data, self.batch_size):
            idx = torch.arange(lo, min(lo + self.batch_size, self.num_data),
                               device=source.device)
            row[lo:lo + len(idx)] = disc(source.gather(idx))[0]
        disc.train(was_training)
        return row

    def record(self, disc, source, global_step):
        """Sweep and store the row in the next buffer slot."""
        if self.count >= self.max_snapshots:
            raise RuntimeError("logit buffer full; raise max_snapshots")
        self.buffer[self.count] = self.sweep(disc, source)
        self.steps[self.count] = int(global_step)
        self.count += 1

    def as_dict(self) -> dict:
        """Reference pickle format: {global_step: float64[N]}."""
        buf = self.buffer[: self.count].cpu().numpy().astype(np.float64)
        return {int(s): buf[i] for i, s in enumerate(self.steps[: self.count])}

    def save(self, path):
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(self.as_dict(), f)

    def state_dict(self):
        return {"buffer": self.buffer.cpu().numpy(), "steps": self.steps.copy(),
                "count": self.count}

    def load_state_dict(self, d):
        self.buffer = torch.as_tensor(np.asarray(d["buffer"]), dtype=torch.float32,
                                      device=self.buffer.device)
        self.steps = np.asarray(d["steps"]).copy()
        self.count = int(d["count"])
