"""Per-example logit recorder, the phase-1 diagnosis instrument
(counterpart of diagan_tpu/train/logit_recorder.py).

Every sweep runs the whole dataset through D with update_stats off (D's
state never moves) and writes one row of a [snapshots, N] fp32 buffer on
the device. The sweep walks the dataset in order, in batches of
`batch_size`:
  - in eval mode (the SNGAN path's `logits_netD_eval.pkl`) the last batch is
    the shorter remainder: D has no batch coupling in eval mode, so the row
    is the one of the JAX package's padded, masked sweep;
  - in train mode (`save_eval_logits=False`, the MNIST DCGAN's phase 1 and
    its `logits_netD_train.pkl`) BatchNorm normalises by each batch's
    statistics, without moving the running ones, and dropout is live: the
    last batch is padded to `batch_size` with copies of example 0, as the
    JAX package's full_sweep_index_batches pads it (the copies enter that
    batch's statistics), and the padded lanes are dropped. Each batch takes
    fresh keep masks from `dropout_masks(batch_i, shapes)`.
Only pickling touches the host: `as_dict` gives the reference's {int step:
np.float64[N]}, `save` pickles it, and `state_dict` / `load_state_dict`
carry the buffer through a checkpoint.
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
    def sweep(self, disc, source, train=False, dropout_masks=None):
        """One fp32 row of D's logits over the whole dataset, D in eval mode,
        or in train mode with each batch's keep masks from
        dropout_masks(batch_i, shapes) (DCGAN; None: D draws its own)."""
        was_training = disc.training
        disc.train(train)
        row = torch.empty(self.num_data, dtype=torch.float32, device=self.buffer.device)
        shapes = disc.dropout_shapes(self.batch_size) if hasattr(disc, "dropout_shapes") else ()
        for b, lo in enumerate(range(0, self.num_data, self.batch_size)):
            n = min(self.batch_size, self.num_data - lo)
            idx = torch.arange(lo, lo + n, device=source.device)
            if train and n < self.batch_size:  # pad with copies of example 0
                idx = torch.cat([idx, idx.new_zeros(self.batch_size - n)])
            kwargs = {}
            if train and shapes and dropout_masks is not None:
                kwargs["dropout_masks"] = dropout_masks(b, shapes)
            row[lo:lo + n] = disc(source.gather(idx), **kwargs)[0][:n]
        disc.train(was_training)
        return row

    def record(self, disc, source, global_step, train=False, dropout_masks=None):
        """Sweep and store the row in the next buffer slot."""
        if self.count >= self.max_snapshots:
            raise RuntimeError("logit buffer full; raise max_snapshots")
        self.buffer[self.count] = self.sweep(disc, source, train, dropout_masks)
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
