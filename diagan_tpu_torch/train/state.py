"""Per-network train state: a module, its Adam and its update count
(counterpart of diagan_tpu/train/state.py and of `_make_tx` in
diagan_tpu/train/trainer.py).

The learning rate follows the JAX package's schedule, which optax evaluates
at its update count *before* incrementing it: with linear decay,

    lr(count) = lr0 * max(0, 1 - (count / updates_per_step) / num_steps),

and D updates n_dis times per global step (updates_per_step = n_dis), so
its lr moves by 1/n_dis of a step on each of its updates. `apply_update`
sets each param group's lr from the net's own count before `step()`; the
count travels in the checkpoint, so a restored net (also netD_drs cloned
from netD's phase-1 file) continues its schedule and Adam's bias correction.
optax adam(b1, b2, eps=1e-8) and torch.optim.Adam are the same arithmetic.
"""
from __future__ import annotations

import torch


def linear_decay_schedule(lr, num_steps):
    """lr(step) = lr * max(0, 1 - step / num_steps) (reference
    scheduler.py:40-78)."""
    return lambda step: lr * max(0.0, 1.0 - step / num_steps)


def make_schedule(lr, num_steps, decay, updates_per_step=1):
    """lr as a function of the net's update count."""
    if decay == "linear" and num_steps:
        base = linear_decay_schedule(lr, num_steps)
        return lambda count: base(count / updates_per_step)
    return lambda count: lr


def load_moments(optim, state):
    """Restore Adam's moments and step counts but keep this run's learning
    rate and betas (a torch optimizer's state_dict also carries those; the
    JAX package's optax state does not)."""
    hyper = [{k: v for k, v in g.items() if k != "params"} for g in optim.param_groups]
    optim.load_state_dict(state)
    for group, h in zip(optim.param_groups, hyper):
        group.update(h)


def load_adam_moments(optim, module, moments):
    """Set torch Adam's state of each of `module`'s parameters from named
    moments {"count", "exp_avg": {name: tensor}, "exp_avg_sq": {...}} (a
    JAX checkpoint's optax state, utils/jax_params.py optax_adam_moments):
    exp_avg / exp_avg_sq are optax's mu / nu, count is every parameter's
    step. The lr and betas stay this run's."""
    params = dict(module.named_parameters())
    for field in ("exp_avg", "exp_avg_sq"):
        if set(moments[field]) != set(params):
            raise ValueError(f"{field}: the moments' names differ from the module's "
                             f"({sorted(set(moments[field]) ^ set(params))[:4]}...)")
    for name, p in params.items():
        optim.state[p] = {"step": torch.tensor(float(moments["count"])),
                          "exp_avg": moments["exp_avg"][name].to(p),
                          "exp_avg_sq": moments["exp_avg_sq"][name].to(p)}


class NetState:
    """A module, its Adam optimizer and its update count."""

    def __init__(self, module, spec, num_steps, decay, updates_per_step=1):
        self.module = module
        self.optim = torch.optim.Adam(module.parameters(), lr=spec.lr, betas=tuple(spec.betas),
                                      eps=1e-8)
        self.schedule = make_schedule(spec.lr, num_steps, decay, updates_per_step)
        self.count = 0

    def apply_update(self):
        """One Adam update from the gradients in .grad, at the lr of this count."""
        lr = self.schedule(self.count)
        for group in self.optim.param_groups:
            group["lr"] = lr
        self.optim.step()
        self.count += 1
