"""The fused GAN train step of the SNGAN path (counterpart of
`make_fused_step` in diagan_tpu/train/steps.py), as an eager loop.

One step, in the JAX package's order (reference trainer.py:238-291):
n_dis iterations, each
  1. a D update on a real batch (weighted draws in phase 2) and fakes from G
     in train mode on batch statistics, without advancing G's running
     statistics; D(real) and D(fake) each advance D's spectral-norm u;
  2. in phase 2, the same update of the twin DRS discriminator on uniform
     draws with its own fakes and the ns loss;
  3. on the last iteration, the G update: G advances its running
     statistics, and its D forward advances D's u (D's weights do not move).
GOLD weights D's fake terms from `gold_step` on; top-k trains G on the top
floor(rate * N) fakes, rate = max(0.99 ** epoch, 0.5).

A step's draws come, in that order, from one object with `indices(kind, i,
source, n)` (kind "real" or "drs") and `normal(kind, i, n, nz, device)`
(kind "z", "drs_z" or "g_z"): `GeneratorDraws` over a torch.Generator seeded
from (seed, global step), so a resumed run repeats the uninterrupted one; a
test hands in the JAX package's draws instead.

Not in the port yet, and raising: the JAX package's step fusions
(concat_d, fuse_g, simultaneous_g) and the SSGAN / InfoMax auxiliary terms.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from diagan_tpu_torch.models import losses as L


class StepConfig(NamedTuple):
    n_dis: int
    batch_size: int
    nz: int
    loss_type: str
    drs_loss_type: str
    model: str
    gold: bool
    gold_step: int
    topk: bool
    epoch_steps: int  # dataset batches per epoch, for top-k's decay
    use_drs: bool
    concat_d: bool = False
    fuse_g: bool = False
    simultaneous_g: bool = False


class GeneratorDraws:
    """A step's draws from one torch.Generator, in the order the step asks."""

    def __init__(self, generator):
        self.generator = generator

    def indices(self, kind, i, source, n):
        return source.sample_indices(n, self.generator)

    def normal(self, kind, i, n, nz, device):
        return torch.randn((n, nz), generator=self.generator, device=device)


def step_draws(seed, global_step, device):
    """The draws of step `global_step` of a run seeded with `seed`."""
    gen = torch.Generator(device).manual_seed(((seed << 32) + global_step) % 2**63)
    return GeneratorDraws(gen)


def make_fused_step(gen, disc, disc_drs, cfg: StepConfig, source, source_drs=None):
    """gen, disc, disc_drs: train.state.NetState (disc_drs None in phase 1).
    source / source_drs: data.pipeline.DeviceDataSource (source_drs draws
    uniformly). Returns fused_step(global_step, draws) -> {name: metric},
    the metrics as tensors on the device (no host sync)."""
    fusions = [f for f in ("concat_d", "fuse_g", "simultaneous_g") if getattr(cfg, f)]
    if fusions:
        raise NotImplementedError(f"step fusions {fusions}: not in the port yet")
    if cfg.model != "sngan":
        raise NotImplementedError(f"the {cfg.model} auxiliary losses: not in the port yet")
    bs, nz, device = cfg.batch_size, cfg.nz, source.device

    def make_fakes(z):
        with torch.no_grad():
            return gen.module(z)

    def d_step(net, loss_type, real, fakes, gold):
        logits_real = net.module(real, update_stats=True)[0]
        logits_fake = net.module(fakes, update_stats=True)[0]
        loss = L.d_loss(loss_type, logits_real, logits_fake, gold=gold)
        net.optim.zero_grad(set_to_none=True)
        loss.backward()
        net.apply_update()
        return {"errD": loss.detach(), "D(x)": logits_real.detach().mean(),
                "D(G(z))": logits_fake.detach().mean()}

    def g_step(z, topk_rate):
        fakes = gen.module(z, update_stats=True)
        logits_fake = disc.module(fakes, update_stats=True)[0]
        if cfg.topk:
            loss = L.masked_gen_loss(cfg.loss_type, *L.topk_filter(logits_fake, topk_rate))
        else:
            loss = L.g_loss(cfg.loss_type, logits_fake)
        params = list(gen.module.parameters())
        for p, g in zip(params, torch.autograd.grad(loss, params)):
            p.grad = g
        gen.apply_update()
        return {"errG": loss.detach()}

    def fused_step(global_step, draws):
        for net in (gen, disc, disc_drs):
            if net is not None:
                net.module.train()
        gold = cfg.gold and global_step >= cfg.gold_step
        topk_rate = L.topk_rate_at(global_step, cfg.epoch_steps) if cfg.topk else 1.0
        metrics = {}
        for i in range(cfg.n_dis):
            real = source.gather(draws.indices("real", i, source, bs))
            d_metrics = d_step(disc, cfg.loss_type, real,
                               make_fakes(draws.normal("z", i, bs, nz, device)), gold)
            if cfg.use_drs:
                drs_real = source_drs.gather(draws.indices("drs", i, source_drs, bs))
                drs_metrics = d_step(disc_drs, cfg.drs_loss_type, drs_real,
                                     make_fakes(draws.normal("drs_z", i, bs, nz, device)), False)
                metrics["errD_drs"] = drs_metrics["errD"]
            if i == cfg.n_dis - 1:
                metrics.update(g_step(draws.normal("g_z", i, bs, nz, device), topk_rate))
            metrics.update(d_metrics)
        if cfg.topk:
            metrics["topk_rate"] = topk_rate
        return metrics

    return fused_step
