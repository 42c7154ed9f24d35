"""The fused GAN train step of the SNGAN, MNIST DCGAN and toy paths
(counterpart of `make_fused_step` in diagan_tpu/train/steps.py), as an eager
loop.

One step, in the JAX package's order (reference trainer.py:238-291):
n_dis iterations, each
  1. a D update on a real batch (weighted draws in phase 2) and fakes from G
     in train mode on batch statistics, without advancing G's running
     statistics; D(real) and D(fake) each advance D's spectral-norm u and
     D's BatchNorm running statistics (the DCGAN's), in that order;
  2. in phase 2, the same update of the twin DRS discriminator on uniform
     draws with its own fakes and the ns loss;
  3. on the last iteration, the G update: G advances its running
     statistics, and its D forward advances D's u and D's running
     statistics (D's weights do not move).
GOLD weights D's fake terms from `gold_step` on; top-k trains G on the top
floor(rate * N) fakes, rate = max(0.99 ** epoch, 0.5).

Dropout (the DCGAN's D): the JAX step draws one dropout key per iteration
and hands it to D(real), D(fake), both forwards of the DRS discriminator and
the G step's D forward (steps.py:171-172, 202, 343, 355). Flax's masks
depend only on the key, the module path and the shape, so all of these
forwards see the same six keep masks: one draw per iteration here too, the
JAX package's behaviour (the reference's nn.Dropout draws anew on every
forward).

A step's draws come, in that order, from one object with `dropout_masks(i,
shapes, device)` (DCGAN only, first in each iteration), `indices(kind, i,
source, n)` (kind "real" or "drs"), `normal(kind, i, n, nz, device)` (kind
"z", "drs_z" or "g_z") and `uniform(kind, i, n, device)`: `GeneratorDraws`
over a torch.Generator seeded from (seed, global step), so a resumed run
repeats the uninterrupted one; a test hands in the JAX package's draws
instead.

The g_aux_loss hook (the JAX package's, steps.py:140-142, 220-221): a
callable g_aux_loss(gen, draws, i, metrics) -> loss term, called in the G
update after G's loss on D(G(z)), with G's module (its parameters carry the
gradient), the step's draws object (its kinds are the hook's own, drawn after
"g_z"), the iteration and a dict that takes the hook's metrics. Its term is
added to G's loss and its metrics join the step's. Inclusive GAN's
reconstruction and interpolation terms are one (train/inclusive.py).

Not in the port yet, and raising: the JAX package's step fusions
(concat_d, fuse_g, simultaneous_g; simultaneous_g with a hook raises
ValueError, as in the JAX package) and the SSGAN / InfoMax auxiliary terms.
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


MODELS = ("sngan", "dcgan", "toy")


def draw_keep_masks(shapes, generator, device):
    """Dropout keep masks (bool, p = 0.5), one per shape."""
    return [torch.rand(s, generator=generator, device=device) < 0.5 for s in shapes]


class GeneratorDraws:
    """A step's draws from one torch.Generator, in the order the step asks."""

    def __init__(self, generator):
        self.generator = generator

    def dropout_masks(self, i, shapes, device):
        return draw_keep_masks(shapes, self.generator, device)

    def indices(self, kind, i, source, n):
        return source.sample_indices(n, self.generator)

    def normal(self, kind, i, n, nz, device):
        return torch.randn((n, nz), generator=self.generator, device=device)

    def uniform(self, kind, i, n, device):
        return torch.rand((n,), generator=self.generator, device=device)


def seeded_generator(seed, step, device):
    """A torch.Generator on `device` seeded from (seed, step)."""
    return torch.Generator(device).manual_seed(((seed << 32) + step) % 2**63)


def step_draws(seed, global_step, device):
    """The draws of step `global_step` of a run seeded with `seed`."""
    return GeneratorDraws(seeded_generator(seed, global_step, device))


def make_fused_step(gen, disc, disc_drs, cfg: StepConfig, source, source_drs=None,
                    g_aux_loss=None):
    """gen, disc, disc_drs: train.state.NetState (disc_drs None in phase 1).
    source / source_drs: data.pipeline.DeviceDataSource (source_drs draws
    uniformly). g_aux_loss: the G-loss hook (module docstring) or None.
    Returns fused_step(global_step, draws) -> {name: metric}, the metrics as
    tensors on the device (no host sync)."""
    if cfg.simultaneous_g and g_aux_loss is not None:
        raise ValueError("simultaneous_g is incompatible with g_aux_loss hooks")
    fusions = [f for f in ("concat_d", "fuse_g", "simultaneous_g") if getattr(cfg, f)]
    if fusions:
        raise NotImplementedError(f"step fusions {fusions}: not in the port yet")
    if cfg.model not in MODELS:
        raise NotImplementedError(f"the {cfg.model} auxiliary losses: not in the port yet")
    bs, nz, device = cfg.batch_size, cfg.nz, source.device
    shapes = disc.module.dropout_shapes(bs) if cfg.model == "dcgan" else None

    def make_fakes(z):
        with torch.no_grad():
            return gen.module(z)

    def d_step(net, loss_type, real, fakes, gold, masks):
        logits_real = net.module(real, update_stats=True, **masks)[0]
        logits_fake = net.module(fakes, update_stats=True, **masks)[0]
        loss = L.d_loss(loss_type, logits_real, logits_fake, gold=gold)
        net.optim.zero_grad(set_to_none=True)
        loss.backward()
        net.apply_update()
        return {"errD": loss.detach(), "D(x)": logits_real.detach().mean(),
                "D(G(z))": logits_fake.detach().mean()}

    def g_step(z, topk_rate, masks, draws, i):
        fakes = gen.module(z, update_stats=True)
        logits_fake = disc.module(fakes, update_stats=True, **masks)[0]
        if cfg.topk:
            loss = L.masked_gen_loss(cfg.loss_type, *L.topk_filter(logits_fake, topk_rate))
        else:
            loss = L.g_loss(cfg.loss_type, logits_fake)
        aux_metrics = {}
        if g_aux_loss is not None:
            loss = loss + g_aux_loss(gen.module, draws, i, aux_metrics)
        params = list(gen.module.parameters())
        for p, g in zip(params, torch.autograd.grad(loss, params)):
            p.grad = g
        gen.apply_update()
        return {"errG": loss.detach(), **{k: v.detach() for k, v in aux_metrics.items()}}

    def fused_step(global_step, draws):
        for net in (gen, disc, disc_drs):
            if net is not None:
                net.module.train()
        gold = cfg.gold and global_step >= cfg.gold_step
        topk_rate = L.topk_rate_at(global_step, cfg.epoch_steps) if cfg.topk else 1.0
        metrics = {}
        for i in range(cfg.n_dis):
            # one set of keep masks for every D forward of the iteration
            masks = ({"dropout_masks": draws.dropout_masks(i, shapes, device)}
                     if shapes else {})
            real = source.gather(draws.indices("real", i, source, bs))
            d_metrics = d_step(disc, cfg.loss_type, real,
                               make_fakes(draws.normal("z", i, bs, nz, device)), gold, masks)
            if cfg.use_drs:
                drs_real = source_drs.gather(draws.indices("drs", i, source_drs, bs))
                drs_metrics = d_step(disc_drs, cfg.drs_loss_type, drs_real,
                                     make_fakes(draws.normal("drs_z", i, bs, nz, device)), False,
                                     masks)
                metrics["errD_drs"] = drs_metrics["errD"]
            if i == cfg.n_dis - 1:
                metrics.update(g_step(draws.normal("g_z", i, bs, nz, device), topk_rate, masks,
                                      draws, i))
            metrics.update(d_metrics)
        if cfg.topk:
            metrics["topk_rate"] = topk_rate
        return metrics

    return fused_step
