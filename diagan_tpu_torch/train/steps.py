"""The fused GAN train step of the SNGAN-family (SNGAN, SSGAN, InfoMax-GAN),
MNIST DCGAN and toy paths (counterpart of `make_fused_step` in
diagan_tpu/train/steps.py), as an eager loop.

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

The auxiliary terms, keyed on cfg.model, so the twin DRS discriminator
takes D's term too (as in the JAX package):
  - ssgan: D adds 1.0 x the rotation loss (models/losses.py) of D on the 4N
    rotated reals, G adds 0.2 x that of D on its rotated fakes; each
    rotation forward runs after the update's other D forwards, with
    update_stats=False: its power iteration starts from the u they left and
    stores nothing;
  - infomax_gan: D adds 0.2 x InfoNCE of D(real)'s projections, G 0.2 x
    InfoNCE of D(fake)'s. Under top-k the logits alone are filtered: G's
    InfoNCE runs over all N fakes, as in the JAX package (the reference's
    InfoMax top-k gathers the features by the top-k index; ROADMAP Queue C).

The step fusions (cfg, all off by default; LogTrainer's step_fusions):
  - concat_d: D(real) and D(fake) as one pass over cat(real, fakes), so one
    power iteration per D update; sngan, ssgan, infomax_gan and toy only
    (the DCGAN's BatchNorm and PacGAN couple the batch), and InfoMax's D term
    reads the real half of the aux;
  - fuse_g: one G forward (train mode, without advancing G's statistics,
    without gradient) of n_dis x B latents, twice that with the twin D,
    drawn first in the step (kind "z_all"), serves every D update, each its
    slice (main D first, then the twin's); its batch statistics span the
    fused batch, as in the JAX package; the per-iteration "z" / "drs_z" are
    then not drawn;
  - simultaneous_g (FusedProp's shared last iteration): iterations 0 ..
    n_dis - 2 are the usual D updates; the last draws its real batch and
    "z" (no "g_z"), runs G once (advancing its statistics), D(real) (u ->
    u1) and D(fakes) once (u1 -> u2, D's new state); D's loss reads D(fakes)
    as if they were detached, G's loss reads the same forward with D's
    parameters held, so each net takes its gradients of its own loss
    (torch.autograd.grad over its parameters) from one D(fakes) forward, as
    the JAX package's gd_step, whose duplicate D(fakes) forward from u1
    XLA merges. SSGAN's rotated reals (D's term) and rotated fakes (G's)
    run from u2. D and G then take one Adam step each; the twin D keeps its
    own n_dis updates. A g_aux_loss hook with simultaneous_g raises
    ValueError, as in the JAX package.

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
"z_all" (fuse_g, once, i 0), "z", "drs_z" or "g_z") and `uniform(kind, i,
n, device)`: `GeneratorDraws` over a torch.Generator seeded from (seed,
global step), so a resumed run repeats the uninterrupted one; a test hands
in the JAX package's draws instead.

The g_aux_loss hook (the JAX package's, steps.py:140-142, 220-221): a
callable g_aux_loss(gen, draws, i, metrics) -> loss term, called in the G
update after G's loss on D(G(z)), with G's module (its parameters carry the
gradient), the step's draws object (its kinds are the hook's own, drawn after
"g_z"), the iteration and a dict that takes the hook's metrics. Its term is
added to G's loss and its metrics join the step's. Inclusive GAN's
reconstruction and interpolation terms are one (train/inclusive.py).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from diagan_tpu_torch.models import losses as L
from diagan_tpu_torch.models.infomax import INFOMAX_LOSS_SCALE
from diagan_tpu_torch.models.ssgan import SS_LOSS_SCALE_D, SS_LOSS_SCALE_G


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


CONCAT_D_MODELS = ("sngan", "ssgan", "infomax_gan", "toy")  # no batch-coupled D layer


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


def _grads_to(params, grads):
    for p, g in zip(params, grads):
        p.grad = g


def make_fused_step(gen, disc, disc_drs, cfg: StepConfig, source, source_drs=None,
                    g_aux_loss=None):
    """gen, disc, disc_drs: train.state.NetState (disc_drs None in phase 1).
    source / source_drs: data.pipeline.DeviceDataSource (source_drs draws
    uniformly). g_aux_loss: the G-loss hook (module docstring) or None.
    Returns fused_step(global_step, draws) -> {name: metric}, the metrics as
    tensors on the device (no host sync)."""
    if cfg.simultaneous_g and g_aux_loss is not None:
        raise ValueError("simultaneous_g is incompatible with g_aux_loss hooks")
    bs, nz, device = cfg.batch_size, cfg.nz, source.device
    shapes = disc.module.dropout_shapes(bs) if cfg.model == "dcgan" else None
    concat_d = cfg.concat_d and cfg.model in CONCAT_D_MODELS

    def make_fakes(z):
        with torch.no_grad():
            return gen.module(z)

    def rotation_loss(module, images, masks):
        rot, labels = L.rotate_batch_4way(images)
        return L.ss_rotation_loss(module(rot, update_stats=False, **masks)[1]["ss_logits"],
                                  labels)

    def infonce(aux):
        return L.infonce_loss(aux["local_proj"], aux["global_proj"])

    def d_aux_loss(module, real, aux_real, masks):
        """D's auxiliary term: after the update's D(real) and D(fake)."""
        if cfg.model == "ssgan":
            return SS_LOSS_SCALE_D * rotation_loss(module, real, masks)
        if cfg.model == "infomax_gan":
            return INFOMAX_LOSS_SCALE * infonce(aux_real)
        return 0.0

    def g_adv_loss(logits_fake, aux_fake, fakes, topk_rate, masks):
        """G's adversarial loss on D(fakes) and its auxiliary term."""
        if cfg.topk:
            loss = L.masked_gen_loss(cfg.loss_type, *L.topk_filter(logits_fake, topk_rate))
        else:
            loss = L.g_loss(cfg.loss_type, logits_fake)
        if cfg.model == "ssgan":
            loss = loss + SS_LOSS_SCALE_G * rotation_loss(disc.module, fakes, masks)
        elif cfg.model == "infomax_gan":
            loss = loss + INFOMAX_LOSS_SCALE * infonce(aux_fake)
        return loss

    def d_step(net, loss_type, real, fakes, gold, masks):
        if concat_d:
            logits, aux = net.module(torch.cat([real, fakes]), update_stats=True)
            logits_real, logits_fake = logits[:bs], logits[bs:]
            aux_real = {k: v[:bs] for k, v in aux.items()}
        else:
            logits_real, aux_real = net.module(real, update_stats=True, **masks)
            logits_fake = net.module(fakes, update_stats=True, **masks)[0]
        loss = L.d_loss(loss_type, logits_real, logits_fake, gold=gold)
        loss = loss + d_aux_loss(net.module, real, aux_real, masks)
        net.optim.zero_grad(set_to_none=True)
        loss.backward()
        net.apply_update()
        return {"errD": loss.detach(), "D(x)": logits_real.detach().mean(),
                "D(G(z))": logits_fake.detach().mean()}

    def g_step(z, topk_rate, masks, draws, i):
        fakes = gen.module(z, update_stats=True)
        logits_fake, aux_fake = disc.module(fakes, update_stats=True, **masks)
        loss = g_adv_loss(logits_fake, aux_fake, fakes, topk_rate, masks)
        aux_metrics = {}
        if g_aux_loss is not None:
            loss = loss + g_aux_loss(gen.module, draws, i, aux_metrics)
        params = list(gen.module.parameters())
        _grads_to(params, torch.autograd.grad(loss, params))
        gen.apply_update()
        return {"errG": loss.detach(), **{k: v.detach() for k, v in aux_metrics.items()}}

    def gd_step(real, z, gold, topk_rate, masks):
        """simultaneous_g's merged last iteration (module docstring)."""
        fakes = gen.module(z, update_stats=True)
        logits_real, aux_real = disc.module(real, update_stats=True, **masks)
        logits_fake, aux_fake = disc.module(fakes, update_stats=True, **masks)
        loss_d = L.d_loss(cfg.loss_type, logits_real, logits_fake, gold=gold)
        loss_d = loss_d + d_aux_loss(disc.module, real, aux_real, masks)
        loss_g = g_adv_loss(logits_fake, aux_fake, fakes, topk_rate, masks)
        d_params, g_params = list(disc.module.parameters()), list(gen.module.parameters())
        _grads_to(d_params, torch.autograd.grad(loss_d, d_params, retain_graph=True))
        _grads_to(g_params, torch.autograd.grad(loss_g, g_params))
        disc.apply_update()
        gen.apply_update()
        return {"errD": loss_d.detach(), "errG": loss_g.detach(),
                "D(x)": logits_real.detach().mean(), "D(G(z))": logits_fake.detach().mean()}

    def fused_step(global_step, draws):
        for net in (gen, disc, disc_drs):
            if net is not None:
                net.module.train()
        gold = cfg.gold and global_step >= cfg.gold_step
        topk_rate = L.topk_rate_at(global_step, cfg.epoch_steps) if cfg.topk else 1.0
        n, metrics = cfg.n_dis, {}
        if cfg.fuse_g:
            n_fake = n * bs * (2 if cfg.use_drs else 1)
            fused = make_fakes(draws.normal("z_all", 0, n_fake, nz, device)).split(bs)
        for i in range(n):
            last = i == n - 1
            # one set of keep masks for every D forward of the iteration
            masks = ({"dropout_masks": draws.dropout_masks(i, shapes, device)}
                     if shapes else {})
            real = source.gather(draws.indices("real", i, source, bs))
            if cfg.simultaneous_g and last:
                metrics.update(gd_step(real, draws.normal("z", i, bs, nz, device), gold,
                                       topk_rate, masks))
            else:
                fakes = (fused[i] if cfg.fuse_g
                         else make_fakes(draws.normal("z", i, bs, nz, device)))
                metrics.update(d_step(disc, cfg.loss_type, real, fakes, gold, masks))
            if cfg.use_drs:
                drs_real = source_drs.gather(draws.indices("drs", i, source_drs, bs))
                drs_fakes = (fused[n + i] if cfg.fuse_g
                             else make_fakes(draws.normal("drs_z", i, bs, nz, device)))
                drs_metrics = d_step(disc_drs, cfg.drs_loss_type, drs_real, drs_fakes, False,
                                     masks)
                metrics["errD_drs"] = drs_metrics["errD"]
            if last and not cfg.simultaneous_g:
                metrics.update(g_step(draws.normal("g_z", i, bs, nz, device), topk_rate, masks,
                                      draws, i))
        if cfg.topk:
            metrics["topk_rate"] = topk_rate
        return metrics

    return fused_step
