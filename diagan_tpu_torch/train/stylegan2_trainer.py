"""StyleGAN2 + ADA trainer, phases 1 and 2.

Counterpart of diagan_tpu/train/stylegan2_trainer.py, as a plain loop of one
step at a time. A step runs, in the JAX trainer's order (`full_step`):
  1. the D step on weighted reals, reals and fakes augmented with separate
     draws, fakes from G under no_grad;
  2. in phase 2, the same step for the twin DRS discriminator on uniform
     reals, with its own fakes;
  3. lazy R1 when step % d_reg_every == 0 (its own real batch; weight
     r1/2 * penalty * d_reg_every);
  4. the G step through the augmented fake, then the EMA;
  5. path-length regularisation when step % g_reg_every == 0 (batch
     bs // path_batch_shrink, pl_mean decay 0.01), then the EMA again.
Adam is the regularisation-ratio Adam (lr * r, betas (0**r, 0.99**r)).
ADA's p is fixed (augment_p > 0) or adaptive (augment_p == 0, tuned from
sign(D(real)) once per step; that costs one device sync per step, which a
fixed p does not); augment_p=None turns augmentation off.

Every step method takes its random draws as arguments (latents, mixing
cutoff, noises, real batches, ADA matrices, path noise); `train_step` draws
them, latents, noises and indices on the device from one torch.Generator,
the mixing cutoff and the ADA matrices on the host from another, so tests
can inject the same draws into both packages.

The TPU dispatch machinery of the JAX trainer (scanned chunks, the dispatch
envelope, per-variant programs, shard_map, host streaming) has no
counterpart: the card runs the loop eagerly.

Outputs, as the JAX trainer writes them: `checkpoint/{step:06d}.pt` (a
torch payload {g, d, g_ema, g_optim, d_optim, ada_aug_p, pl_mean, step[,
drs_d, drs_d_optim]}, which eval.evaluate.read_stylegan2_ckpt also reads)
and `logits_netD.pkl` ({step: float64[N]} from full-dataset D sweeps at
batch 64; phase 2 sweeps drs_d and writes the same file name, as the JAX
trainer does).
"""
from __future__ import annotations

import copy
import math
import pickle
import signal
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from diagan_tpu_torch.data.sampler import (
    sample_uniform_indices,
    sample_weighted_indices,
    weights_from_scores,
)
from diagan_tpu_torch.device import resolve_device
from diagan_tpu_torch.models.ada import AdaptiveAugment, augment, pad_buckets_for, sample_augment
from diagan_tpu_torch.models.losses import (
    d_logistic_loss,
    g_nonsaturating_loss,
    path_length_penalty,
    r1_penalty,
)
from diagan_tpu_torch.train.state import load_moments

EMA_DECAY = 0.5 ** (32 / (10 * 1000))


def reg_ratio_adam(params, lr, reg_every):
    """Adam with the lazy-regularisation ratio r = k / (k + 1) applied to the
    learning rate and betas; reg_every=0 (regulariser off) means r = 1."""
    ratio = reg_every / (reg_every + 1) if reg_every else 1.0
    return torch.optim.Adam(params, lr=lr * ratio, betas=(0.0**ratio, 0.99**ratio), eps=1e-8)


def _to_device_u8(images, device, slab=1024):
    """Copy a uint8 (N, H, W, C) array (possibly a read-only memmap) to the
    device in slabs, so the host never holds a second full copy."""
    out = torch.empty(images.shape, dtype=torch.uint8, device=device)
    for lo in range(0, len(images), slab):
        out[lo:lo + slab].copy_(torch.from_numpy(np.array(images[lo:lo + slab])))
    return out


class FakeDraws(NamedTuple):
    """What one batch of fakes is made from: two latent batches (N, style_dim),
    the style-mixing cutoff (a layer index; n_latent means no mixing) and the
    per-layer noises (NHWC)."""
    z1: torch.Tensor
    z2: torch.Tensor
    cutoff: int
    noises: list


class StyleGAN2Trainer:
    def __init__(
        self,
        output_path,
        gen,
        disc,
        dataset_images,
        num_steps,
        drs_disc=None,
        sample_weights=None,
        batch_size=16,
        lr=0.002,
        r1_weight=10.0,
        path_regularize=2.0,
        d_reg_every=16,
        g_reg_every=4,
        path_batch_shrink=2,
        mixing=0.9,
        augment_p=0.0,  # None: no ADA; 0: adaptive; > 0: fixed p
        ada_target=0.6,
        ada_length=500_000,
        ada_pad_frac=0.75,
        save_every=5000,
        log_every=100,
        logit_save_steps=None,
        save_logit_after=0,
        stop_save_logit_after=10**9,
        seed=0,
        device="cuda",
    ):
        """gen / disc / drs_disc: the port's StyleGAN2 modules, already on
        `device`. dataset_images: uint8 (N, H, W, 3), copied to the device."""
        self.device = resolve_device(device)
        self.output_path = Path(output_path)
        self.output_path.mkdir(parents=True, exist_ok=True)
        self.gen, self.disc, self.drs_disc = gen, disc, drs_disc
        self.num_steps = num_steps
        self.batch_size = batch_size
        self.r1_weight = r1_weight
        self.path_regularize = path_regularize
        self.d_reg_every = d_reg_every
        self.g_reg_every = g_reg_every
        self.path_batch_shrink = path_batch_shrink
        self.mixing = mixing
        self.save_every = save_every
        self.log_every = log_every
        self.logit_save_steps = logit_save_steps
        self.save_logit_after = save_logit_after
        self.stop_save_logit_after = stop_save_logit_after
        self.size = gen.size
        self.style_dim = gen.style_dim
        self.n_latent = int(math.log2(gen.size)) * 2 - 2

        self.images = _to_device_u8(dataset_images, self.device)
        self.num_data = len(self.images)
        self.weights = (weights_from_scores(sample_weights, self.device)
                        if sample_weights is not None else None)

        self.g_ema = copy.deepcopy(gen).eval().requires_grad_(False)
        self.g_optim = reg_ratio_adam(gen.parameters(), lr, g_reg_every)
        self.d_optim = reg_ratio_adam(disc.parameters(), lr, d_reg_every)
        self.drs_optim = (reg_ratio_adam(drs_disc.parameters(), lr, d_reg_every)
                          if drs_disc is not None else None)
        self.pl_mean = torch.zeros((), device=self.device)

        self.use_augment = augment_p is not None
        self.ada_pad_frac = float(ada_pad_frac)
        self.ada_pad_buckets = pad_buckets_for(self.ada_pad_frac)
        self.ada = (AdaptiveAugment(ada_target, ada_length)
                    if self.use_augment and augment_p == 0 else None)
        self.ada_aug_p = float(augment_p) if self.use_augment else 0.0

        self.rng = torch.Generator(self.device).manual_seed(seed)  # device draws
        self.host_rng = torch.Generator().manual_seed(seed)  # cutoff, ADA matrices
        self.logit_results = {}
        self.metrics = {}  # the last step's metrics, r1/path from the last reg step

    # ------------------------------------------------------------------
    # draws
    def draw_fakes(self, n):
        z1, z2 = (torch.randn((n, self.style_dim), generator=self.rng, device=self.device)
                  for _ in range(2))
        mix = bool(torch.rand((), generator=self.host_rng) < self.mixing)
        cutoff = (int(torch.randint(1, self.n_latent, (), generator=self.host_rng))
                  if mix else self.n_latent)
        return FakeDraws(z1, z2, cutoff, self.draw_noises(n))

    def draw_noises(self, n):
        return [torch.randn(s, generator=self.rng, device=self.device)
                for s in self.gen.synthesis.noise_shapes(n)]

    def draw_real(self, weighted):
        """A batch of reals in [-1, 1], NHWC; weighted by the phase-2 scores
        when `weighted` and the trainer has them, else uniform."""
        if weighted and self.weights is not None:
            idx = sample_weighted_indices(self.weights, self.batch_size, self.rng)
        else:
            idx = sample_uniform_indices(self.num_data, self.batch_size, self.rng, self.device)
        return self.real_batch(idx)

    def real_batch(self, idx):
        return self.images[idx].float() / 127.5 - 1.0

    def draw_aug(self):
        """ADA draws (affine, colour) for one augment call, or None when the
        augment is off this step (no ADA, or p == 0)."""
        if not self.use_augment or self.ada_aug_p == 0:
            return None
        return sample_augment(self.batch_size, self.ada_aug_p, self.size, self.size,
                              self.host_rng)

    # ------------------------------------------------------------------
    # steps
    def _augment(self, x, aug):
        if aug is None:
            return x
        return augment(x, self.ada_aug_p, *aug, pad_frac=self.ada_pad_frac,
                       pad_buckets=self.ada_pad_buckets)

    def _fake(self, fd):
        return self.gen.sample([fd.z1, fd.z2], fd.cutoff, noises=fd.noises)

    def d_step(self, disc, optim, real, fake_draws, aug_real, aug_fake):
        with torch.no_grad():
            fake = self._fake(fake_draws)
        rp = disc(self._augment(real, aug_real))[0]
        fp = disc(self._augment(fake, aug_fake))[0]
        loss = d_logistic_loss(rp, fp)
        optim.zero_grad(set_to_none=True)
        loss.backward()
        optim.step()
        rp = rp.detach()
        return {"d": loss.detach(), "real_score": rp.mean(), "fake_score": fp.detach().mean(),
                "sign_real": torch.sign(rp).sum()}

    def r1_step(self, disc, optim, real, aug):
        real = self._augment(real, aug).detach().requires_grad_(True)
        pen = r1_penalty(disc(real)[0], real)
        optim.zero_grad(set_to_none=True)
        (self.r1_weight / 2 * pen * self.d_reg_every).backward()
        optim.step()
        return {"r1": pen.detach()}

    def g_step(self, fake_draws, aug):
        self.disc.requires_grad_(False)  # D takes no gradient in the G step
        try:
            loss = g_nonsaturating_loss(self.disc(self._augment(self._fake(fake_draws), aug))[0])
            self.g_optim.zero_grad(set_to_none=True)
            loss.backward()
            self.g_optim.step()
        finally:
            self.disc.requires_grad_(True)
        self.update_ema()
        return {"g": loss.detach()}

    def path_step(self, z, noises, path_noise):
        """z (M, style_dim), noises (NHWC list) and path_noise (M, H, W, 3)
        standard normal, M = bs // path_batch_shrink."""
        w = self.gen.mapping(z)
        styles = w[:, None, :].expand(-1, self.n_latent, -1)
        imgs = self.gen.synthesis(styles, noises).permute(0, 2, 3, 1)
        pen, lengths, new_mean = path_length_penalty(imgs, styles, path_noise, self.pl_mean)
        # the 0 * sum term keeps the images in the graph, as the reference does
        loss = self.path_regularize * self.g_reg_every * pen + 0.0 * imgs[:1].sum()
        self.g_optim.zero_grad(set_to_none=True)
        loss.backward()
        self.g_optim.step()
        self.pl_mean = new_mean.detach()
        self.update_ema()
        return {"path": pen.detach(), "path_length": lengths.detach().mean()}

    @torch.no_grad()
    def update_ema(self):
        ema = list(self.g_ema.parameters())
        torch._foreach_mul_(ema, EMA_DECAY)
        torch._foreach_add_(ema, list(self.gen.parameters()), alpha=1 - EMA_DECAY)

    def train_step(self, step):
        """One full step at global step `step`, with fresh draws; returns
        its metrics (device tensors)."""
        bs = self.batch_size
        m = self.d_step(self.disc, self.d_optim, self.draw_real(True), self.draw_fakes(bs),
                        self.draw_aug(), self.draw_aug())
        if self.drs_disc is not None:
            self.d_step(self.drs_disc, self.drs_optim, self.draw_real(False),
                        self.draw_fakes(bs), self.draw_aug(), self.draw_aug())
        if self.d_reg_every and step % self.d_reg_every == 0:
            m.update(self.r1_step(self.disc, self.d_optim, self.draw_real(True),
                                  self.draw_aug()))
            if self.drs_disc is not None:
                self.r1_step(self.drs_disc, self.drs_optim, self.draw_real(False),
                             self.draw_aug())
        m.update(self.g_step(self.draw_fakes(bs), self.draw_aug()))
        if self.g_reg_every and step % self.g_reg_every == 0:
            pbs = max(1, bs // self.path_batch_shrink)
            z = torch.randn((pbs, self.style_dim), generator=self.rng, device=self.device)
            noises = self.draw_noises(pbs)
            path_noise = torch.randn((pbs, self.size, self.size, 3), generator=self.rng,
                                     device=self.device)
            m.update(self.path_step(z, noises, path_noise))
        return m

    # ------------------------------------------------------------------
    # logits, checkpoints, loop
    @torch.no_grad()
    def _record_logits(self, step, batch=64):
        """Full-dataset sweep of D (phase 1) or drs_d (phase 2) in batches of
        64 consecutive indices, the last batch padded with the last index (the
        minibatch-stddev groups then match the JAX sweep's)."""
        disc = self.drs_disc if self.drs_disc is not None else self.disc
        name = "netD_drs" if self.drs_disc is not None else "netD"
        out = []
        for lo in range(0, self.num_data, batch):
            idx = torch.arange(lo, lo + batch, device=self.device).clamp_(max=self.num_data - 1)
            out.append(disc(self.real_batch(idx))[0])
        logits = torch.cat(out)[: self.num_data].double().cpu().numpy()
        self.logit_results.setdefault(f"{name}_eval", {})[step] = logits

    def _save_ckpt(self, step):
        payload = {
            "g": self.gen.state_dict(),
            "d": self.disc.state_dict(),
            "g_ema": self.g_ema.state_dict(),
            "g_optim": self.g_optim.state_dict(),
            "d_optim": self.d_optim.state_dict(),
            "ada_aug_p": float(self.ada_aug_p),
            "pl_mean": float(self.pl_mean),
            "step": int(step),
        }
        if self.drs_disc is not None:
            payload["drs_d"] = self.drs_disc.state_dict()
            payload["drs_d_optim"] = self.drs_optim.state_dict()
        path = self.output_path / "checkpoint" / f"{step:06d}.pt"
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save(payload, path)
        for nm, res in self.logit_results.items():
            # both phases write logits_netD.pkl ("netD_drs_eval" -> "netD")
            with open(self.output_path / f"logits_{nm.split('_')[0]}.pkl", "wb") as f:
                pickle.dump({k: np.float64(v) for k, v in res.items()}, f)
        return path

    def find_latest_ckpt(self):
        d = self.output_path / "checkpoint"
        cands = sorted(d.glob("*.pt")) if d.is_dir() else []
        return cands[-1] if cands else None

    def load_ckpt(self, path):
        """Restore weights, EMA, Adam moments, ada_aug_p and pl_mean; drs_d
        falls back to d (a phase-1 checkpoint), and its optimizer stays fresh
        unless the checkpoint has one. Returns the checkpoint's step."""
        raw = torch.load(path, map_location="cpu", weights_only=True)
        self.gen.load_state_dict(raw["g"])
        self.disc.load_state_dict(raw["d"])
        self.g_ema.load_state_dict(raw["g_ema"])
        load_moments(self.g_optim, raw["g_optim"])
        load_moments(self.d_optim, raw["d_optim"])
        self.pl_mean = torch.tensor(float(raw.get("pl_mean", 0.0)), device=self.device)
        if self.drs_disc is not None:
            self.drs_disc.load_state_dict(raw.get("drs_d", raw["d"]))
            if "drs_d_optim" in raw:
                load_moments(self.drs_optim, raw["drs_d_optim"])
        self.ada_aug_p = float(raw.get("ada_aug_p", 0.0))
        if self.ada is not None:
            self.ada.ada_aug_p = self.ada_aug_p
        return int(raw.get("step", 0))

    def train(self, start_step=0):
        """Run steps start_step .. num_steps - 1. SIGTERM and
        KeyboardInterrupt stop after the current step and flush a resumable
        checkpoint."""
        stop = {"flag": False}

        def on_sigterm(signum, frame):
            stop["flag"] = True

        old_handler = signal.signal(signal.SIGTERM, on_sigterm)
        self._step = start_step
        try:
            while self._step < self.num_steps and not stop["flag"]:
                metrics = self.train_step(self._step)
                self._step += 1
                if self.ada is not None:
                    self.ada_aug_p = self.ada.tune(float(metrics["sign_real"]), self.batch_size)
                self._after_step(self._step, metrics)
            if stop["flag"] and self._step < self.num_steps:
                print(f"INFO: SIGTERM, flushing checkpoint at step {self._step}", flush=True)
                self._save_ckpt(self._step)
            else:
                self._save_ckpt(self.num_steps)
        except KeyboardInterrupt:
            print("INFO: Saving checkpoints from keyboard interrupt...", flush=True)
            self._save_ckpt(self._step)
        finally:
            signal.signal(signal.SIGTERM, old_handler)
        return self

    def _after_step(self, step, metrics):
        self.metrics.update({k: v for k, v in metrics.items() if k != "sign_real"})
        if step % self.log_every == 0:
            parts = "; ".join(f"{k}: {float(v):.4f}" for k, v in self.metrics.items())
            print(f"step {step}: {parts}; ada_p: {self.ada_aug_p:.4f}", flush=True)
        if (self.logit_save_steps and step % self.logit_save_steps == 0
                and self.save_logit_after <= step <= self.stop_save_logit_after
                and step < self.num_steps):
            self._record_logits(step)
        if step % self.save_every == 0 and step < self.num_steps:
            self._save_ckpt(step)
