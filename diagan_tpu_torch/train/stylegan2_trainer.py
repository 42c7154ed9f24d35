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

Data: the uint8 dataset lives on the card, or, in stream mode (stream_data,
by default when it is larger than hbm_data_budget, as in the JAX trainer:
FFHQ-256 is 13.76 GB), stays on the host, read-only (e.g. the npy cache's
memmap). There real batches are gathered by the native runtime
(native/diagan_io.cpp, the JAX package's own code): weighted indices from
its alias sampler seeded with `seed`, uniform ones from
np.random.default_rng(seed + 1), drawn in the order of the JAX trainer's
_host_stacks at one step per chunk (D, DRS-D, then on an R1 step the R1 D
and the R1 DRS-D), so the index stream is the JAX package's. The gathered
batch is copied to the card from pinned memory. The logit sweep then goes
by host slabs of whole batches, the same batches of 64 as the resident
sweep, so the two give the same logits bit for bit.

Data parallelism (`data_parallel`, a parallel.DataParallel; the JAX
trainer's mesh): `batch_size` is per rank, as the reference's --batch per
GPU. Each rank draws from generators keyed by its rank (rank 0 keeps the
plain run's streams), every gradient is averaged across the ranks between
backward() and the Adam step (D, R1, G and path steps), and ADA tunes on
the sum of sign(D(real)) over the ranks with the count batch x world, so p
is the same on every rank. In stream mode every rank draws the global stack
of batch x world indices from the same seeded samplers and gathers only its
own slice (the JAX trainer splits its global host stack over the mesh). The
logit sweep is sharded by contiguous blocks of batches and summed. pl_mean
stays per rank, as the JAX trainer's unsynchronised copy and the reference's
mean_path_length: rank 0 saves its own. Rank 0 alone writes checkpoints and
logits while the others wait, and a SIGTERM on any rank stops every rank
after the same step. fuse_steps=False with data parallelism raises, as in
the JAX trainer.

The TPU dispatch machinery of the JAX trainer (scanned chunks, the dispatch
envelope, per-variant programs, shard_map) has no counterpart: the card runs
the loop eagerly, one step at a time. `fuse_steps` and `max_chunk` are kept
for the CLI's surface and change nothing here; the JAX trainer keys its
draws by absolute step, so they change nothing in its result stream either.

Outputs, as the JAX trainer writes them: `checkpoint/{step:06d}.pt` (a
torch payload {g, d, g_ema, g_optim, d_optim, ada_aug_p, pl_mean, step[,
drs_d, drs_d_optim]}, which eval.evaluate.read_stylegan2_ckpt also reads)
and `logits_netD.pkl` ({step: float64[N]} from full-dataset D sweeps at
batch 64; phase 2 sweeps drs_d and writes the same file name, as the JAX
trainer does). `load_ckpt` also reads the JAX package's msgpack
checkpoints and the reference's `{iter:06d}.pt` (train/checkpoint.py
read_stylegan2_file).
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
import torch.distributed as dist

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
from diagan_tpu_torch.native import NativeWeightedSampler, gather_u8
from diagan_tpu_torch.parallel import all_reduce_grads_, all_reduce_mean_, broadcast_module, \
    rank_block
from diagan_tpu_torch.train.checkpoint import read_stylegan2_file
from diagan_tpu_torch.train.state import load_adam_moments, load_moments
from diagan_tpu_torch.train.steps import rank_seed

EMA_DECAY = 0.5 ** (32 / (10 * 1000))
SWEEP_SLAB_BYTES = 256 << 20  # host slab of a streamed logit sweep (whole batches)


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


def _read_only(images):
    """A read-only C-contiguous view of a uint8 (N, H, W, C) array (a
    memmap stays a memmap: nothing is copied when it is C-contiguous)."""
    arr = np.ascontiguousarray(images)
    if arr.dtype != np.uint8:
        raise TypeError(f"the dataset must be uint8, got {arr.dtype}")
    view = arr.view()
    view.flags.writeable = False
    return view


class _Staging:
    """Gathered uint8 batches to the device through a ring of pinned host
    buffers: each copy is asynchronous, and a buffer is refilled only after
    its previous copy has completed (its CUDA event). On the CPU the buffers
    are plain and the copy is the float conversion itself."""

    def __init__(self, shape, device, slots=8):
        self.device = device
        self.pinned = device.type == "cuda"
        self.bufs = [torch.empty(shape, dtype=torch.uint8, pin_memory=self.pinned)
                     for _ in range(slots)]
        self.events = [None] * slots
        self.i = 0

    def __call__(self, images, idx):
        """images[idx] on the device, as float32 in [-1, 1]."""
        k = self.i % len(self.bufs)
        self.i += 1
        if self.events[k] is not None:
            self.events[k].synchronize()
        buf = self.bufs[k]
        gather_u8(images, idx, out=buf.numpy())
        x = buf.to(self.device, non_blocking=self.pinned).float() / 127.5 - 1.0
        if self.pinned:
            self.events[k] = torch.cuda.Event()
            self.events[k].record()
        return x


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
        stream_data=None,  # None: stream when the dataset exceeds hbm_data_budget bytes
        hbm_data_budget=6 << 30,
        fuse_steps=True,  # the JAX trainer's dispatch options: no effect here
        max_chunk=None,
        device="cuda",
        data_parallel=None,
    ):
        """gen / disc / drs_disc: the port's StyleGAN2 modules, already on
        `device`. dataset_images: uint8 (N, H, W, 3), copied to the device,
        or in stream mode read from the host as it is. data_parallel:
        parallel.DataParallel or None (module docstring)."""
        if not fuse_steps and data_parallel is not None:
            raise NotImplementedError("fuse_steps=False requires data_parallel=None (the JAX "
                                      "trainer's mesh=None)")
        self.device = resolve_device(device)
        self.dp = data_parallel
        self.rank, self.world = (data_parallel.rank, data_parallel.world) if data_parallel \
            else (0, 1)
        self.is_main = self.rank == 0
        self.output_path = Path(output_path)
        if self.is_main:
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

        self.fuse_steps = bool(fuse_steps)
        self.max_chunk = int(max_chunk) if max_chunk else None
        self.num_data = len(dataset_images)
        if stream_data is None:
            stream_data = dataset_images.nbytes > hbm_data_budget
        self.stream = bool(stream_data)
        if self.stream:
            self.images = None
            self.images_np = _read_only(dataset_images)
            # the JAX trainer's streams: the alias sampler over the raw
            # scores, seeded with `seed`; uniform draws from seed + 1
            self._w_sampler = (NativeWeightedSampler(sample_weights, seed=seed)
                               if sample_weights is not None else None)
            self._u_rng = np.random.default_rng(seed + 1)
            self._staging = _Staging((batch_size,) + self.images_np.shape[1:], self.device)
        else:
            self.images = _to_device_u8(dataset_images, self.device)
        self.weights = (weights_from_scores(sample_weights, self.device)
                        if sample_weights is not None else None)

        if data_parallel is not None:  # every replica starts from rank 0's nets
            for m in self._modules(gen, disc, drs_disc):
                broadcast_module(m, data_parallel)
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

        seed_r = rank_seed(seed, self.rank)
        self.rng = torch.Generator(self.device).manual_seed(seed_r)  # device draws
        self.host_rng = torch.Generator().manual_seed(seed_r)  # cutoff, ADA matrices
        self.logit_results = {}
        self.metrics = {}  # the last step's metrics, r1/path from the last reg step

    @staticmethod
    def _modules(*mods):
        return [m for m in mods if m is not None]

    def _reduce_grads(self, module):
        """Average `module`'s gradients across the ranks (data parallelism)."""
        if self.dp is not None:
            all_reduce_grads_(module, self.dp)

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
        if self.stream:  # the global stack's indices, this rank's slice gathered
            bs, n = self.batch_size, self.batch_size * self.world
            if weighted and self._w_sampler is not None:
                idx = self._w_sampler.sample(n)
            else:
                idx = self._u_rng.integers(0, self.num_data, n)
            return self._staging(self.images_np, idx[self.rank * bs:(self.rank + 1) * bs])
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
        self._reduce_grads(disc)
        optim.step()
        rp = rp.detach()
        return {"d": loss.detach(), "real_score": rp.mean(), "fake_score": fp.detach().mean(),
                "sign_real": torch.sign(rp).sum()}

    def r1_step(self, disc, optim, real, aug):
        real = self._augment(real, aug).detach().requires_grad_(True)
        pen = r1_penalty(disc(real)[0], real)
        optim.zero_grad(set_to_none=True)
        (self.r1_weight / 2 * pen * self.d_reg_every).backward()
        self._reduce_grads(disc)
        optim.step()
        return {"r1": pen.detach()}

    def g_step(self, fake_draws, aug):
        self.disc.requires_grad_(False)  # D takes no gradient in the G step
        try:
            loss = g_nonsaturating_loss(self.disc(self._augment(self._fake(fake_draws), aug))[0])
            self.g_optim.zero_grad(set_to_none=True)
            loss.backward()
            self._reduce_grads(self.gen)
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
        self._reduce_grads(self.gen)
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
    def _sweep_batches(self, batch, first, last):
        """The sweep's real batches `first` .. `last` - 1: `batch` consecutive
        indices each, the last batch padded with the last index (the
        minibatch-stddev groups then match the JAX sweep's). In stream mode
        they come in host slabs of whole batches, one copy to the device a
        slab."""
        n = self.num_data
        if not self.stream:
            for b in range(first, last):
                idx = torch.arange(b * batch, (b + 1) * batch,
                                   device=self.device).clamp_(max=n - 1)
                yield self.real_batch(idx)
            return
        per_slab = max(1, SWEEP_SLAB_BYTES // (batch * self.images_np[0].nbytes))
        for b0 in range(first, last, per_slab):
            nb = min(per_slab, last - b0)
            idx = np.arange(b0 * batch, (b0 + nb) * batch).clip(max=n - 1)
            slab = torch.from_numpy(gather_u8(self.images_np, idx)).to(self.device)
            for b in range(nb):
                yield slab[b * batch:(b + 1) * batch].float() / 127.5 - 1.0

    @torch.no_grad()
    def _record_logits(self, step, batch=64):
        """Full-dataset sweep of D (phase 1) or drs_d (phase 2), batch by
        batch (`_sweep_batches`); under data parallelism each rank sweeps
        its contiguous block of batches and the disjoint rows are summed."""
        disc = self.drs_disc if self.drs_disc is not None else self.disc
        name = "netD_drs" if self.drs_disc is not None else "netD"
        n = self.num_data
        n_batches = -(-n // batch)
        first, last = rank_block(n_batches, self.rank, self.world)
        row = torch.zeros(n, dtype=torch.float32, device=self.device)
        out = [disc(x)[0] for x in self._sweep_batches(batch, first, last)]
        if out:
            lo, hi = first * batch, min(last * batch, n)
            row[lo:hi] = torch.cat(out)[:hi - lo]
        if self.dp is not None:
            dist.all_reduce(row, group=self.dp.group)
        self.logit_results.setdefault(f"{name}_eval", {})[step] = row.double().cpu().numpy()

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

    def _flush(self, step):
        """Rank 0 writes the checkpoint and logits while the others wait."""
        if self.is_main:
            self._save_ckpt(step)
        if self.dp is not None:
            self.dp.barrier()

    def find_latest_ckpt(self):
        d = self.output_path / "checkpoint"
        cands = sorted(d.glob("*.pt")) if d.is_dir() else []
        return cands[-1] if cands else None

    def load_ckpt(self, path):
        """Restore weights, EMA, Adam moments, ada_aug_p and pl_mean from the
        port's own checkpoint, the JAX package's msgpack one or the
        reference's `{iter:06d}.pt` (read_stylegan2_file). drs_d falls back
        to d (a phase-1 checkpoint), and its optimizer stays fresh unless the
        checkpoint has one; a reference file keeps fresh moments, a missing
        g_ema falls back to g. Returns the checkpoint's step."""
        raw = read_stylegan2_file(path)
        self.gen.load_state_dict(raw["g"])
        self.disc.load_state_dict(raw["d"])
        self.g_ema.load_state_dict(raw.get("g_ema", raw["g"]))
        for optim, key, module in ((self.g_optim, "g_optim", self.gen),
                                   (self.d_optim, "d_optim", self.disc),
                                   (self.drs_optim, "drs_d_optim", self.drs_disc)):
            if optim is not None and key in raw:
                if raw["format"] == "port":
                    load_moments(optim, raw[key])
                else:
                    load_adam_moments(optim, module, raw[key])
        self.pl_mean = torch.tensor(float(raw.get("pl_mean", 0.0)), device=self.device)
        if self.drs_disc is not None:
            self.drs_disc.load_state_dict(raw.get("drs_d", raw["d"]))
        self.ada_aug_p = float(raw.get("ada_aug_p", 0.0))
        if self.ada is not None:
            self.ada.ada_aug_p = self.ada_aug_p
        if self.dp is not None:  # every replica resumes from rank 0's nets
            for m in self._modules(self.gen, self.disc, self.drs_disc, self.g_ema):
                broadcast_module(m, self.dp)
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
            while self._step < self.num_steps and not self._stopping(stop["flag"]):
                metrics = self.train_step(self._step)
                self._step += 1
                if self.ada is not None:
                    self.tune_ada(metrics)
                self._after_step(self._step, metrics)
            if self._step < self.num_steps:
                print(f"INFO: SIGTERM, flushing checkpoint at step {self._step}", flush=True)
                self._flush(self._step)
            else:
                self._flush(self.num_steps)
        except KeyboardInterrupt:
            print("INFO: Saving checkpoints from keyboard interrupt...", flush=True)
            self._flush(self._step)
        finally:
            signal.signal(signal.SIGTERM, old_handler)
        return self

    def tune_ada(self, metrics):
        """Adaptive ADA's update from one step's metrics: sign_real summed
        over the ranks (replaced in `metrics`), with the count batch x world,
        so p is the same on every rank."""
        if self.dp is not None:
            metrics["sign_real"] = metrics["sign_real"].clone()
            dist.all_reduce(metrics["sign_real"], group=self.dp.group)
        self.ada_aug_p = self.ada.tune(float(metrics["sign_real"]), self.batch_size * self.world)

    def _stopping(self, flag):
        """The SIGTERM flag, on every rank if any rank has it."""
        return self.dp.any(flag) if self.dp is not None else flag

    def _after_step(self, step, metrics):
        self.metrics.update({k: v for k, v in metrics.items() if k != "sign_real"})
        if step % self.log_every == 0:
            if self.dp is not None:  # the logged metrics averaged over the ranks
                all_reduce_mean_(list(self.metrics.values()), self.dp)
            # sorted keys, as the JAX trainer's pytree metrics print
            # (scripts/soak_report.py reads path before r1)
            parts = "; ".join(f"{k}: {float(self.metrics[k]):.4f}" for k in sorted(self.metrics))
            if self.is_main:
                print(f"step {step}: {parts}; ada_p: {self.ada_aug_p:.4f}", flush=True)
        if (self.logit_save_steps and step % self.logit_save_steps == 0
                and self.save_logit_after <= step <= self.stop_save_logit_after
                and step < self.num_steps):
            self._record_logits(step)
        if step % self.save_every == 0 and step < self.num_steps:
            self._flush(step)
