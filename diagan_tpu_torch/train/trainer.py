"""LogTrainer, the SNGAN path's training loop (counterpart of
diagan_tpu/train/trainer.py), as a plain loop of one fused step at a time.

As the JAX trainer (and reference diagan-pkg/diagan/trainer/trainer.py):
  - n_dis D updates per G update, the twin DRS discriminator in lock-step on
    its own uniform stream (train/steps.py);
  - linear lr decay to zero over num_steps, per net by its own update count
    (train/state.py);
  - per-example logit sweeps every `logit_save_steps` inside
    [save_logit_after, stop_save_logit_after], through netD in phase 1 and
    netD_drs in phase 2, in eval mode, or with save_eval_logits=False in
    train mode (batch statistics, live dropout: train/logit_recorder.py),
    pickled as `logits_{netD|netD_drs}_{eval|train}.pkl` at each
    checkpoint;
  - checkpoints every save_steps under checkpoints/{netG,netD,netD_drs}/ as
    `{name}_{step}_steps.pth`, plus checkpoints/logit_buffer.npz;
  - resume at global_step = max(G's step, D's step // n_dis) (each net's
    step counts its updates); netD_drs can start from netD's phase-1 file
    (weights, Adam state, update count and step). The files may also be the
    JAX package's or the reference's (train/checkpoint.py restore_net): from
    a reference file the step is its global_step and Adam starts fresh, as in
    the JAX package;
  - SIGTERM or KeyboardInterrupt stops after the current step and flushes
    the checkpoints and logit pickles;
  - scalars lr_{i} in the order [D, D_drs?, G], every log_steps;
  - every vis_steps a sample grid, or for the 25-Gaussians toy a scatter of
    1000 G points over 1000 real ones (utils/plot.py plot_gaussian_samples).

Each step's draws come from a torch.Generator seeded from (seed, step)
(train/steps.py:step_draws), so a resumed run repeats the uninterrupted one;
a train-mode sweep's keep masks from one per batch seeded from (seed + 2,
step, batch id), the toy's scatter latents from one seeded from (seed + 3,
step).

Data parallelism (`data_parallel`, a parallel.DataParallel; the JAX
trainer's `mesh`): `batch_size` stays the global batch, each rank trains
batch_size // world (indivisible raises) on its own draws (keyed by rank;
rank 0 keeps the plain run's), epoch_steps comes from the global batch, and
every gradient is averaged before each Adam step (train/state.py). Rank 0's
nets are broadcast after construction and restore. The BatchNorm running
statistics are averaged before each read (sweep, checkpoint, sample grid,
end of train()), the logged metrics at print and log steps; the sweep is
sharded (train/logit_recorder.py). Rank 0 alone writes checkpoints, the
logit buffer, pickles, scalars and grids while the others wait at a
barrier, and a SIGTERM on any rank stops every rank after the same step.
The JAX trainer's dispatch machinery (scanned chunks, the sweep folded into a
chunk, the profiler hook) has no counterpart: the card runs the loop
eagerly, and metrics reach the host only at log and print steps.
"""
from __future__ import annotations

import signal
import time
from pathlib import Path

import numpy as np
import torch

from diagan_tpu_torch.data.pipeline import DeviceDataSource
from diagan_tpu_torch.device import resolve_device
from diagan_tpu_torch.parallel import all_reduce_mean_, broadcast_module, sync_buffers
from diagan_tpu_torch.train import checkpoint as ckpt
from diagan_tpu_torch.train.logger import Logger
from diagan_tpu_torch.train.logit_recorder import LogitRecorder
from diagan_tpu_torch.train.state import NetState, make_schedule
from diagan_tpu_torch.train.steps import (
    StepConfig,
    batch_generator,
    draw_keep_masks,
    make_fused_step,
    seeded_generator,
    step_draws,
)
from diagan_tpu_torch.utils.plot import plot_gaussian_samples


class LogTrainer:
    def __init__(
        self,
        output_path,
        bundle,
        dataset,
        num_steps,
        sample_weights=None,
        dataset_drs=None,
        log_dir=None,
        n_dis=1,
        lr_decay=None,
        batch_size=64,
        netG_ckpt_file=None,
        netD_ckpt_file=None,
        netD_drs_ckpt_file=None,
        print_steps=10,
        vis_steps=500,
        log_steps=50,
        save_steps=5000,
        logit_save_steps=500,
        save_logits=True,
        topk=False,
        gold=False,
        gold_step=None,
        save_logit_after=0,
        stop_save_logit_after=100000,
        save_eval_logits=True,
        seed=0,
        weight_eps=1e-6,
        device="cuda",
        g_aux_loss=None,
        step_fusions=None,
        data_parallel=None,
    ):
        """bundle: models.registry.GANBundle (its modules are moved to
        `device`). dataset: data.arrays.ArrayDataset of uint8 images, or
        data.gaussian.GaussianDataset's float32 points. g_aux_loss: an extra
        G-loss term for the fused step (train/steps.py; Inclusive GAN's,
        train/inclusive.py), or None. step_fusions: {"concat_d", "fuse_g",
        "simultaneous_g"} -> bool for the fused step (train/steps.py), all
        off by default. data_parallel: parallel.DataParallel or None (module
        docstring)."""
        self.device = resolve_device(device)
        self.dp = data_parallel
        self.rank, self.world = (data_parallel.rank, data_parallel.world) if data_parallel \
            else (0, 1)
        self.is_main = self.rank == 0
        if batch_size % self.world:
            raise ValueError(f"batch_size {batch_size} must divide evenly over the "
                             f"{self.world} data-parallel ranks")
        self.output_path = Path(output_path)
        self.log_dir = Path(log_dir or output_path)
        self.num_steps = num_steps
        self.print_steps = print_steps
        self.vis_steps = vis_steps
        self.log_steps = log_steps
        self.save_steps = save_steps
        self.logit_save_steps = logit_save_steps
        self.save_logits = save_logits
        self.save_logit_after = save_logit_after
        self.stop_save_logit_after = stop_save_logit_after
        self.save_eval_logits = save_eval_logits
        self.gold_step = gold_step if gold_step is not None else 0
        self.bundle = bundle
        self.train_drs = bundle.disc_drs is not None
        self.seed = seed

        # ---- data, on the device ----------------------------------------
        self.source = DeviceDataSource(dataset, weights=sample_weights, eps=weight_eps,
                                       device=self.device)
        self.source_drs = (DeviceDataSource(dataset_drs or dataset, device=self.device)
                           if self.train_drs else None)
        self.num_data = len(dataset)
        self.epoch_steps = max(1, self.num_data // batch_size)

        # ---- nets and their Adam (schedules by each net's update count) --
        def net(module, spec, updates_per_step):
            return NetState(module.to(self.device), spec, num_steps, lr_decay, updates_per_step,
                            data_parallel)

        self.g = net(bundle.gen, bundle.opt_g, 1)
        self.d = net(bundle.disc, bundle.opt_d, n_dis)
        self.d_drs = net(bundle.disc_drs, bundle.opt_d_drs, n_dis) if self.train_drs else None

        # reference scalar names: lr_{i} in the order [optD, optD_drs?, optG]
        # (trainer.py:121, scheduler.py:104), by global step
        specs = [bundle.opt_d] + ([bundle.opt_d_drs] if self.train_drs else []) + [bundle.opt_g]
        self._lr_scheds = [(f"lr_{i}", make_schedule(s.lr, num_steps, lr_decay))
                           for i, s in enumerate(specs)]

        # ---- restore (phase 2: G and D from phase 1, D_drs from netD's file)
        self.global_step = 0
        if netG_ckpt_file:
            ckpt.restore_net(self.g, netG_ckpt_file)
            self.global_step = max(self.global_step, self.g.step)
        if netD_ckpt_file:
            ckpt.restore_net(self.d, netD_ckpt_file)
            self.global_step = max(self.global_step, self.d.step // max(1, n_dis))
        if netD_drs_ckpt_file and self.train_drs:
            # clone of netD's phase-1 weights (train_mimicry_phase2.py:98-101)
            ckpt.restore_net(self.d_drs, netD_drs_ckpt_file)
        if data_parallel is not None:  # every replica starts from rank 0's nets
            for m in self._modules():
                broadcast_module(m, data_parallel)

        self.cfg = StepConfig(
            n_dis=n_dis, batch_size=batch_size // self.world, nz=bundle.nz,
            loss_type=bundle.loss_type, drs_loss_type=bundle.drs_loss_type, model=bundle.model,
            gold=gold, gold_step=self.gold_step, topk=topk, epoch_steps=self.epoch_steps,
            use_drs=self.train_drs, **dict(step_fusions or {}))
        self.fused_step = make_fused_step(self.g, self.d, self.d_drs, self.cfg, self.source,
                                          self.source_drs, g_aux_loss=g_aux_loss)

        # ---- logit recorder ---------------------------------------------
        n_snaps = (stop_save_logit_after - save_logit_after) // max(1, logit_save_steps) + 2
        self.recorder = LogitRecorder(self.num_data, max(n_snaps, 2), device=self.device,
                                      data_parallel=data_parallel)
        self._record_name = "{}_{}".format("netD_drs" if self.train_drs else "netD",
                                           "eval" if save_eval_logits else "train")
        if self.global_step and save_logits:
            self._maybe_restore_logit_buffer()
        self.logger = Logger(self.log_dir) if self.is_main else None

        # sample-grid latents fixed across training (mimicry-style)
        self._vis_z = torch.randn((64, bundle.nz), device=self.device,
                                  generator=torch.Generator(self.device).manual_seed(seed + 1))

    # ------------------------------------------------------------------
    def _modules(self):
        return [n.module for n in (self.g, self.d, self.d_drs) if n is not None]

    def _sync_state(self):
        """Average the nets' BatchNorm running statistics across the ranks
        (before each read of them)."""
        if self.dp is not None:
            for m in self._modules():
                sync_buffers(m, self.dp)

    def _mean_metrics(self, metrics):
        """Average the metrics across the ranks in place (at print and log
        steps)."""
        if self.dp is not None:
            all_reduce_mean_([v for v in metrics.values() if torch.is_tensor(v)], self.dp)

    def _main_writes(self, write, *args):
        """write(*args) on rank 0 while the other ranks wait."""
        if self.is_main:
            write(*args)
        if self.dp is not None:
            self.dp.barrier()

    def _logit_window(self, step):
        return (self.save_logits and step % self.logit_save_steps == 0
                and self.save_logit_after <= step <= self.stop_save_logit_after)

    def _record_logits(self, step):
        disc = (self.d_drs if self.train_drs else self.d).module
        self._sync_state()
        self.recorder.record(disc, self.source, step, train=not self.save_eval_logits,
                             dropout_masks=lambda b, shapes: draw_keep_masks(
                                 shapes, batch_generator(self.seed + 2, step, b, self.device),
                                 self.device))

    def _save_checkpoints(self, step):
        ckpt_dir = self.log_dir / "checkpoints"
        ckpt.save_net(self.g, ckpt_dir, "netG", step)
        ckpt.save_net(self.d, ckpt_dir, "netD", step)
        if self.train_drs:
            ckpt.save_net(self.d_drs, ckpt_dir, "netD_drs", step)
        # the logit buffer rides along, so a restart in the recording window
        # loses no snapshot
        if self.save_logits and self.recorder.count:
            sd = self.recorder.state_dict()
            np.savez(ckpt_dir / "logit_buffer.npz", buffer=sd["buffer"], steps=sd["steps"],
                     count=sd["count"])

    def _maybe_restore_logit_buffer(self):
        path = self.log_dir / "checkpoints" / "logit_buffer.npz"
        if path.is_file():
            with np.load(path) as f:
                self.recorder.load_state_dict({"buffer": f["buffer"], "steps": f["steps"],
                                               "count": int(f["count"])})
            print(f"INFO: restored {self.recorder.count} logit snapshots")

    def _save_logit_pickles(self):
        if self.recorder.count:
            self.recorder.save(self.output_path / f"logits_{self._record_name}.pkl")

    def _flush(self, step):
        self._sync_state()
        self._main_writes(self._save_checkpoints, step)
        if self.save_logits and step >= self.save_logit_after:
            self._main_writes(self._save_logit_pickles)

    @torch.no_grad()
    def generate_images(self, z=None, n=64):
        gen = self.g.module
        gen.eval()
        out = gen(self._vis_z[:n] if z is None else z)
        gen.train()
        return out

    def _visualize(self, step):
        self._sync_state()
        self._main_writes(self._write_samples, step)

    def _write_samples(self, step):
        if self.bundle.image_size:
            self.logger.vis_images(step, self.generate_images().cpu().numpy())
        elif self.bundle.dataset == "25gaussian":  # reference trainer.py:318-322
            z = torch.randn((1000, self.bundle.nz), device=self.device,
                            generator=seeded_generator(self.seed + 3, step, self.device))
            plot_gaussian_samples(self.generate_images(z=z).cpu().numpy(),
                                  self.log_dir / "images", step,
                                  real_points=self.source.dataset.images[:1000])

    def _scalars(self, metrics, step):
        row = {k: float(v) for k, v in metrics.items()}
        for name, sched in self._lr_scheds:
            row[name] = float(sched(step))
        return row

    def _stopping(self, flag):
        """The SIGTERM flag, on every rank if any rank has it."""
        return self.dp.any(flag) if self.dp is not None else flag

    # ------------------------------------------------------------------
    def train(self):
        step = self.global_step
        print(f"INFO: Starting training from global step {step}...")
        interrupted = {"flag": False}

        def _on_sigterm(signum, frame):  # preemption: flush state after this step
            interrupted["flag"] = True

        old_handler = signal.signal(signal.SIGTERM, _on_sigterm)
        start_time, start_step = time.time(), step
        self.metrics = {}
        try:
            while step < self.num_steps and not self._stopping(interrupted["flag"]):
                self.metrics = self.fused_step(step, step_draws(self.seed, step, self.device,
                                                                self.rank))
                step += 1
                if step % self.log_steps == 0 or step % self.print_steps == 0:
                    self._mean_metrics(self.metrics)
                if step % self.log_steps == 0 and self.is_main:
                    self.logger.write_scalars(step, self._scalars(self.metrics, step))
                if step % self.print_steps == 0:
                    now = time.time()
                    if self.is_main:
                        self.logger.print_log(step, self.num_steps,
                                              self._scalars(self.metrics, step),
                                              (now - start_time) / max(1, step - start_step))
                    start_time, start_step = now, step
                if step % self.vis_steps == 0:
                    self._visualize(step)
                if self._logit_window(step):
                    print(f"INFO: logit saving at step {step}...")
                    self._record_logits(step)
                if step % self.save_steps == 0:
                    print("INFO: Saving checkpoints...")
                    self._flush(step)
            print("INFO: Saving final checkpoints...")
            self._flush(step)
        except KeyboardInterrupt:
            print("INFO: Saving checkpoints from keyboard interrupt...")
            self._flush(step)
        finally:
            signal.signal(signal.SIGTERM, old_handler)
            if self.logger is not None:
                self.logger.close()
        self.global_step = step
        print("INFO: Training Ended.")
        return self
