"""The headline benchmark of the port, on one card (counterpart of bench.py).

    python -m diagan_tpu_torch.cli.bench

Prints one JSON line on stdout, with bench.py's field names and its numbers
unrounded; the readings behind it (window spreads, FLOP parts, kernel
launches) go to stderr first.

  metric, value, unit, vs_baseline
      SNGAN-32 CIFAR-10 training steps/s (1 step = 5 D updates + 1 G update,
      batch 64): the port's fused step (train/steps.py make_fused_step) on
      50,000 seeded uint8 images held on the card, warmed over global steps
      0-49, timed over steps 50-249 with no host sync inside the window;
      vs_baseline divides by bench.py's 8.0 steps/s.
  flops_per_step, mfu_pct, mfu_peak_tflops
      GFLOP of one fused step, counted by FlopCounterMode over one untimed
      step after the window (matmul and convolution MACs x 2, the direct-
      convolution basis, forward and backward as autograd runs them), and
      steps/s x FLOPs over the fp32 peak the step computes at: 67 TFLOP/s.
  drs_samples_per_sec
      DRS accepted samples/s (eval/drs.py, batch 256, gamma the 80th
      percentile) over the trained SNGAN G and D: warmed by 2,048 samples,
      timed over a quota of 50,000.
  sg2_256_ms_per_step, sg2_256_img_per_sec; sg2_256_ada_ms_per_step,
  sg2_256_ada_img_per_sec
      StyleGAN2-256 training in bf16 (synthesis and D backbone; --bf16 of
      cli.train_ffhq), batch 16, on 512 seeded uint8 images, at ADA p pinned
      to 0 and to 0.05: global steps 25-49 (2 R1 steps, 6 path-length steps,
      19 plain) through StyleGAN2Trainer.train_step, warmed by the same 25
      steps, no ADA tuning.
  sg2_256_gflop_per_step, sg2_256_mfu_pct, sg2_256_mfu_peak_tflops
      At (256, 16) only, as bench.py: FLOPs on the amortised basis d + g +
      r1/16 + path/4, each sub-step counted once by FlopCounterMode after the
      p = 0 window; MFU of the p = 0 step against the bf16 dense peak, 989
      TFLOP/s. None at p = 0.05: augmentation adds work that basis leaves out.
  device, precision
      nvidia-smi's name and power limit of the card, and the device count;
      the precision of each part.

The port's own kernels (kernel A, the fused act, the warp pair) launch
through ctypes and Triton, which FlopCounterMode does not see: like bench.py's
basis, the counts leave the FIR taps out.

Not carried over from bench.py: the retry after 90 s (it served a shared TPU
worker's crashes; a failure here must fail); every best-effort `except` (a
part that fails raises, and the CLI exits non-zero); `_compare_with_previous`
(BENCH_r*.json holds TPU rounds, which no number of this card is compared
with); the JAX compilation cache; PEAK_TFLOPS (TPU peaks). It measures only
on the card: without one it raises, and it has no CPU mode. The measuring
functions take the device and their counts, so tests run them on the CPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode, conv_flop_count

from diagan_tpu_torch.data.arrays import ArrayDataset
from diagan_tpu_torch.data.pipeline import DeviceDataSource
from diagan_tpu_torch.device import pin_fp32_precision, resolve_device
from diagan_tpu_torch.eval.drs import DRS
from diagan_tpu_torch.eval.evaluate import make_disc_fn, make_gen_fn
from diagan_tpu_torch.models.registry import get_gan_model
from diagan_tpu_torch.models.stylegan2 import StyleGAN2Discriminator, StyleGAN2Generator
from diagan_tpu_torch.ops import _build
from diagan_tpu_torch.train.state import NetState
from diagan_tpu_torch.train.steps import StepConfig, make_fused_step, step_draws
from diagan_tpu_torch.train.stylegan2_trainer import StyleGAN2Trainer

# BASELINE.md's estimate for the reference PyTorch stack (torch-mimicry
# SNGAN-32) on one A100; no measured number exists. Not a TPU number.
BASELINE_STEPS_PER_SEC_A100 = 8.0
FP32_PEAK_TFLOPS = 67.0  # H100 SXM, IEEE fp32 outside the tensor cores
BF16_PEAK_TFLOPS = 989.0  # H100 SXM, bf16 dense on the tensor cores
# XLA's counts of the JAX package's SNGAN-32 step and amortised
# StyleGAN2-256 step (bench.py, BASELINE.md), printed beside the port's own
# counts; never used as the port's basis
JAX_SNGAN_GFLOP, JAX_SG2_GFLOP = 2672.85, 19148.8

SEED = 0  # weights, images and draws
CHUNK = 50  # the JAX bench's scanned chunk: the SNGAN warm-up, a quarter of its window
SNGAN_N, SNGAN_BS, SNGAN_NDIS, SNGAN_NUM_STEPS = 50_000, 64, 5, 50_000
DRS_BS, DRS_WARM, DRS_QUOTA, DRS_SEED = 256, 2048, 50_000, 11
SG2_SIZE, SG2_BATCH, SG2_STEPS, SG2_N = 256, 16, 25, 512
SG2_ADA_P = 0.05  # the ADA-live operating point of a real FFHQ run
PRECISION = {"sngan": "fp32 (IEEE, TF32 off)", "drs": "fp32 (IEEE, TF32 off)",
             "sg2_256": "bf16"}


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mark(device):
    """A point in a window: a recorded CUDA event on the card (no host sync),
    the host clock elsewhere."""
    if device.type != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _seconds(a, b):
    return b - a if isinstance(a, float) else a.elapsed_time(b) / 1e3


def _mv_flop(a_shape, b_shape, *args, out_shape=None, **kwargs):
    return 2 * a_shape[0] * a_shape[1]


def _dot_flop(a_shape, b_shape, *args, out_shape=None, **kwargs):
    return 2 * a_shape[0]


class _Global:
    """A stand-in for FlopCounterMode's module tracker that books every count
    under "Global": the tracker's backward hooks refuse torch.autograd.grad
    with respect to a leaf (R1's reals)."""
    parents = {"Global"}

    def __enter__(self):
        return self

    def __exit__(self, *args):
        return False


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, bias, stride, padding, dilation,
                        transposed, output_padding, groups, output_mask, out_shape=None,
                        **kwargs):
    """The input's and the weight's gradients each cost the forward's MACs
    (FlopCounterMode's own formula counts a grouped convolution's weight
    gradient `groups` times over)."""
    return conv_flop_count(x_shape, w_shape, grad_out_shape, transposed) * (
        bool(output_mask[0]) + bool(output_mask[1]))


def count_flops(fn):
    """(fn(), the FLOPs of its matmuls and convolutions): FlopCounterMode's
    formulas, plus matrix-vector and dot products (the spectral norm's power
    iteration), which it does not count, and a convolution's backward that
    counts groups right."""
    aten = torch.ops.aten
    counter = FlopCounterMode(display=False, custom_mapping={
        aten.mv: _mv_flop, aten.dot: _dot_flop, aten.convolution_backward: _conv_backward_flop})
    counter.mod_tracker = _Global()
    with counter:
        out = fn()
    return out, counter.get_total_flops()


def launches():
    """The port's kernel launches since the counts were last zeroed."""
    return {"kernels": {k: v for k, v in _build.LAUNCHES.items() if v},
            "fir": {k: v for k, v in _build.FIR_INSTANCES.items() if v},
            "bf16": dict(_build.BF16_LAUNCHES)}


# --- SNGAN-32 -----------------------------------------------------------------
def sngan_setup(device, n_data=SNGAN_N, batch_size=SNGAN_BS, n_dis=SNGAN_NDIS):
    """bench.py's SNGAN-32 setup on `device`: the cifar10 hinge bundle,
    n_data uint8 images on the device, G and D on linear lr decay over
    SNGAN_NUM_STEPS steps (D's over n_dis updates a step), the fused step
    without the twin D; all from SEED. Returns a namespace (bundle, g, d,
    fused)."""
    torch.manual_seed(SEED)
    bundle = get_gan_model("cifar10", model="sngan", loss_type="hinge", device=device)
    images = np.random.default_rng(SEED).integers(0, 255, (n_data, 32, 32, 3), dtype=np.uint8)
    source = DeviceDataSource(ArrayDataset.from_images(images), device=device)
    g = NetState(bundle.gen, bundle.opt_g, SNGAN_NUM_STEPS, "linear", 1)
    d = NetState(bundle.disc, bundle.opt_d, SNGAN_NUM_STEPS, "linear", n_dis)
    cfg = StepConfig(n_dis=n_dis, batch_size=batch_size, nz=bundle.nz, loss_type="hinge",
                     drs_loss_type="ns", model="sngan", gold=False, gold_step=0, topk=False,
                     epoch_steps=n_data // batch_size, use_drs=False)
    return SimpleNamespace(bundle=bundle, g=g, d=d, fused=make_fused_step(g, d, None, cfg, source))


def sngan_steps(sn, device, first, n):
    """Global steps first .. first + n - 1, with the trainer's draws."""
    for step in range(first, first + n):
        sn.fused(step, step_draws(SEED, step, device))


def sngan_measure(sn, device, warm=CHUNK, timed=4 * CHUNK):
    """Steps/s over global steps warm .. warm + timed - 1, after an untimed
    window of steps 0 .. warm - 1. The host clock stops on a synchronize
    after the last step; the window makes no host sync. Returns (steps/s,
    steps/s of each chunk of CHUNK steps, from the marks between them)."""
    sngan_steps(sn, device, 0, warm)
    _sync(device)
    marks = [_mark(device)]
    t0 = time.perf_counter()
    for first in range(warm, warm + timed, CHUNK):
        n = min(CHUNK, warm + timed - first)
        sngan_steps(sn, device, first, n)
        marks.append((n, _mark(device)))
    _sync(device)
    dt = time.perf_counter() - t0
    prev, per_chunk = marks[0], []
    for n, mark in marks[1:]:
        per_chunk.append(n / _seconds(prev, mark))
        prev = mark
    return timed / dt, per_chunk


def sngan_flops(sn, device, step):
    """FLOPs of one fused step at global step `step` (it trains the nets)."""
    return count_flops(lambda: sngan_steps(sn, device, step, 1))[1]


# --- DRS --------------------------------------------------------------------
def drs_measure(gen, disc, nz, device, quota=DRS_QUOTA):
    """Accepted samples/s of DRS over `gen` / `disc` (eval mode, batch
    DRS_BS), uint8 out: untimed, the sampler's warm-up batches and DRS_WARM
    samples (they also move the logits' running max); timed, a quota of
    `quota`. Returns (samples/s, acceptance over the quota)."""
    sampler = DRS(make_gen_fn(gen), make_disc_fn(disc), nz,
                  generator=torch.Generator(device).manual_seed(DRS_SEED), batch_size=DRS_BS,
                  device=device)
    sampler.generate_images(DRS_WARM, return_uint8=True)
    _sync(device)
    proposed, accepted = sampler.proposed, sampler.accepted
    t0 = time.perf_counter()
    imgs = sampler.generate_images(quota, return_uint8=True)
    dt = time.perf_counter() - t0
    if len(imgs) != quota:
        raise RuntimeError(f"DRS returned {len(imgs)} samples for a quota of {quota}")
    return quota / dt, (sampler.accepted - accepted) / (sampler.proposed - proposed)


# --- StyleGAN2-256 ------------------------------------------------------------
def sg2_trainer(device, out_dir, size=SG2_SIZE, batch=SG2_BATCH, n_images=SG2_N):
    """bench.py's StyleGAN2 trainer: bf16 synthesis and D backbone, n_images
    uint8 images on the device, all from SEED; adaptive ADA (augment_p 0;
    each measurement pins p). Only train() writes to out_dir, and the bench
    calls train_step."""
    images = np.random.default_rng(SEED).integers(0, 255, (n_images, size, size, 3), np.uint8)
    torch.manual_seed(SEED)
    gen = StyleGAN2Generator(size=size, dtype=torch.bfloat16, device=device)
    disc = StyleGAN2Discriminator(size=size, dtype=torch.bfloat16, device=device)
    return StyleGAN2Trainer(out_dir, gen, disc, images, num_steps=2 * SG2_STEPS,
                            batch_size=batch, seed=SEED, augment_p=0.0, device=device)


def sg2_measure(tr, steps, ada_p):
    """Seconds a step of global steps steps .. 2 steps - 1 at ADA p pinned to
    ada_p: the JAX bench's chunk from start_step = steps, run once untimed,
    then timed; no ADA tuning. Returns (s/step, [s of each step] from the
    marks between steps)."""
    tr.ada_aug_p = float(ada_p)
    window = range(steps, 2 * steps)
    for step in window:
        tr.train_step(step)
    _sync(tr.device)
    marks = [_mark(tr.device)]
    t0 = time.perf_counter()
    for step in window:
        tr.train_step(step)
        marks.append(_mark(tr.device))
    _sync(tr.device)
    dt = time.perf_counter() - t0
    return dt / steps, [_seconds(a, b) for a, b in zip(marks, marks[1:])]


def sg2_substeps(tr):
    """One call each of the sub-steps of StyleGAN2Trainer.train_step (D, R1,
    G, path length), with fresh draws as train_step makes them."""
    bs = tr.batch_size

    def path():
        pbs = max(1, bs // tr.path_batch_shrink)
        z = torch.randn((pbs, tr.style_dim), generator=tr.rng, device=tr.device)
        noises = tr.draw_noises(pbs)
        noise = torch.randn((pbs, tr.size, tr.size, 3), generator=tr.rng, device=tr.device)
        return tr.path_step(z, noises, noise)

    return {
        "d": lambda: tr.d_step(tr.disc, tr.d_optim, tr.draw_real(True), tr.draw_fakes(bs),
                               tr.draw_aug(), tr.draw_aug()),
        "r1": lambda: tr.r1_step(tr.disc, tr.d_optim, tr.draw_real(True), tr.draw_aug()),
        "g": lambda: tr.g_step(tr.draw_fakes(bs), tr.draw_aug()),
        "path": path,
    }


def sg2_flops(tr):
    """FLOPs of each sub-step, counted once (they train the nets), and the
    amortised step d + g + r1 / d_reg_every + path / g_reg_every."""
    parts = {name: count_flops(fn)[1] for name, fn in sg2_substeps(tr).items()}
    parts["amortised"] = (parts["d"] + parts["g"] + parts["r1"] / tr.d_reg_every
                          + parts["path"] / tr.g_reg_every)
    return parts


def step_kind(tr, step):
    """What train_step runs at global step `step`: plain, path, r1 or r1+path."""
    r1 = tr.d_reg_every and step % tr.d_reg_every == 0
    path = tr.g_reg_every and step % tr.g_reg_every == 0
    return "r1+path" if r1 and path else "r1" if r1 else "path" if path else "plain"


def _spread(values):
    v = sorted(values)
    return f"min {v[0]:.2f} median {v[len(v) // 2]:.2f} max {v[-1]:.2f}"


# --- the line -----------------------------------------------------------------
def headline(device, card, sngan_warm=CHUNK, sngan_timed=4 * CHUNK, drs_quota=DRS_QUOTA):
    """Measure every part on `device`; returns (the line, the port's kernel
    launches of each part). card: the line's `device` field. StyleGAN2's FLOP
    and MFU fields are written at (SG2_SIZE, SG2_BATCH) only, as in bench.py."""
    runs = {}

    def part(name, fn):
        _build.reset_launches()
        out = fn()
        _sync(device)
        runs[name] = launches()
        return out

    sn = sngan_setup(device)
    sps, chunks = part("sngan", lambda: sngan_measure(sn, device, sngan_warm, sngan_timed))
    log(f"SNGAN-32 fp32: {sps:.4f} steps/s over global steps {sngan_warm}-"
        f"{sngan_warm + sngan_timed - 1} after steps 0-{sngan_warm - 1}; by chunk of {CHUNK} "
        f"{[round(c, 4) for c in chunks]} steps/s")
    flops = sngan_flops(sn, device, sngan_warm + sngan_timed)
    out = {
        "metric": "sngan_cifar10_train_steps_per_sec_per_chip",
        "value": sps,
        "unit": "steps/sec (1 step = 5 D upd + 1 G upd, batch 64)",
        "vs_baseline": sps / BASELINE_STEPS_PER_SEC_A100,
        "flops_per_step": flops / 1e9,
        "mfu_pct": 100.0 * sps * flops / (FP32_PEAK_TFLOPS * 1e12),
        "mfu_peak_tflops": FP32_PEAK_TFLOPS,
    }
    log(f"SNGAN-32 step FLOPs (FlopCounterMode, global step {sngan_warm + sngan_timed}): "
        f"{flops / 1e9:.2f} GFLOP beside XLA's {JAX_SNGAN_GFLOP} for the JAX step (bench.py): "
        f"ratio {flops / 1e9 / JAX_SNGAN_GFLOP:.4f}")

    drs_sps, acc = part("drs", lambda: drs_measure(sn.g.module, sn.d.module, sn.bundle.nz,
                                                   device, drs_quota))
    out["drs_samples_per_sec"] = drs_sps
    log(f"DRS batch {DRS_BS}: {drs_sps:.2f} accepted/s over a quota of {drs_quota} after "
        f"{DRS_WARM} untimed; acceptance {acc:.4f}")
    del sn
    if device.type == "cuda":
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="bench_sg2_") as tmp:
        tr = sg2_trainer(device, tmp)
        steps, size, batch = SG2_STEPS, tr.size, tr.batch_size
        kinds = [step_kind(tr, s) for s in range(steps, 2 * steps)]
        for p, key in ((0.0, "sg2_256"), (SG2_ADA_P, "sg2_256_ada")):
            dt, per_step = part(f"sg2 p={p}", lambda: sg2_measure(tr, steps, p))
            out[f"{key}_ms_per_step"] = dt * 1000
            out[f"{key}_img_per_sec"] = batch / dt
            by_kind = {k: _spread([1e3 * s for s, kk in zip(per_step, kinds) if kk == k])
                       for k in sorted(set(kinds))}
            log(f"StyleGAN2-{size} bf16 batch {batch}, ADA p {p}: {1e3 * dt:.2f} ms a "
                f"step over global steps {steps}-{2 * steps - 1} "
                f"({kinds.count('r1+path')} R1 + path, {kinds.count('path')} path, "
                f"{kinds.count('plain')} plain); ms by step kind {by_kind}")
            if p == 0.0:
                parts = sg2_flops(tr)
                log(f"StyleGAN2-{size} FLOPs by sub-step (FlopCounterMode, GFLOP): "
                    f"{({k: round(v / 1e9, 1) for k, v in parts.items()})}; the port's "
                    f"amortised {parts['amortised'] / 1e9:.1f} beside XLA's {JAX_SG2_GFLOP} "
                    f"for the JAX program (bench.py): ratio "
                    f"{parts['amortised'] / 1e9 / JAX_SG2_GFLOP:.4f}")
                if (size, batch) == (SG2_SIZE, SG2_BATCH):
                    out["sg2_256_gflop_per_step"] = parts["amortised"] / 1e9
                    out["sg2_256_mfu_pct"] = (100.0 * parts["amortised"] / dt
                                              / (BF16_PEAK_TFLOPS * 1e12))
                    out["sg2_256_mfu_peak_tflops"] = BF16_PEAK_TFLOPS
        del tr
    out["device"] = card
    out["precision"] = dict(PRECISION)
    return out, runs


def card_info():
    """The first card's name and power limit as nvidia-smi gives them
    (`--query-gpu=name,power.limit --format=csv,noheader`), and the count."""
    line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in line.rsplit(",", 1))
    return {"name": name, "power_limit": limit, "count": torch.cuda.device_count()}


def main(argv=None):
    """Measure on the card and print the line; returns it."""
    pin_fp32_precision()
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    device = resolve_device("cuda")
    card = card_info()
    log(f"{card['name']}, {card['power_limit']} (count {card['count']})")
    out, runs = headline(device, card)
    log(f"port kernel launches by part: {json.dumps(runs)}")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
