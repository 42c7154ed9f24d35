#!/usr/bin/env python3
"""Drive the PyTorch port (diagan_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--kernels-only] [--against ROOT ...]

Phases, in order; any failure raises and the script exits non-zero:
  1. card name and power limit (nvidia-smi); IEEE fp32 for convs and matmuls
     (TF32 off, diagan_tpu_torch.device.pin_fp32_precision, as every CLI);
  2. build the CUDA kernels from csrc/ (nvcc, sm_90a, one process per source,
     all started together) and compile the Triton ones;
  3. kernel A (upfirdn2d) against its plain-torch version on the card, on
     every main-path shape (G and D blurs and the ToRGB skip at batch 16 and
     the serving batch of 32, ADA's passes of both forms at each pad bucket),
     each instance's edge shapes (odd widths, 8-9 px planes, pads of both
     parities), channels-last at C = 64, 128 and 3, and the odd
     configurations of the CPU tests: fp32, bf16, and channels-last in both,
     each call launching the instance fir_instance names,
     then the backward and double backward; fused bias-LeakyReLU at the real
     shapes in fp32 and bf16, and its StyledConv epilogue build
     (styled_leaky_relu) against its plain version bit for bit;
  3b. the training kernels against their plain versions: the fused-act
     backward (dx, db, double backward) at every activation shape, fp32 and
     bf16; ADA's warp gather and its adjoint at each bucket's S2, eight
     geometries (zoom_out beyond the gather's shared-memory box, zoom_in
     beyond the adjoint's cell window) and one batch of ADA draws, with the
     tile paths they take, and rows that are not a multiple of 4 floats;
     one call of each adjoint (interleaved and two-phase): its device events
     (its two passes, no memset) and its tile pass's SASS (no global atomic);
  3c. the polyphase ADA kernels against their plain versions: the two-phase
     warp gather and its adjoint at each bucket's S2 and at rows that are
     not a multiple of 4 floats, the same geometries and draws, with the
     tile paths the adjoint takes; where nothing clamps or falls back, its
     bits on two launches and against the interleaved adjoint; then the
     whole polyphase resample at 256 px, batch 16, against the interleaved
     one at the same reflect pad, values and image gradient;
  3d. each kernel A instance at its largest main-path shape against one
     cuDNN depthwise call and its bytes bound (device time of CUDA-graph
     replays, in turns), every ADA pass of both forms likewise; the
     interleaved warp pair in turns with grid_sample and its backward
     (device time, and eager), with --against ROOT another checkout's
     kernels (e.g. the parent commit's) in the same turns; the two-phase
     pair likewise, its gather in turns with the interleaved gather and
     grid_sample, its adjoint with grid_sample's backward and --against's
     two-phase adjoint; kernel A's generic instance on the channels-last G
     blur (fp32 and bf16) and an up-2 pass against cuDNN, each running the
     channels-last kernel named for it; with --against, kernel A of ROOT
     too: its fp32 instances and the bf16 A1-A3 (phase 14d's shapes) must
     give the same bits, and each is timed in the same turns
     (--kernels-only stops here after 3e);
  3e. StyleGAN3-T's kernels at its DRS cell's shapes (batch 64, full
     channels), every layer of the 256 px schedule: kernel A's four passes
     (the fir12 instances at up 2, the fir24x_up4 / fir24y_up4 pair at up
     4, the crops) against upfirdn2d_plain, each timed against its bytes
     bound, and flr_fwd's CLAMP build bit for bit against its plain version
     (and on a forced input that the clamp binds); with --against, the
     CLAMP-off flr_fwd's PTX against ROOT's, instruction for instruction,
     and ROOT's kernel A on every pass (its generic instance where it has
     no up-4 pair): the same bits, timed in turns; then StyleGAN3-T's DRS
     path, on which the generic instance must not launch;
  4. the serving slice at full width (StyleGAN2-256, channel_multiplier 2,
     style_dim 512, n_mlp 8, random weights from a seed): save a checkpoint,
     run cli.generate, draw DRS samples, with the launch counts (per kernel,
     and kernel A's per instance: the generic one must not launch) zeroed
     before and read after each path; then one G and one D forward on the card and
     on the CPU, with the same weights and noises; G's images for a batch of
     128 with the StyledConv epilogue fused against composed, bit for bit
     (cuDNN deterministic, one process);
  5. timings at the real shapes: kernel, plain version, one PyTorch library
     call for the same function, and the bytes/ops bound (the StyledConv
     epilogue beside the three passes it replaces); G images/s, DRS
     accepted samples/s, and a torch.profiler breakdown of one DRS proposal
     batch (device time by kernel, idle share);
  6. the training path at full width on 512 synthetic images (128 and rolled
     copies): cli.train_ffhq
     for 8 steps with ADA at a fixed p = 0.3, R1 and path regularisation and
     logit sweeps; cli.train_ffhq_phase2 for 4 steps from that checkpoint with
     the LDR scores and the twin DRS discriminator; cli.generate and DRS on
     the phase-2 checkpoint; every kernel launched on each training path;
     then cli.train_ffhq for 4 steps with DIAGAN_TPU_ADA_POLYPHASE=1, which
     must launch the two-phase warp pair and neither interleaved warp kernel;
  6b. one training step's gradients (D loss, R1, G through ADA, path
     length), and the polyphase augment and its image gradient, card against
     CPU at 32 px, width 1/4, with injected draws;
  7. the training kernels at their largest path shapes (kernel, plain,
     library, bound), one augment call (forward, forward + backward)
     polyphase against interleaved at the same pad; ms per plain / path / R1
     step, peak device memory and a profile of one ADA-live step; the plain
     step polyphase / interleaved at the static pad / interleaved with the
     trainer's pad buckets, and a profile of one polyphase ADA-live step;
  8. the SNGAN-32 Dia-GAN path at full width (ngf 256, ndf 128), batch 64,
     n_dis 5, on 50,000 synthetic images written in CIFAR-10's format (10,000
     procedural ones and rolled copies):
     cli.train_mimicry_phase1 for 30 steps with logit sweeps at 10, 20 and 30,
     cli.train_mimicry_phase2 for 10 steps with ldr_conf_1.0_ratio_50 and the
     twin DRS D, load_eval_models and DRS at batch 256 from the phase-2
     checkpoint; no port kernel may launch on it (its work is cuDNN, cuBLAS
     and PyTorch's own kernels); steps/s, ms per 50k sweep, DRS accepted/s,
     peak memory and a profile of one phase-1 step;
  8b. one fused SNGAN phase-2 step, card against CPU, injected draws;
  9. evaluation (random Inception weights, from a seed): 9a the FID
     InceptionV3 card against CPU on 4 images; 9b cli.eval_gan_drs with its
     counts cut to EVAL_N (FID 2k/2k, IS 2k, precision/recall 2k/2k, DRS at
     batch 256; the CLI's FID and IS counts are 50k, precision/recall's
     10k) on the SNGAN phase-2
     run, KID 2k/2k, and cli.eval_gan_with_index against the phase-1 logits
     (2k fakes), every score finite and no port kernel launched, with
     the wall seconds of real features, fake generation, featurisation and
     sqrtm; 9c FID with DRS of the StyleGAN2-256 phase-2 checkpoint (the
     eps-jitter sqrtm), whose kernel A and fused-act launches join the
     kernels line; 9d one profiled Inception batch of 128 at 299 and phase
     9's peak device memory;
 10. the CelebA-64 Dia-GAN path and its attribute study at full width
     (SNGAN-64 ngf 1024, ndf 1024, batch 64, n_dis 5; AttrClassifier at 64
     px) on 25,000 procedural images in CelebA's layout (celeba_64.npy and
     list_attr_celeba.txt): cli.train_mimicry_phase1 -d celeba for 12 steps
     with two sweeps of the whole set, cli.train_mimicry_phase2 to step 16
     (ldr_conf_1.0_ratio_50, twin DRS D), cli.disc_score_celeba_with_attr,
     cli.train_convnet_celeba for 1 epoch on the first 20,000 images,
     cli.count_attr_celeba --drs and cli.eval_gan_drs_celeba_with_attr
     --metric all at 1024 samples; no port kernel may launch; steps/s,
     sweep seconds, DRS accepted/s, classifier images/s, wall s per CLI and
     peak memory; 10b one fused SNGAN-64 step and the AttrClassifier's
     forward and gradients, card against CPU;
 11. the Colored-MNIST and MNIST-FMNIST Dia-GAN path and the 25-Gaussians
     toy at full width (MNIST DCGAN G 384/192/96/48, D 16-512, batch 64,
     n_dis 1; the toy's MLPs of 256): per family phase 1 for 300 steps with
     train-mode sweeps of the 10,000 images at 100, 200, 300, phase 2 to 400
     (colour: ldr_conf_1.0_ratio_50, the twin DRS D, DRS at batch 250 and
     its red/green counts; fmnist: with --gold), the GOLD phase 2 to 400, a
     PacGAN phase 1 (--num_pack 2) for 100 steps, both bias probes for 1
     epoch, and cli.train_mimicry_phase1 -d 25gaussian for 500 steps with
     sweeps; no port kernel may launch; steps/s, sweep ms, DRS accepted/s,
     the counts, probe images/s, peak memory and profiles of one DRS
     proposal batch and one DCGAN step; 11b one fused MNIST DCGAN phase-2
     step (twin D, GOLD), card against CPU, its fp32 gradients with the
     activations' sides of its float64 run;
 12. the CAE reconstruction-error protocol and the Inclusive GAN on phase
     11's runs: colour phase 1 resumed to step 400, cli.train_cae (2 epochs
     of 50; 20,000 generated images of the scripts' 50,000, through DRS for
     the phase-2 run) on both colour runs and the FMNIST run,
     cli.eval_ae_score --use_loss, cli.train_mimicry_inclusive for 4 steps
     at full DCGAN and Inception width (its construction registers the
     10,000 real features and refreshes the nearest latents: 10,000
     latents at 299 px, of the script's 100,000) and
     cli.train_cae_inclusive; no port kernel may
     launch; images/s, CAE images/s, RE sweep ms, s per refresh, ms per
     Inclusive step, peak memory and a profile of one Inclusive step; 12b
     the CAE's forwards and the Inclusive hook with its G gradients, card
     against CPU;
 13. SSGAN and InfoMax-GAN through the Dia-GAN path, --simultaneous_g and
     --bf16, at full width (ngf 256, ndf 128, nrkhs 1024; batch 64, n_dis 5)
     on the earlier phases' data: per model cli.train_mimicry_phase1 for 12
     steps with 50k sweeps at 5 and 10, cli.train_mimicry_phase2 to 16
     (ldr_conf_1.0_ratio_50, twin DRS D), load_eval_models and DRS at batch
     256 (2048 samples); SNGAN-32 phase 1 for 6 steps with --simultaneous_g,
     then with --bf16; a Colored-MNIST phase 1 for 100 steps with --bf16;
     SSGAN-64 and InfoMax-64 (ngf, ndf 1024) for 4 CelebA steps, no sweep;
     no port kernel may launch; steps/s of each beside SNGAN's (and SNGAN's
     under concat_d and fuse_g), sweep ms, DRS accepted/s, peak memory and profiles of one
     SSGAN and one InfoMax step; 13b card against CPU with injected draws
     and the CPU float64 run's ReLU sides: one fused step each of SSGAN-32
     and InfoMax-32 (twin D), SSGAN-64 and InfoMax-64 at full width (batch
     2, lr 0), SNGAN-32 under simultaneous_g, concat_d and fuse_g, and SNGAN-32
     in bf16 (forwards and a step) against the fp32 CPU run;
 14. the FFHQ trainer's last flags and the checkpoint readers, on phase 6's
     512 images at full width: 14a cli.train_ffhq --bf16 --remat
     --stream_data --no_fuse --max_chunk 4 for 8 steps with logit sweeps,
     cli.train_ffhq_phase2 --bf16 --stream_data for 4 steps from it (twin D,
     weighted host stream), each launching every training kernel and A1-A3
     and the fused act's kernels on bf16 tensors (no generic instance, no
     two-phase warp), then phase 1's checkpoint in the reference's key layout
     through read_stylegan2_ckpt and cli.generate; 14b the streamed logit
     sweep against the resident one (bit for bit), one fp32 step with and
     without remat (1e-6 of max(1, max|.|)) with their peak memory, ms per
     step in fp32 and bf16, streamed and with remat; 14c one bf16 step
     (forwards, D loss, R1, G, path) card against the fp32 CPU run; 14d the
     bf16 instances A1-A3 and the fused act's kernels at the bf16 step's
     shapes against their plain versions, timed against their bounds.
 15. a reference run carried into the port, and the modules with no
     caller: 15a phase 8's phase-1 files rewritten as the reference's
     torch-mimicry files (no update_count) and cli.train_mimicry_phase2 from
     them for 4 steps at full width (the global step the files', every net's
     first update at lr0 from fresh Adam, as the JAX package's
     import_torch_net; no port kernel), the same weights as bare
     state_dicts through load_eval_models and DRS; 15b
     ModulatedConv(downsample=True) at 512 channels, 64 -> 32 px, batch 16,
     k = 3 and 1, card against CPU, its blur on A1 (launched, and held
     against its plain version); 15c cli.validate_weights with seeded random
     Inception (pytorch-fid's layout), VGG16 (torchvision's) and lpips-head
     files, every stage passing, then LPIPS card against CPU at 64 and 256
     px; 15d the by-index loaders on phase 10's CelebA (2,048 indices) equal
     to the plain gather, and their features on the card equal.
 16. data parallelism (diagan_tpu_torch.parallel): 16a --data_parallel at
     world 1 over NCCL, in process, through the CLIs, against the plain run,
     with cuDNN's deterministic algorithms: cli.train_mimicry_phase1
     SNGAN-32 at full width on phase 8's 50k files for 10 steps with a sweep
     at 10 and cli.train_ffhq at 64 px (a depth cut: cuDNN's deterministic
     algorithms are slow in fp32), full width, 4 steps without ADA,
     each equal bit for bit (weights, buffers, Adam state, logit rows);
     cli.train_ffhq with ADA at a fixed p = 0.3 (every training kernel
     launching; the adjoint's atomics make no two runs equal), step 0 up to
     G's first update bit for bit and the state beside a second plain run's
     spread; ms per step with and without the flag; then
     cli.train_ffhq --data_parallel with
     adaptive ADA, whose p moves from the all-reduced sign sums and equals
     their host replay. 16b
     two ranks over gloo sharing the card, two processes (chip_smoke.py
     --dp-worker DIR RANK): SNGAN-32 at full width, global batch 64, 4 steps
     and a sharded eval sweep of the 50k (both ranks' states bit for bit, the
     sharded row equal to the one-process row, D's first all-reduced gradient
     equal to the mean of the ranks' own); StyleGAN2-256 at batch 4 a rank, 2
     steps, adaptive ADA (the states and p equal on both ranks, each sign sum
     the sum of the ranks'); each rank's ms per step and the bytes
     all-reduced per step.
 17. the 25-Gaussians two-phase protocol through cli.smoke_toy at the JAX
     script's settings (scripts/smoke_toy.py: 8000 phase-1 steps with eval
     sweeps of the 10,000 points every 100 over 4000-8000, ldrv weights,
     4000 phase-2 steps with the twin D, DRS; batch 256, the toy MLPs of
     256, seed 1): each step's files, finite weights, well-formed coverage,
     DRS accepting, no port kernel; the wall time of each step, steps/s,
     the acceptance and the three coverage lines beside the JAX package's
     hardware run; entered with TF32 on, after it a conv and a matmul
     against float64 within 1e-5 (the CLIs' pinned fp32).
 18. the headline benchmark through cli.bench's functions at full width,
     its counts cut (one 25-step SNGAN-32 window after 5 steps, a DRS quota
     of 5,000; the StyleGAN2-256 bf16 windows whole): its line, every
     number finite and > 0, each MFU at most 100, the port's FLOP count of
     the amortised StyleGAN2 step beside XLA's 19148.8 GFLOP for the JAX
     program; the launches of each part (none on SNGAN or DRS, no warp
     kernel at ADA p 0, the interleaved warp pair and A4-A7 at p 0.05, never
     the two-phase pair, the polyphase or the generic instances); both FLOP
     counts within 10% of XLA's counts of the JAX programs; 18b a profile of
     StyleGAN2 steps 29-32 at p 0.
Each phase prints its start, in seconds since the script started.
The last lines are the kernels' JSON, the nvidia-smi line and
{"ok": true, "device": {...}}. Without a card it exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
SIZE, STYLE_DIM, N_MLP, CH_MULT = 256, 512, 8, 2
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores


T0 = time.perf_counter()


def phase(name):
    """A phase's start, with the seconds since the script started."""
    print(f"[{time.perf_counter() - T0:.1f} s] {name}", flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=10):
    """Device time of one call of fn: `iters` calls captured in a CUDA graph,
    whose replays are timed with CUDA events, so the host's cost of each
    launch (Python, the wrapper, the CUDA launch call) is left out. A call
    under 50 us is timed again over ten times the calls, so that a replay
    lasts long enough to compare two such kernels within a few percent."""
    ms = _graph_ms(fn, iters)
    return _graph_ms(fn, 10 * iters) if ms < 0.05 else ms


def _graph_ms(fn, iters):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up outside the graph
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (3 * iters)


def bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_ulp(v):
    a = v.float().abs().clamp_min(2.0**-126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def profile(fn, label, smi, tags):
    """Device time by kernel over one call of fn, from torch.profiler. Device
    busy time is the union of the kernels' intervals (kernels on other
    streams may overlap, so their summed times can exceed the wall time);
    the idle share is 1 - busy / wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device kernels only: the CPU-side ops that launched them report the
    # same time again
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, lo, hi = 0.0, None, None
    for start, end in spans + [(math.inf, math.inf)]:
        if hi is not None and start > hi:
            busy, lo = busy + hi - lo, None
        if lo is None:
            lo, hi = start, end
        hi = max(hi, end)
    busy /= 1e3
    if total == 0:
        print(f"profile of {label}: the profiler recorded no device time (not measured)")
        return
    print(f"profile of {label}: wall {wall_ms:.2f} ms, {len(spans)} device events, device "
          f"busy {busy:.2f} ms (union of kernel intervals; kernel times sum to {total:.2f} ms), "
          f"idle share {1 - busy / wall_ms:.4f} [{smi}]")
    for name, ms, count in rows[:12]:
        print(f"  {ms:9.3f} ms {100 * ms / total:6.2f}%  x{count:<4d} {name[:90]}")
    for tag in tags:
        ms = sum(r[1] for r in rows if tag in r[0])
        print(f"  {tag}: {ms:.3f} ms, {100 * ms / total:.2f}% of summed kernel time")

# what sampling launches: G's StyledConvs run their epilogue with autograd off
FORWARD_KERNELS = ("upfirdn2d", "fused_leaky_relu", "styled_leaky_relu")
# StyleGAN3's clamped activation: no StyleGAN2 path launches it
SG3_KERNELS = ("clamped_leaky_relu",)
# kernel A's device kernels in a profile: all of them, then by kernel
FIR_TAGS = ("fir_", "fir_kernel", "fir_vec_kernel", "fir_xdown2_kernel", "fir_generic_kernel",
            "fir_cl")
WARP = ("affine_warp_gather", "affine_warp_scatter")  # ADA's interleaved resample
WARP2 = ("affine_warp2_gather", "affine_warp2_scatter")  # its polyphase form
N_DATA = 512  # synthetic training images
# tests/test_warp_pallas.py geometries, [ay, by, cy, ax, bx, cx] at s2 = 128;
# the offsets cy, cx scale with s2
_TH = 0.6
WARP_CASES = {
    "identity": [1.0, 0.0, 30.0, 0.0, 1.0, 30.0],
    "rot_scale": [1.3 * math.cos(_TH), -1.3 * math.sin(_TH), 30.0,
                  1.3 * math.sin(_TH), 1.3 * math.cos(_TH), 20.0],
    "flip": [1.0, 0.0, 30.0, 0.0, -1.0, 90.0],
    "shrink": [0.4, 0.02, 40.0, -0.02, 0.4, 40.0],
    "clipped": [0.8, 0.1, -3.0, -0.2, 1.1, 120.0],
    "fractional": [1.01, -0.3, 17.25, 0.3, 0.97, 33.75],
    # 2.8x at 45 degrees (tests/test_torch_port_train_ops.py): beyond the
    # gather's shared-memory box, so its tiles read x2 from global
    "zoom_out": [2.8 * math.cos(math.pi / 4), -2.8 * math.sin(math.pi / 4), 63.5,
                 2.8 * math.sin(math.pi / 4), 2.8 * math.cos(math.pi / 4), -21.5],
    # 0.3x at 20 degrees: beyond the adjoint's cell window (its fallback)
    "zoom_in": [0.3 * math.cos(0.35), -0.3 * math.sin(0.35), 50.0,
                0.3 * math.sin(0.35), 0.3 * math.cos(0.35), 45.0],
}


def resolutions():
    return [2**j for j in range(2, int(math.log2(SIZE)) + 1)]


def ada_pads():
    """ADA's reflect pad of each bucket at SIZE: fractions (0.25, 0.5) and pad_frac 0.75."""
    from diagan_tpu_torch.models.ada import PAD_K

    return [min(SIZE - 1, int(f * SIZE) + PAD_K) for f in (0.25, 0.5, 0.75)]


def ada_win():
    from diagan_tpu_torch.models.ada import PAD_K

    return 2 * SIZE + 2 * PAD_K


def ada_s2(P):
    """Edge of the 2x buffer at reflect pad P."""
    return 2 * (SIZE + 2 * P)


def polyphase_env():
    """DIAGAN_TPU_ADA_POLYPHASE=1 (the polyphase opt-in) inside the block."""
    return mock.patch.dict(os.environ, {"DIAGAN_TPU_ADA_POLYPHASE": "1"})


def ada_coef(P, seed):
    """Warp coefficients (16, 6) of one batch of real ADA draws at p = 1."""
    from diagan_tpu_torch.models import ada

    G = ada.sample_affine_matrices(16, 1.0, SIZE, SIZE, torch.Generator().manual_seed(seed))
    return ada._warp_coef(torch.linalg.inv(G), SIZE, P).contiguous()


def max_err(got, want):
    return (got.float() - want.float()).abs().max().item()


def fir_launches(path):
    """Kernel A's launches by instance since the counts were last zeroed;
    a main path must not launch the generic instance."""
    from diagan_tpu_torch.ops import _build

    fir = dict(_build.FIR_INSTANCES)
    check(fir["generic"] == 0, f"{path} launched kernel A's generic instance: {fir}")
    print(f"{path}: kernel A launches by instance {fir}")
    return fir


def styled_inputs(dev, rng, shape, dtype):
    """A StyledConv epilogue's operands at `shape` (N, C, H, W), in
    styled_leaky_relu's order: the undemodulated map, its bias, demod in
    [0.5, 1.5), the noise and its weight, all in `dtype`."""
    n, c, h, w = shape
    y = torch.randn(shape, generator=rng, device=dev).to(dtype)
    b = torch.randn(c, generator=rng, device=dev).to(dtype)
    d = torch.rand((n, c), generator=rng, device=dev).add_(0.5).to(dtype)
    noise = torch.randn((n, 1, h, w), generator=rng, device=dev).to(dtype)
    return y, b, d, noise, torch.tensor(0.3, device=dev).to(dtype)


def check_styled_act(dev, rng, ch):
    """3. flr_fwd's STYLED build (styled_leaky_relu: G's StyledConv epilogue)
    against its plain version, which is the composition it replaces, bit for
    bit: every StyledConv output shape at batch 16, and DRS's batch of 128
    at SIZE and SIZE / 2 px, in fp32 and bf16; each call one launch, counted
    as styled_leaky_relu."""
    from diagan_tpu_torch.ops import _build, styled_leaky_relu, styled_leaky_relu_plain

    shapes = [(16, ch[r], r, r) for r in [2**j for j in range(2, int(math.log2(SIZE)) + 1)]]
    shapes += [(128, ch[SIZE], SIZE, SIZE), (128, ch[SIZE // 2], SIZE // 2, SIZE // 2)]
    for shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            args = styled_inputs(dev, rng, shape, dtype)
            n0 = _build.LAUNCHES["styled_leaky_relu"]
            got = styled_leaky_relu(*args)
            check(_build.LAUNCHES["styled_leaky_relu"] == n0 + 1,
                  f"styled_leaky_relu {shape} {dtype} launches")
            check(torch.equal(got, styled_leaky_relu_plain(*args)),
                  f"styled_leaky_relu {shape} {dtype} differs from plain")
            del got, args
    print(f"styled_leaky_relu: {len(shapes)} shapes x (fp32, bf16) equal plain bit for bit")


def check_styled_images(dev, smi):
    """4. G's images at SIZE px for a seeded batch of 128, fp32, with cuDNN's
    deterministic algorithms, in one process: autograd off (each StyledConv
    one styled_leaky_relu launch) against autograd on with nothing that
    requires a gradient (the composition: y * demod, + w * noise, the plain
    bias-act), bit for bit. StyledConv biases and noise weights are drawn
    away from their zero init; the global RNG is left as it was."""
    from diagan_tpu_torch.models.stylegan2 import StyledConv, StyleGAN2Generator
    from diagan_tpu_torch.ops import _build

    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        with torch.random.fork_rng(devices=[torch.cuda.current_device()]):
            torch.manual_seed(SEED + 3)
            gen = StyleGAN2Generator(SIZE, STYLE_DIM, N_MLP, CH_MULT, device=dev)
        gen.requires_grad_(False)
        styled = [m for m in gen.modules() if isinstance(m, StyledConv)]
        rng = torch.Generator(dev).manual_seed(SEED + 4)
        for m in styled:
            m.bias.copy_(0.3 * torch.randn(m.bias.shape, generator=rng, device=dev))
            m.noise.weight.copy_(0.3 * torch.randn((), generator=rng, device=dev))
        z = torch.randn((128, STYLE_DIM), generator=rng, device=dev)

        def images():
            return gen(z, generator=torch.Generator(dev).manual_seed(SEED + 5))

        _build.reset_launches()
        with torch.no_grad():
            fused = images()
        n_fused = _build.LAUNCHES["styled_leaky_relu"]
        with torch.enable_grad():
            composed = images()
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    check(n_fused == len(styled) == _build.LAUNCHES["styled_leaky_relu"],
          f"{n_fused} styled_leaky_relu launches for {len(styled)} StyledConvs, "
          f"{_build.LAUNCHES['styled_leaky_relu']} after the composed run")
    check(fused.shape == (128, SIZE, SIZE, 3) and bool(torch.isfinite(fused).all()),
          "G's fused images")
    check(torch.equal(fused, composed), "G's images fused differ from composed, max abs "
          f"{(fused - composed).abs().max().item()}")
    print(f"G StyleGAN2-{SIZE}, batch 128, fp32, cuDNN deterministic, one process: images with "
          f"the epilogue fused ({len(styled)} styled_leaky_relu launches) equal the composed "
          f"ones bit for bit [{smi}]")


def time_styled_act(dev, rng, ch):
    """5. the kernels-line row of styled_leaky_relu (flr_fwd's STYLED build)
    at DRS's batch of 128 at SIZE px, fp32: its time, its plain version's,
    the three passes it replaces on the same tensors (y * demod, + w * noise,
    the plain bias-act), and its bytes bound (y and the noise read, the
    output written; demod, bias and weight). Launches are filled in later."""
    from diagan_tpu_torch.ops import fused_leaky_relu, styled_leaky_relu, styled_leaky_relu_plain

    y, b, d, noise, nw = args = styled_inputs(dev, rng, (128, ch[SIZE], SIZE, SIZE),
                                              torch.float32)
    b_s, by_s = bound((2 * y.numel() + noise.numel() + d.numel() + b.numel() + 1) * 4,
                      6 * y.numel())
    entry = {
        "name": "styled_leaky_relu", "route": "triton",
        "source": "diagan_tpu_torch/ops/fused_act.py",
        "replaces": "diagan_tpu/ops/fused_act.py:41 and the two passes before it",
        "launches": 0, "max_abs_err": 0.0,  # phase 3: equal bit for bit
        "ms": cuda_ms(lambda: styled_leaky_relu(*args)),
        "plain_ms": cuda_ms(lambda: styled_leaky_relu_plain(*args), iters=3),
        "bound_ms": b_s, "bound_by": by_s, "library_ms": None,
        "passes_ms": cuda_ms(lambda: fused_leaky_relu(y * d[:, :, None, None] + nw * noise, b),
                             iters=3),
        "shape": f"{tuple(y.shape)} fp32, demod (N, C), noise (N, 1, H, W) (StyledConv epilogue "
                 f"at {SIZE} px, DRS batch); passes_ms: the three passes it replaces",
    }
    print(f"styled_leaky_relu at {entry['shape']}: {entry['ms']:.4f} ms, plain "
          f"{entry['plain_ms']:.4f} ms, three passes {entry['passes_ms']:.4f} ms, bound "
          f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}), "
          f"{entry['bound_ms'] / entry['ms']:.3f} of the bound")
    return entry


def check_act_backward(dev, rng, ch):
    """Fused-act backward kernels against the plain version at every
    activation shape of the training path (batch 16, and 8 for path
    regularisation), fp32 and bf16: dx, db, and the double backward's
    mask applied to gg_dx + gg_db. Then one second derivative through the
    autograd Functions against autograd through the plain forward."""
    from diagan_tpu_torch.ops import (
        fused_leaky_relu,
        fused_leaky_relu_backward,
        fused_leaky_relu_backward_plain,
        fused_leaky_relu_plain,
    )

    shapes = [(b, STYLE_DIM) for b in (16, 8)]
    shapes += [(b, ch[r], r, r) for b in (16, 8) for r in resolutions()]
    err = {"dx": 0.0, "db": 0.0, "double": 0.0}
    for shape in shapes:
        g32, y32, gg32 = (torch.randn(shape, generator=rng, device=dev) for _ in range(3))
        extra = torch.randn(shape[1], generator=rng, device=dev)
        dims = (0,) + tuple(range(2, len(shape)))
        for dt in (torch.float32, torch.bfloat16):
            g, y, gg = g32.to(dt), y32.to(dt), gg32.to(dt)
            dx, db = fused_leaky_relu_backward(g, y)
            dg, none = fused_leaky_relu_backward(gg, y, extra=extra, sums=False)
            torch.cuda.synchronize()
            dx_p, db_p = fused_leaky_relu_backward_plain(g, y)
            dg_p, _ = fused_leaky_relu_backward_plain(gg, y, extra=extra, sums=False)
            check(none is None and dx.dtype == dt and db.dtype == torch.float32,
                  f"fused_leaky_relu_backward {shape} {dt} outputs")
            for name, got, want in (("dx", dx, dx_p), ("double", dg, dg_p)):
                diff = (got.float() - want.float()).abs()
                if dt == torch.float32:  # the same rounding steps as the plain version
                    err[name] = max(err[name], diff.max().item())
                    check(diff.max().item() <= 1e-6 * max(1.0, want.abs().max().item()),
                          f"fused_leaky_relu_backward {name} {shape} fp32 err {diff.max().item()}")
                else:
                    check(bool((diff <= bf16_ulp(want)).all()),
                          f"fused_leaky_relu_backward {name} {shape} bf16 differs by more than 1 ulp")
            # db: the same fp32 sum of the rounded dx, taken in another order
            diff = (db - db_p).abs()
            check(bool((diff <= 1e-5 * dx_p.float().abs().sum(dims)).all()),
                  f"fused_leaky_relu_backward db {shape} {dt} err {diff.max().item()}")
            if dt == torch.float32:
                err["db"] = max(err["db"], diff.max().item())
    shape = (16, ch[64], 64, 64)
    x, u = (torch.randn(shape, generator=rng, device=dev, requires_grad=True) for _ in range(2))
    b = torch.randn(shape[1], generator=rng, device=dev, requires_grad=True)
    a = torch.randn(shape, generator=rng, device=dev)
    cb = torch.randn(shape[1], generator=rng, device=dev)

    def second(f):  # d/du of <dx, a> + <db, cb>, with (dx, db) the grads of <f(x, b), u>
        dx, db = torch.autograd.grad((f(x, b) * u).sum(), (x, b), create_graph=True)
        return torch.autograd.grad((dx * a).sum() + (db * cb).sum(), u)[0]

    want = second(fused_leaky_relu_plain)
    e2 = max_err(second(fused_leaky_relu), want)
    check(e2 <= 1e-6 * max(1.0, want.abs().max().item()),
          f"fused_leaky_relu autograd double backward err {e2}")
    print(f"fused_leaky_relu_backward: {len(shapes)} shapes x (fp32, bf16) match plain; fp32 max "
          f"abs err dx {err['dx']:.3e}, db {err['db']:.3e}, double backward {err['double']:.3e} "
          f"(tol dx 1e-6 x max(1, max|out|), bf16 1 ulp; db 1e-5 x sum|dx| per channel); "
          f"autograd second derivative err {e2:.3e}")
    return max(err.values())


def ptxas_report(log):
    """One line per kernel of an nvcc -Xptxas -v log: its name (demangled
    where c++filt is on the PATH), registers and spills."""
    props, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name = m.group(1)
            props[name] = []
        elif name and ("spill" in ln or "registers" in ln):
            props[name].append(ln.split(":")[-1].strip())
    names = list(props)
    if names and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                               text=True, check=True).stdout.splitlines()
    return [f"{n.replace('(anonymous namespace)::', '')[:110]}: {'; '.join(v)}"
            for n, v in zip(names, props.values())]


def _family_pad(k, up, down):
    """The pad (p0, p1) of one axis that the main paths give a k-tap filter:
    the output is up / down times the input."""
    p0 = k // 2 - (down == 2)
    return p0, (k - 1 if down == 1 else k - 2) - p0


def fir_cases(dev, ch, k4):
    """upfirdn2d cases: (input shape, taps, up, down, pad, full). Every call
    family of the main paths at its shapes (the G and D blurs and the ToRGB
    skip at each resolution, ADA's interleaved passes at each pad bucket and
    the polyphase passes at the largest, batch 16; the SIZE px blurs also at
    the serving batch of 32, which serving runs forward in fp32 only: those
    cases are not `full`); then each instance's family off the main paths
    (odd widths like 257, widths that are not a multiple of the 32-lane tile
    or of the pair store, 8-9 px planes, pads of both parities, taps that are
    not symmetric); channels-last widths of the JAX package's NHWC FIRs
    (C = 64 and 128) and C = 3; then the odd configurations of the port's
    CPU tests, which the generic instance takes where they are not a family."""
    from diagan_tpu_torch.models.ada import PAD_K, _polyphase_taps, _sym6_taps
    from diagan_tpu_torch.ops import make_resample_kernel
    from diagan_tpu_torch.ops.ada_phase import PARITIES
    from diagan_tpu_torch.ops.upfirdn2d import _FAMILIES

    k16 = k4 * 4
    cases = []
    for n in (16, 32):
        for res in resolutions()[1:] if n == 16 else [SIZE]:
            full = n == 16
            cases.append(((n, ch[res], res + 1, res + 1), k16, 1, 1, (1, 1), full))  # G up blur
            cases.append(((n, 3, res // 2, res // 2), k16, 2, 1, (2, 1), full))  # ToRGB skip
            cases.append(((n, ch[res], res, res), k4, 1, 1, (2, 2), full))  # D conv blur
            cases.append(((n, ch[res], res, res), k4, 1, 1, (1, 1), full))  # D skip blur
    kyf, kxf, ky, kx = _sym6_taps(dev)
    win = ada_win()
    for P in ada_pads():
        s = SIZE + 2 * P
        cases.append(((16, 3, s, s), kyf, (1, 2), 1, (0, 0, PAD_K, PAD_K - 1)))
        cases.append(((16, 3, 2 * s, s), kxf, (2, 1), 1, (PAD_K, PAD_K - 1, 0, 0)))
    cases.append(((16, 3, win, win), ky, 1, (1, 2), (0, 0, PAD_K - 1, PAD_K - 1)))
    cases.append(((16, 3, win // 2, win), kx, 1, (2, 1), (PAD_K - 1, PAD_K - 1, 0, 0)))
    s = SIZE + 2 * ada_pads()[-1]
    b0, b1, *down = _polyphase_taps(dev)
    cases.append(((16, 3, s, s), kxf, (2, 1), 1, (PAD_K, PAD_K - 1, 0, 0)))
    cases += [((16, 3, s, 2 * s), b, 1, 1, (0, 0, 3 - phi, 2 + phi))
              for phi, b in enumerate((b0, b1))]
    cases += [((16, 3, win // 2, win // 2), k2, 1, 1, ((2, 3)[b], (3, 2)[b], (2, 3)[a], (3, 2)[a]))
              for (a, b), k2 in zip(PARITIES, down)]
    gen = torch.Generator(dev).manual_seed(SEED + 20)
    for kh, kw, up, dn in _FAMILIES:
        taps = torch.randn(kh, kw, generator=gen, device=dev)
        (px0, px1), (py0, py1) = _family_pad(kw, up[0], dn[0]), _family_pad(kh, up[1], dn[1])
        for shape in ((2, 5, 9, 9), (2, 3, 37, 257), (1, 2, 8, 70), (3, 4, 9, 8)):
            cases.append((shape, taps, up, dn, (px0, px1, py0, py1)))
            cases.append((shape, taps, up, dn, (px0 + 1, px1 - 1, py0 + 1, py1 - 1)))
    # C = 64 (the width of #3, _fir2d_pair) and 128 (#2, _fir2d_nhwc): the
    # generic instance's channels-last bodies, the fixed 4x4 one and the
    # run-time one (up 2, down 2); C = 3 channels-last keeps the tile body
    cases += [((2, 64, 33, 33), k16, 1, 1, (1, 1)), ((2, 128, 17, 17), k4, 1, 1, (2, 2)),
              ((2, 64, 16, 16), k16, 2, 1, (2, 1)), ((2, 128, 32, 32), k4, 1, 2, (1, 1)),
              ((2, 3, 33, 33), k16, 1, 1, (1, 1))]
    asym = torch.randn(3, 4, generator=gen, device=dev)
    row5 = torch.randn(1, 5, generator=gen, device=dev)
    small = (2, 3, 12, 9)
    cases += [(small, torch.tensor(make_resample_kernel(k), device=dev), up, dn, pad)
              for up, dn, pad, k in [
                  (1, 1, (1, 1), [1, 3, 3, 1]), (1, 1, (1, 1), [1, 2, 1]),
                  (1, 1, (2, 1), [1, 3, 3, 1]), (2, 1, (2, 1), [1, 3, 3, 1]),
                  (1, 2, (1, 1), [1, 3, 3, 1]), (2, 1, (1, 0), [1, 2, 1]),
                  (1, 2, (0, 0), [1, 1]), (1, 1, (-1, 2), [1, 3, 3, 1]),
                  (3, 2, (2, 2), [1, 3, 3, 1])]]
    cases += [(small, asym, 1, 1, (1, 2, 0, 1)), (small, asym, 2, 2, (2, 1)),
              (small, row5, (2, 1), 1, (2, 1, 0, 0))]
    return [c if len(c) == 6 else (*c, True) for c in cases]


def cl_launches():
    """Launches of kernel A's channels-last bodies so far, (fir_cl_kernel,
    fir_cl_fixed_kernel): the generic instance's dispatch between them and
    the tile body, read from csrc/upfirdn2d.cu's own counts."""
    import ctypes

    from diagan_tpu_torch.ops import _build

    fn = _build.load("upfirdn2d").upfirdn2d_cl_launches
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int]
    return fn(0), fn(1)


def check_fir(dev, rng, cases):
    """Kernel A against its plain version on each case: the forward in fp32,
    bf16, and channels-last in both, each call launching exactly the instance
    that fir_instance names (the generic one for channels-last), a generic
    launch taking a channels-last body exactly when the tensors' channel
    vectors are 16-byte aligned (_cl_vec_fits), the fixed one exactly for
    4x4 taps at up = down = 1 (_cl_fixed); then in fp32 the
    backward and the double backward against autograd through the plain
    version; a case that is not `full` only in fp32, forward. Returns
    {instance: max fp32 abs err} and the largest forward and backward
    errors."""
    from diagan_tpu_torch.ops import _build, upfirdn2d, upfirdn2d_plain
    from diagan_tpu_torch.ops.upfirdn2d import (
        _backward_args,
        _cl_fixed,
        _cl_vec_fits,
        fir_instance,
        layout,
    )

    errs, err_fwd, err_bwd, n_cl = {}, 0.0, 0.0, 0

    def note(inst, e):
        errs[inst] = max(errs.get(inst, 0.0), e)

    for shape, taps, up, down, pad, full in cases:
        x32 = torch.randn(shape, generator=rng, device=dev)
        layouts = (x32, x32.bfloat16(), x32.contiguous(memory_format=torch.channels_last),
                   x32.bfloat16().contiguous(memory_format=torch.channels_last))
        for x in layouts if full else layouts[:1]:
            inst = fir_instance(*taps.shape, up, down, x.dtype, layout(x))
            _build.reset_launches()
            cl0 = cl_launches()
            got = upfirdn2d(x, taps, up, down, pad)
            torch.cuda.synchronize()
            launched = {k: v for k, v in _build.FIR_INSTANCES.items() if v}
            check(launched == {inst: 1}, f"upfirdn2d {shape} {x.dtype} launched {launched}, "
                                         f"not {inst}")
            cl = inst == "generic" and _cl_vec_fits(shape[1], x.stride(), got.stride(),
                                                    x.data_ptr(), got.data_ptr(),
                                                    x.element_size())
            fixed = cl and _cl_fixed(*taps.shape, up, down)
            ran = tuple(b - a for a, b in zip(cl0, cl_launches()))
            check(ran == (int(cl and not fixed), int(fixed)),
                  f"upfirdn2d {shape} {x.dtype} {layout(x)}: the channels-last bodies "
                  f"(run-time, fixed) launched {ran} times")
            n_cl += cl
            want = upfirdn2d_plain(x, taps, up, down, pad)
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"upfirdn2d {shape} shape/dtype")
            e = max_err(got, want)
            tol = (1e-2 if x.dtype == torch.bfloat16 else 1e-5) * want.float().abs().max().item()
            check(e <= tol, f"upfirdn2d {inst} {shape} up={up} down={down} pad={pad} "
                            f"{x.dtype}: err {e} > {tol}")
            if x.dtype == torch.float32:
                note(inst, e)
                err_fwd = max(err_fwd, e)
        if not full:
            continue
        x = x32.requires_grad_(True)
        v = torch.randn(shape, generator=rng, device=dev)
        w, res = None, []
        for f in (upfirdn2d, upfirdn2d_plain):
            y = f(x, taps, up, down, pad)
            if w is None:
                w = torch.randn(y.shape, generator=rng, device=dev, requires_grad=True)
            (gx,) = torch.autograd.grad(y, x, w, create_graph=True)
            (gw,) = torch.autograd.grad((gx * v).sum(), w)
            res.append((gx.detach(), gw))
        torch.cuda.synchronize()
        b_up, b_down, _ = _backward_args(shape[2:], w.shape[2:], *taps.shape, up, down, pad)
        insts = (fir_instance(*taps.shape, b_up, b_down, torch.float32, torch.contiguous_format),
                 fir_instance(*taps.shape, up, down, torch.float32, torch.contiguous_format))
        for what, inst, got, want in zip(("backward", "double backward"), insts, *res):
            e = max_err(got, want)
            check(e <= 1e-5 * want.abs().max().item(),
                  f"upfirdn2d {what} ({inst}) {shape} up={up} down={down} pad={pad}: err {e}")
            note(inst, e)
            err_bwd = max(err_bwd, e)
        del x, x32, v, w, res, got, want
    check(n_cl > 0, "no case took the channels-last body")
    print(f"upfirdn2d: {len(cases)} cases (every main-path shape, each instance's edge shapes, "
          f"channels-last at C = 64, 128 and 3, the odd configurations) x (fp32, bf16, "
          f"channels-last fp32 and bf16) match plain, each launching "
          f"the instance fir_instance names ({n_cl} generic calls on the channels-last body, "
          f"each where _cl_vec_fits says); backward and double backward in fp32 match "
          f"autograd through plain. Max fp32 abs err by instance: "
          f"{ {k: float(f'{v:.3e}') for k, v in sorted(errs.items())} } (tol 1e-5 x max|out|; "
          f"bf16 1e-2 x max|out|)")
    return errs, err_fwd, err_bwd


def warp_coefs(P, dev):
    """Warp coefficients (16, 6) at reflect pad P: the six WARP_CASES, their
    offsets scaled to the bucket's S2, and one batch of ADA draws at p = 1."""
    f = ada_s2(P) / 128
    coefs = {name: torch.tensor([ay, by, cy * f, ax, bx, cx * f], device=dev).expand(16, 6)
             for name, (ay, by, cy, ax, bx, cx) in WARP_CASES.items()}
    coefs["ada_p1"] = ada_coef(P, SEED).to(dev)
    return {name: coef.contiguous() for name, coef in coefs.items()}


def warp_paths(coef, win, s2):
    """Which paths of the interleaved pair a call takes, from the tile
    geometry's plain mirrors (ops/warp.py): gather tiles staged in shared
    memory / reading x2 from global; adjoint tiles written as zeros / on the
    cell path / on the shared-atomic fallback; images that need the
    clamped-output pass."""
    from diagan_tpu_torch.ops.warp import _gather_tile_boxes, _scatter_tile_candidates

    _, fits = _gather_tile_boxes(coef, win, s2)
    cand, cells, clamp = _scatter_tile_candidates(coef, win, s2)
    empty = (cand[..., 0] > cand[..., 1]) | (cand[..., 2] > cand[..., 3])
    return {"gather tiled": int(fits.sum()), "gather global": int((~fits).sum()),
            "adjoint zero": int(empty.sum()), "adjoint cells": int(cells.sum()),
            "adjoint fallback": int((~empty & ~cells).sum()), "clamped images": int(clamp.sum())}


def adjoint_tol(name, want, plain, g, coef, s2):
    """The adjoints' tolerance against their plain versions (one tensor, or
    a tuple for the two-phase planes), and the sum of the magnitudes of each
    pixel's terms (the plain adjoint of |g|). Both sides add with atomics in a
    run-dependent order (the kernels' clamped pass and fallback, and the plain
    version's indexing backward), so an edge pixel that collects K terms,
    clipped's clamped coordinates or zoom_out's ~2070-pixel span, moves from
    run to run by up to ~K ulps of the sum of their magnitudes, and where the
    terms largely cancel that is far above 1e-4 x |want|. Every case gets
    2e-5 (2e-4 on clipped) + 1e-4 x |want| + 16 ulps (2^-20) of that sum."""
    atol = 2e-4 if name == "clipped" else 2e-5
    single = isinstance(want, torch.Tensor)
    mags = plain(g.abs(), coef, s2)
    mags = (mags,) if single else mags
    tols = [atol + 1e-4 * w.abs() + 2.0**-20 * m
            for w, m in zip((want,) if single else want, mags)]
    return (tols[0], mags[0]) if single else (tols, mags)


def ulps_of_terms(diff, mags):
    """The largest error in units of 2^-24 of the sum of |terms| (adjoint_tol
    allows 16)."""
    return (diff / (2.0**-24 * mags).clamp(min=1e-30)).max().item()


def check_warp(dev, rng):
    """The warp gather and its adjoint against the plain versions at each
    ADA bucket's S2 and win: eight geometries and one batch of ADA draws.
    Between them they take every path of both kernels (the gather's shared
    and global paths; the adjoint's zero tiles, cell path, shared-atomic
    fallback and clamped-output pass), counted from the tile geometry. Where
    no output is clamped the adjoint uses no atomic at all, and two launches
    must give the same bits."""
    from diagan_tpu_torch.ops import (
        affine_gather,
        affine_gather_plain,
        affine_scatter,
        affine_scatter_plain,
    )

    win = ada_win()
    err_g = err_s = ulps = 0.0
    exact = True
    paths, same = {}, 0
    for P in ada_pads():
        s2 = ada_s2(P)
        x2 = torch.randn((16, 3, s2, s2), generator=rng, device=dev)
        g = torch.randn((16, 3, win, win), generator=rng, device=dev)
        for name, coef in warp_coefs(P, dev).items():
            out, dx2 = affine_gather(x2, coef, win), affine_scatter(g, coef, s2)
            torch.cuda.synchronize()
            want, want_dx2 = affine_gather_plain(x2, coef, win), affine_scatter_plain(g, coef, s2)
            e = max_err(out, want)
            exact = exact and e == 0.0
            check(e <= 1e-6 * want.abs().max().item(), f"affine gather {name} s2={s2}: err {e}")
            diff = (dx2 - want_dx2).abs()
            tol, mags = adjoint_tol(name, want_dx2, affine_scatter_plain, g, coef, s2)
            check(bool((diff <= tol).all()),
                  f"affine scatter {name} s2={s2}: err {diff.max().item()}")
            err_g, err_s = max(err_g, e), max(err_s, diff.max().item())
            ulps = max(ulps, ulps_of_terms(diff, mags))
            used = warp_paths(coef, win, s2)
            if not used["clamped images"] and not used["adjoint fallback"]:
                check(torch.equal(affine_scatter(g, coef, s2), dx2),
                      f"affine scatter {name} s2={s2}: two launches differ")
                same += 1
            for k, v in used.items():
                paths.setdefault(k, {}).setdefault(name, 0)
                paths[k][name] += v
        del x2, g
    print(f"affine warp: S2 {[ada_s2(P) for P in ada_pads()]}, win {win}, "
          f"{len(WARP_CASES)} geometries + ADA draws at p=1: gather max abs err {err_g:.3e} "
          f"({'bit-exact' if exact else 'not bit-exact'}; tol 1e-6 x max|out|), adjoint "
          f"{err_s:.3e} (adjoint_tol: 2e-5, clipped 2e-4, + 1e-4 x |want| + 2^-20 x the sum "
          f"of |terms|), at most {ulps:.2f} x 2^-24 of that sum; adjoint bit-identical over "
          f"two launches on {same} cases with no clamped output and no fallback tile")
    # a buffer whose rows are not a multiple of 4 floats: the gather's 4-byte
    # copies and the adjoint's scalar stores
    s2 = ada_s2(ada_pads()[-1]) - 2
    x2 = torch.randn((16, 3, s2, s2), generator=rng, device=dev)
    g = torch.randn((16, 3, win, win), generator=rng, device=dev)
    for name in ("rot_scale", "ada_p1"):
        coef = warp_coefs(ada_pads()[-1], dev)[name]
        out, dx2 = affine_gather(x2, coef, win), affine_scatter(g, coef, s2)
        torch.cuda.synchronize()
        want, want_dx2 = affine_gather_plain(x2, coef, win), affine_scatter_plain(g, coef, s2)
        check(torch.equal(out, want), f"affine gather {name} s2={s2}: not bit-exact")
        diff = (dx2 - want_dx2).abs()
        tol, mags = adjoint_tol(name, want_dx2, affine_scatter_plain, g, coef, s2)
        check(bool((diff <= tol).all()), f"affine scatter {name} s2={s2}: err {diff.max().item()}")
        err_s = max(err_s, diff.max().item())
        ulps = max(ulps, ulps_of_terms(diff, mags))
    del x2, g
    print(f"  S2 {s2} (rows not a multiple of 4 floats), rot_scale and ADA draws: gather "
          f"bit-exact, adjoint within adjoint_tol; all cases: adjoint at most {ulps:.2f} x "
          f"2^-24 of the sum of |terms|")
    for k, by_case in paths.items():
        print(f"  {k}: " + ", ".join(f"{c} {v}" for c, v in by_case.items() if v))
        check(sum(by_case.values()) > 0, f"no call of check_warp took the path '{k}'")
    check(paths["clamped images"]["clipped"] > 0, "clipped took no clamped-output pass")
    return err_g, err_s


def check_scatter_launches(dev):
    """One call of each adjoint at the largest bucket on clipped draws
    launches its tile pass and its clamped-output pass and nothing else: no
    memset (the tile pass writes every pixel). Read from torch.profiler's
    device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from diagan_tpu_torch.ops import affine_scatter, affine_scatter2

    P = ada_pads()[-1]
    s2, win = ada_s2(P), ada_win()
    coef = warp_coefs(P, dev)["clipped"]
    g = torch.randn((16, 3, win, win), device=dev)
    gq = torch.randn((4, 16, 3, win // 2, win // 2), device=dev)
    calls = {"affine_scatter": (lambda: affine_scatter(g, coef, s2), "scatter_kernel",
                                "scatter_clamped_kernel"),
             "affine_scatter2": (lambda: affine_scatter2(gq, coef, s2), "scatter2_kernel",
                                 "scatter2_clamped_kernel")}
    for label, (call, tiles, clamped) in calls.items():
        call()
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        names = sorted({e.name for e in prof.events() if e.device_type == DeviceType.CUDA})
        print(f"device events of one {label} call: {names}")
        if not names:
            print("  the profiler recorded no device events: memset check not measured")
            continue
        check(not any("memset" in n.lower() for n in names), f"{label} issued a memset: {names}")
        check(all(any(re.search(rf"\b{k}\b", n) for n in names) for k in (tiles, clamped)),
              f"{label} did not launch its two passes: {names}")


WARP_KERNELS = ("gather_kernel", "scatter_kernel", "scatter_clamped_kernel", "gather2_kernel",
                "scatter2_kernel", "scatter2_clamped_kernel")  # csrc/affine_warp.cu's kernels


def sass_atomics(lib_path):
    """Atomic instructions in each warp kernel of a built library, from its
    SASS (cuobjdump): {kernel: {opcode: count}}. RED(G), ATOMG and ATOM
    (generic) reach global memory; ATOMS is shared memory."""
    from diagan_tpu_torch.ops import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    found, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:  # the mangled name holds "<length><name>E"
            name = next((k for k in WARP_KERNELS if f"{len(k)}{k}E" in m.group(1)), m.group(1))
            found[name] = {}
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?((?:REDG?|ATOM[GS]?)\b[.\w]*)", ln)
        if m and name:
            found[name][m.group(1)] = found[name].get(m.group(1), 0) + 1
    return found


def check_atomics():
    """The adjoints' tile passes (scatter_kernel, scatter2_kernel) have no
    global atomic in their SASS."""
    from diagan_tpu_torch.ops import _build

    found = sass_atomics(_build._target("affine_warp"))
    for name, ops in sorted(found.items()):
        print(f"SASS atomics, {name[:60]}: {ops or 'none'}")
    for kernel in ("scatter_kernel", "scatter2_kernel"):
        check(kernel in found, f"{kernel} not found in the SASS: {sorted(found)}")
        glob = {op: k for op, k in found[kernel].items() if not op.startswith("ATOMS")}
        check(not glob, f"{kernel} has global atomics: {glob}")


WARP2_PATHS = ("gather tiled", "gather global", "adjoint zero", "adjoint cells",
               "adjoint fallback", "clamped images")  # the two-phase pair's, from warp_paths


def check_warp2(dev, rng):
    """The two-phase warp gather and its adjoint against the plain versions
    at each ADA bucket's S2 and win, on the geometries of check_warp, and at
    the largest S2 less 2 (rows not a multiple of 4 floats: the gather's
    4-byte copies and the adjoint's scalar stores) on rot_scale and the ADA
    draws. Both are the interleaved pair's tile passes under another
    layout, so the paths each call takes are counted from the same tile
    geometry and every one must run (the gather's shared-memory and global
    paths, zoom_out's boxes exceeding the budget); the gather must give the
    plain version's bits on every case; where no output is clamped and no
    tile falls back, two launches of the adjoint must give the same bits,
    and those of the interleaved adjoint of the interleaved cotangent,
    de-interleaved."""
    from diagan_tpu_torch.ops import (
        affine_gather2_plain,
        affine_gather_2phase,
        affine_scatter,
        affine_scatter2,
        affine_scatter2_plain,
    )
    from diagan_tpu_torch.ops.ada_phase import _plane_offsets, _quarter_offsets

    win = ada_win()
    err_g = err_s = ulps = 0.0
    exact = True
    paths, same = {}, 0
    interleave = _quarter_offsets(16, 3, win, dev)  # the quarter grids as one win x win grid
    runs = [(P, ada_s2(P), None) for P in ada_pads()]
    runs.append((ada_pads()[-1], ada_s2(ada_pads()[-1]) - 2, ("rot_scale", "ada_p1")))
    for P, s2, names in runs:
        v0, v1 = (torch.randn((16, 3, s2 // 2, s2), generator=rng, device=dev) for _ in range(2))
        g = torch.randn((4, 16, 3, win // 2, win // 2), generator=rng, device=dev)
        g_int, planes = g.flatten()[interleave], _plane_offsets(16, 3, s2, dev)
        for name, coef in warp_coefs(P, dev).items():
            if names and name not in names:
                continue
            out = affine_gather_2phase(v0, v1, coef, win, s2)
            dv = affine_scatter2(g, coef, s2)
            torch.cuda.synchronize()
            check(all(y.shape == (16, 3, win // 2, win // 2) and y.is_contiguous() for y in out),
                  f"affine gather2 {name} s2={s2}: quarter grids {[tuple(y.shape) for y in out]}")
            want, want_dv = affine_gather2_plain(v0, v1, coef, win), affine_scatter2_plain(g, coef, s2)
            e = max(max_err(a, b) for a, b in zip(out, want))
            exact = exact and e == 0.0
            scale = max(b.abs().max().item() for b in want)
            check(e <= 1e-6 * scale, f"affine gather2 {name} s2={s2}: err {e}")
            check(e == 0.0, f"affine gather2 {name} s2={s2}: not bit-exact (err {e})")
            tols, mags = adjoint_tol(name, want_dv, affine_scatter2_plain, g, coef, s2)
            for got, w, tol, m in zip(dv, want_dv, tols, mags):
                diff = (got - w).abs()
                check(bool((diff <= tol).all()),
                      f"affine scatter2 {name} s2={s2}: err {diff.max().item()}")
                err_s = max(err_s, diff.max().item())
                ulps = max(ulps, ulps_of_terms(diff, m))
            err_g = max(err_g, e)
            del out, want, want_dv
            used = warp_paths(coef, win, s2)
            if not used["clamped images"] and not used["adjoint fallback"]:
                check(torch.equal(torch.stack(dv).flatten()[planes], affine_scatter(g_int, coef, s2)),
                      f"affine scatter2 {name} s2={s2}: not the interleaved adjoint's bits")
                check(all(torch.equal(a, b) for a, b in zip(affine_scatter2(g, coef, s2), dv)),
                      f"affine scatter2 {name} s2={s2}: two launches differ")
                same += 1
            for k in WARP2_PATHS:
                paths.setdefault(k, {}).setdefault(name, 0)
                paths[k][name] += used[k]
            del dv
        del v0, v1, g, g_int, planes
    print(f"two-phase affine warp: S2 {[s2 for _, s2, _ in runs]}, win {win}, "
          f"{len(WARP_CASES)} geometries + ADA draws at p=1 (S2 {runs[-1][1]}: rot_scale and "
          f"the draws): gather2 max abs err {err_g:.3e} "
          f"({'bit-exact' if exact else 'not bit-exact'} on every case; tol 1e-6 x max|out| "
          f"and bit-exact), adjoint "
          f"{err_s:.3e} (adjoint_tol), at most {ulps:.2f} x 2^-24 of the sum of |terms|; "
          f"on {same} cases with no clamped output and no fallback "
          f"tile the adjoint gives the same bits on two launches and equals the interleaved "
          f"adjoint of the interleaved cotangent, de-interleaved, bit for bit")
    for k, by_case in paths.items():
        print(f"  {k}: " + ", ".join(f"{c} {v}" for c, v in by_case.items() if v))
        check(sum(by_case.values()) > 0, f"no call of check_warp2 took the path '{k}'")
    check(same > 0, "check_warp2 held no case to the interleaved adjoint's bits")
    check(paths["clamped images"]["clipped"] > 0 and paths["adjoint fallback"]["zoom_in"] > 0,
          "clipped took no clamped-output pass or zoom_in no fallback")
    check(paths["gather global"]["zoom_out"] > 0, "zoom_out took no global-memory gather tile")
    return err_g, err_s


def check_polyphase_resample(dev, rng):
    """The whole polyphase resample (apply_affine, polyphase=True) against
    the interleaved one at the same static reflect pad, at SIZE px, batch 16,
    ADA draws at p = 0.9: values and d(loss)/d(images), at the JAX
    package's tolerance for the two forms (tests/test_ada_phase.py:103)."""
    from diagan_tpu_torch.models import ada

    G = ada.sample_affine_matrices(16, 0.9, SIZE, SIZE, torch.Generator().manual_seed(SEED + 3))
    x = torch.randn((16, SIZE, SIZE, 3), generator=rng, device=dev).tanh().requires_grad_(True)
    w = torch.randn(x.shape, generator=rng, device=dev)
    res = []
    for poly in (True, False):
        out = ada.apply_affine(x, G, polyphase=poly)
        (gx,) = torch.autograd.grad((out * w).sum(), x)
        res.append((out.detach(), gx))
    torch.cuda.synchronize()
    errs = []
    for what, got, want in zip(("values", "image gradient"), *res):
        diff = (got - want).abs()
        check(bool((diff <= 2e-5 + 2e-4 * want.abs()).all()),
              f"polyphase resample {what} differ from interleaved by {diff.max().item()}")
        errs.append(diff.max().item())
    P = min(SIZE - 1, int(0.75 * SIZE) + ada.PAD_K)
    print(f"polyphase resample at {SIZE} px, batch 16, ADA draws at p=0.9, P={P}: against the "
          f"interleaved form, values max abs err {errs[0]:.3e}, image gradient {errs[1]:.3e} "
          f"(tol 2e-5 + 2e-4 x |want|)")


def rolled_copies(n, size, n_base, seed):
    """n procedural images (data/synthetic.py): n_base of them, then copies
    rolled by one more pixel each along the width, as write_celeba makes
    phase 10's CelebA of 2,048 (the procedural images cost ~0.5 ms each at
    32 px and ~19 ms at 256 px on the card's host)."""
    from diagan_tpu_torch.data.synthetic import synthetic_natural

    base = synthetic_natural(n_base, size, seed=seed)[0]
    return np.concatenate([np.roll(base, t, axis=2) for t in range(-(-n // n_base))])[:n]


def train_path(dev, smi, work):
    """The training path at full width through its CLIs: phase 1 (ADA at a
    fixed p, R1, path regularisation, logit sweeps), phase 2 from that
    checkpoint with the LDR scores and the twin DRS D, then cli.generate and
    DRS on the phase-2 checkpoint. Launch counts are zeroed before and read
    after each path; kernel A's generic instance must launch on none.
    Returns (phase-1 trainer, {path: launches}, {path: kernel A launches by
    instance})."""
    import pickle

    from diagan_tpu_torch.cli import generate, train_ffhq, train_ffhq_phase2
    from diagan_tpu_torch.eval.drs import DRS
    from diagan_tpu_torch.eval.evaluate import make_disc_fn, make_gen_fn, read_stylegan2_ckpt
    from diagan_tpu_torch.models.stylegan2 import StyleGAN2Discriminator, StyleGAN2Generator
    from diagan_tpu_torch.ops import _build

    data = work / "data"
    data.mkdir(parents=True)
    t0 = time.perf_counter()
    np.save(data / f"ffhq_{SIZE}.npy", rolled_copies(N_DATA, SIZE, N_DATA // 4, seed=7))
    print(f"dataset: {N_DATA} synthetic {SIZE} px images ({N_DATA // 4} and rolled copies) in "
          f"{time.perf_counter() - t0:.2f} s")
    common = ["-d", "ffhq", "-r", str(data), "--size", str(SIZE), "--batch", "16",
              "--augment", "--augment_p", "0.3", "--work_dir", str(work),
              "--seed", str(SEED), "--device", dev.type]
    launches, fir = {}, {}

    def drive(name, fn, kernels, idle=()):
        _build.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        launches[name] = dict(_build.LAUNCHES)
        fir[name] = fir_launches(name)
        check(all(launches[name][k] > 0 for k in kernels) and
              all(launches[name][k] == 0 for k in idle), f"{name} launches {launches[name]}")
        print(f"{name}: {time.perf_counter() - t0:.2f} s, launches {launches[name]}")
        return out

    interleaved = tuple(k for k in _build.LAUNCHES if k not in WARP2 + SG3_KERNELS)
    torch.cuda.reset_peak_memory_stats()
    tr1 = drive("train_ffhq (8 steps)", lambda: train_ffhq.main(
        common + ["--exp_name", "p1", "--iter", "8", "--logit_save_steps", "2",
                  "--save_logit_after", "0"]), interleaved, WARP2)
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 1 metrics: {finite_metrics(tr1, ('d', 'g', 'r1', 'path'))}; peak device memory "
          f"{peak / 2**30:.2f} GiB [{smi}]")
    ckpt1, pkl = work / "p1" / "checkpoint" / "000008.pt", work / "p1" / "logits_netD.pkl"
    check(ckpt1.is_file() and pkl.is_file(), "phase 1 wrote no checkpoint or logits")
    with open(pkl, "rb") as f:
        logits = pickle.load(f)
    check(sorted(logits) == [2, 4, 6], f"logit steps {sorted(logits)}")
    check(all(v.shape == (N_DATA,) and np.isfinite(v).all() for v in logits.values()),
          "logits shape or values")

    tr2 = drive("train_ffhq_phase2 (4 steps)", lambda: train_ffhq_phase2.main(
        common + ["--exp_name", "p2", "--baseline_exp_name", "p1", "--p1_step", "8",
                  "--resample_score", "ldr_conf_3.0_ratio_50", "--iter", "12"]),
        interleaved, WARP2)
    ckpt2 = work / "p2" / "checkpoint" / "000012.pt"
    check(ckpt2.is_file() and tr2.weights is not None and tr2.drs_disc is not None,
          "phase 2 checkpoint, weights or drs_d missing")
    print(f"phase 2 metrics (steps 8-11: no R1 step): {finite_metrics(tr2, ('d', 'g', 'path'))}")

    imgs = drive("cli.generate (phase-2 checkpoint)", lambda: generate.main(
        ["--size", str(SIZE), "--sample", "4", "--pics", "1", "--ckpt", str(ckpt2),
         "--out_dir", str(work / "p2_samples"), "--seed", str(SEED), "--device", dev.type]),
        FORWARD_KERNELS)
    check(imgs.shape == (4, SIZE, SIZE, 3) and np.isfinite(imgs).all(), "generate output")
    g = StyleGAN2Generator(SIZE, STYLE_DIM, N_MLP, CH_MULT, device=dev)
    d = StyleGAN2Discriminator(SIZE, CH_MULT, device=dev)
    read_stylegan2_ckpt(ckpt2, g, d, use_drs=True)
    check(all(torch.equal(a, b) for a, b in zip(d.state_dict().values(),
                                                tr2.drs_disc.state_dict().values())),
          "read_stylegan2_ckpt did not load drs_d")
    drs = DRS(make_gen_fn(g, generator=torch.Generator(dev).manual_seed(SEED)), make_disc_fn(d),
              STYLE_DIM, generator=torch.Generator(dev).manual_seed(SEED + 1), batch_size=16,
              warmup_batches=2, device=dev)
    acc = drive("DRS (phase-2 checkpoint)", lambda: drs.generate_images(16), FORWARD_KERNELS)
    check(acc.shape == (16, SIZE, SIZE, 3) and np.isfinite(acc).all(), "DRS output")

    # the polyphase opt-in: the two-phase warp pair, and no interleaved warp
    with polyphase_env():
        trp = drive("train_ffhq polyphase (4 steps)", lambda: train_ffhq.main(
            common + ["--exp_name", "p1_poly", "--iter", "4"]),
            tuple(k for k in _build.LAUNCHES if k not in WARP + SG3_KERNELS), WARP)
    check((work / "p1_poly" / "checkpoint" / "000004.pt").is_file(),
          "the polyphase run wrote no checkpoint")
    print(f"polyphase phase 1 metrics: {finite_metrics(trp, ('d', 'g', 'r1', 'path'))}")
    return tr1, launches, fir


def grads_card_vs_cpu(dev, work):
    """One training step's pieces, card against CPU, at 32 px and width 1/4
    with the same weights and the same injected draws: the D loss with ADA
    at p = 1, R1, the G step through ADA, and path regularisation. Each
    piece starts from the CPU side's weights."""
    import copy

    from diagan_tpu_torch.data.synthetic import synthetic_natural
    from diagan_tpu_torch.models.ada import sample_augment
    from diagan_tpu_torch.models.stylegan2 import (
        NoiseInjection,
        StyleGAN2Discriminator,
        StyleGAN2Generator,
    )
    from diagan_tpu_torch.train.stylegan2_trainer import FakeDraws, StyleGAN2Trainer

    size, bs, width = 32, 4, 0.25
    torch.manual_seed(SEED)
    g_cpu = StyleGAN2Generator(size, STYLE_DIM, N_MLP, CH_MULT, width_scale=width, device="cpu")
    d_cpu = StyleGAN2Discriminator(size, CH_MULT, width_scale=width, device="cpu")
    with torch.no_grad():
        for m in g_cpu.modules():
            if isinstance(m, NoiseInjection):
                m.weight.fill_(0.1)
    rng = np.random.default_rng(SEED)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    real = torch.from_numpy(rng.uniform(-1, 1, (bs, size, size, 3)).astype(np.float32))
    z1, z2 = normal(bs, STYLE_DIM), normal(bs, STYLE_DIM)
    noises = [normal(*s) for s in g_cpu.synthesis.noise_shapes(bs)]
    aug = [sample_augment(bs, 1.0, size, size, torch.Generator().manual_seed(k)) for k in range(3)]
    zp = normal(bs // 2, STYLE_DIM)
    noises_p = [normal(*s) for s in g_cpu.synthesis.noise_shapes(bs // 2)]
    path_noise = normal(bs // 2, size, size, 3)
    images = synthetic_natural(8, size, seed=3)[0]
    tr = {side: StyleGAN2Trainer(work / side, copy.deepcopy(g_cpu).to(d),
                                 copy.deepcopy(d_cpu).to(d), images, num_steps=1,
                                 batch_size=bs, augment_p=1.0, device=d)
          for side, d in (("cpu", torch.device("cpu")), ("card", dev))}

    def fakes(d):
        return FakeDraws(z1.to(d), z2.to(d), 3, [t.to(d) for t in noises])

    pieces = {
        "D loss (ADA p=1)": ("disc", lambda t, d: t.d_step(t.disc, t.d_optim, real.to(d),
                                                           fakes(d), aug[0], aug[1])),
        "R1": ("disc", lambda t, d: t.r1_step(t.disc, t.d_optim, real.to(d), aug[2])),
        "G through ADA": ("gen", lambda t, d: t.g_step(fakes(d), aug[0])),
        "path length": ("gen", lambda t, d: t.path_step(
            zp.to(d), [n.to(d) for n in noises_p], path_noise.to(d))),
    }
    for name, (net, run) in pieces.items():
        cpu, card = tr["cpu"], tr["card"]
        card.gen.load_state_dict(cpu.gen.state_dict())
        card.disc.load_state_dict(cpu.disc.state_dict())
        card.pl_mean = cpu.pl_mean.to(dev)
        m_cpu, m_card = run(cpu, torch.device("cpu")), run(card, dev)
        torch.cuda.synchronize()
        want = [p.grad for p in getattr(cpu, net).parameters() if p.grad is not None]
        got = [p.grad.cpu() for p in getattr(card, net).parameters() if p.grad is not None]
        check(len(got) == len(want) > 0, f"{name}: gradient sets differ")
        scale = max(1.0, max(w.abs().max().item() for w in want))
        err = max(max_err(a, b) for a, b in zip(got, want))
        check(err <= 1e-3 * scale, f"{name}: grad err {err} > 1e-3 x {scale}")
        m_err = max(abs(float(m_card[k]) - float(m_cpu[k])) / max(1.0, abs(float(m_cpu[k])))
                    for k in m_cpu)
        check(m_err <= 1e-3, f"{name}: metrics {m_cpu} vs {m_card}")
        print(f"card vs CPU, {name}: {len(want)} grads, max abs err {err:.3e} "
              f"(max|grad| {scale:.3e}; tol 1e-3 x max(1, max|grad|)); "
              f"metrics rel err {m_err:.3e}")

    # the polyphase augment (resample, then colour) and its image gradient
    from diagan_tpu_torch.models.ada import apply_affine, apply_color

    G, C = aug[0]
    w = normal(bs, size, size, 3)
    res = []
    for d in (torch.device("cpu"), dev):
        x = real.to(d).requires_grad_(True)
        out = apply_color(apply_affine(x, G, polyphase=True), C)
        (gx,) = torch.autograd.grad((out * w.to(d)).sum(), x)
        res.append((out.detach().cpu(), gx.cpu()))
    for what, want, got in zip(("polyphase augment", "its image gradient"), *res):
        scale = max(1.0, want.abs().max().item())
        err = max_err(got, want)
        check(err <= 1e-3 * scale, f"card vs CPU, {what}: err {err} > 1e-3 x {scale}")
        print(f"card vs CPU, {what} ({size} px, ADA draws at p=1): max abs err {err:.3e} "
              f"(tol 1e-3 x max(1, max|.|) = {1e-3 * scale:.3e})")


def time_new_kernels(dev, rng, ch, k4, smi, launches, errs):
    """The training path's kernels at their largest path shapes: kernel,
    plain version, one PyTorch library call for the same function where
    there is one, and the bytes/ops bound."""
    import torch.nn.functional as F

    from diagan_tpu_torch.ops import (
        fused_leaky_relu_backward,
        fused_leaky_relu_backward_plain,
        upfirdn2d,
        upfirdn2d_plain,
    )

    kernels = []
    g = torch.randn((16, ch[SIZE], SIZE, SIZE), generator=rng, device=dev)
    y = torch.randn(g.shape, generator=rng, device=dev)
    n = g.numel()
    b, by = bound(3 * n * 4 + ch[SIZE] * 4, 4 * n)
    kernels.append({
        "name": "fused_leaky_relu_backward", "route": "triton",
        "source": "diagan_tpu_torch/ops/fused_act.py",
        "replaces": "diagan_tpu/ops/fused_act.py:68",
        "launches": launches["fused_leaky_relu_backward"], "max_abs_err": errs["flr_bwd"],
        "ms": cuda_ms(lambda: fused_leaky_relu_backward(g, y)),
        "plain_ms": cuda_ms(lambda: fused_leaky_relu_backward_plain(g, y)),
        "bound_ms": b, "bound_by": by,
        # no single PyTorch call masks, scales and sums per channel
        "library_ms": None,
        "shape": f"{tuple(g.shape)} fp32, dx and db (styled conv at {SIZE} px)",
    })
    del g, y

    # upfirdn2d backward of the G upsample blur at SIZE: the flipped taps with
    # pads (2, 2), i.e. one depthwise conv2d (correlation) with padding 2
    x = torch.randn((16, ch[SIZE], SIZE + 1, SIZE + 1), generator=rng, device=dev,
                    requires_grad=True)
    taps = k4 * 4
    out, out_p = upfirdn2d(x, taps, pad=(1, 1)), upfirdn2d_plain(x, taps, pad=(1, 1))
    gy = torch.randn(out.shape, generator=rng, device=dev)
    w_dw = taps.expand(x.shape[1], 1, 4, 4).contiguous()

    def lib():
        return F.conv2d(gy, w_dw, padding=2, groups=x.shape[1])

    gx = torch.autograd.grad(out, x, gy, retain_graph=True)[0]
    check(max_err(lib(), gx) <= 1e-5 * gx.abs().max().item(),
          "depthwise conv2d yardstick disagrees with the upfirdn2d backward")
    b, by = bound((gy.numel() + x.numel()) * 4, x.numel() * 16 * 2)
    kernels.append({
        "name": "upfirdn2d_backward", "route": "cuda", "source": "diagan_tpu_torch/csrc/upfirdn2d.cu",
        "replaces": "diagan_tpu/ops/fir_pallas.py:44,131,226 (backward, _vjp_bwd:379)",
        "launches": launches["upfirdn2d_backward"], "max_abs_err": errs["fir_bwd"],
        "ms": cuda_ms(lambda: torch.autograd.grad(out, x, gy, retain_graph=True)),
        "plain_ms": cuda_ms(lambda: torch.autograd.grad(out_p, x, gy, retain_graph=True),
                            iters=3),
        "bound_ms": b, "bound_by": by, "library_ms": cuda_ms(lib),
        "shape": f"{tuple(gy.shape)} -> {tuple(x.shape)} fp32 4x4 taps "
                 f"(G upsample blur backward at {SIZE} px)",
    })
    del x, out, out_p, gy, gx

    for k in kernels:
        print(f"{k['name']} at {k['shape']}: {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
              f"library {k['library_ms']}, bound {k['bound_ms']:.4f} ms ({k['bound_by']}) "
              f"[{smi}]")
    return kernels


def in_turns(fns):
    """Device time (graph_ms) of each of fns {name: fn}, in turns: forward
    through the names, then back. {name: (first, second)}."""
    ms = {}
    for name in [*fns, *reversed(fns)]:
        ms.setdefault(name, []).append(graph_ms(fns[name]))
    return {name: tuple(v) for name, v in ms.items()}


def against_warp(root):
    """The four warp kernels of another checkout (its
    diagan_tpu_torch/csrc/affine_warp.cu, built here with the port's nvcc
    flags), for timing against this one on the same card: {"root", "gather",
    "scatter", "gather2", "scatter2"}, the last four with the arguments and
    outputs of affine_gather, affine_scatter, ops.ada_phase._gather2 (the
    four quarter grids in one buffer) and affine_scatter2."""
    import ctypes

    from diagan_tpu_torch.ops import _build

    src = Path(root) / "diagan_tpu_torch" / "csrc" / "affine_warp.cu"
    lib_path = _build.BUILD_DIR / "against_affine_warp.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))

    def bind(name, pointers):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 4 + [ctypes.c_void_p]

        def launch(tensors, n, c, s2, win):
            err = fn(*(t.data_ptr() for t in tensors), n, c, s2, win,
                     torch.cuda.current_stream().cuda_stream)
            check(err == 0, f"{root}: {name} launch failed, cudaError {err}")
        return launch

    gather, scatter = bind("affine_warp_gather", 3), bind("affine_warp_scatter", 3)
    gather2, scatter2 = bind("affine_warp2_gather", 4), bind("affine_warp2_scatter", 4)

    def gather_fn(x2, coef, win):
        n, c, s2, _ = x2.shape
        out = torch.empty((n, c, win, win), device=x2.device)
        gather((x2, coef, out), n, c, s2, win)
        return out

    def scatter_fn(g, coef, s2):
        n, c, win, _ = g.shape
        dx2 = torch.empty((n, c, s2, s2), device=g.device)
        scatter((g, coef, dx2), n, c, s2, win)
        return dx2

    def gather2_fn(v0, v1, coef, win):
        n, c, _, s2 = v0.shape
        out = torch.empty((4, n, c, win // 2, win // 2), device=v0.device)
        gather2((v0, v1, coef, out), n, c, s2, win)
        return out

    def scatter2_fn(g, coef, s2):
        _, n, c, h2, _ = g.shape
        dv = torch.empty((2, n, c, s2 // 2, s2), device=g.device)
        scatter2((g, coef, dv[0], dv[1]), n, c, s2, 2 * h2)
        return dv[0], dv[1]

    return {"root": root, "gather": gather_fn, "scatter": scatter_fn, "gather2": gather2_fn,
            "scatter2": scatter2_fn}


def against_fir(root, tag=""):
    """Kernel A of another checkout (its diagan_tpu_torch/csrc/upfirdn2d.cu,
    built here with the port's nvcc flags), called as ops/upfirdn2d.py calls
    upfirdn2d_forward (the same signature and instance codes), for timing and
    comparing against this one on the same card: a function with the
    arguments and output of upfirdn2d's forward. An instance the other
    checkout does not have (it refuses the code) runs on its generic
    instance; `fir.took` maps each instance name to the one that ran."""
    import ctypes

    from diagan_tpu_torch.ops import _build
    from diagan_tpu_torch.ops.upfirdn2d import (
        _DTYPE_CODE,
        FIR_INSTANCES,
        _out_size,
        _parse,
        fir_instance,
        layout,
    )

    src = Path(root) / "diagan_tpu_torch" / "csrc" / "upfirdn2d.cu"
    lib_path = _build.BUILD_DIR / f"against_upfirdn2d{tag}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib_path)).upfirdn2d_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 8
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])

    def fir(x, taps, up=1, down=1, pad=(0, 0)):
        (up_x, up_y), (down_x, down_y), (p_x0, p_x1, p_y0, p_y1) = _parse(up, down, pad)
        n, c, h, w = x.shape
        kh, kw = taps.shape
        oh, ow = _out_size(h, up_y, p_y0, p_y1, kh, down_y), _out_size(w, up_x, p_x0, p_x1, kw,
                                                                       down_x)
        fmt = layout(x)
        y = torch.empty((n, c, oh, ow), dtype=x.dtype, device=x.device, memory_format=fmt)
        inst = fir_instance(kh, kw, up, down, x.dtype, fmt)

        def launch(name):
            return fn(x.data_ptr(), y.data_ptr(), taps.data_ptr(), _DTYPE_CODE[x.dtype],
                      FIR_INSTANCES.index(name), n, c, h, w, oh, ow, *x.stride(), *y.stride(),
                      kh, kw, up_x, up_y, down_x, down_y, p_x0, p_y0,
                      torch.cuda.current_stream().cuda_stream)
        err = launch(fir.took.get(inst, inst))
        if err == -1 and inst not in fir.took:  # an instance it does not have
            fir.took[inst] = "generic"
            err = launch("generic")
        check(err == 0, f"{root}: upfirdn2d_forward {inst} failed, code {err}")
        fir.took.setdefault(inst, inst)
        return y
    fir.root, fir.took = root, {}
    return fir


def entry_in_turns(fns, name, plain, b_by, smi, **fields):
    """The kernels-line entry of the warp kernel `name` among fns {label: fn}
    (another checkout's kernel first where there is one, the library call
    last): device time of CUDA-graph replays in turns (in_turns), and the
    kernel's eager time (cuda_ms) and its plain version's."""
    ms = in_turns(fns)
    labels = list(fns)
    b, by = b_by
    entry = {"name": name, "route": "cuda", "source": "diagan_tpu_torch/csrc/affine_warp.cu",
             **fields, "ms": sum(ms[name]) / 2, "ms_eager": cuda_ms(fns[name]),
             "plain_ms": cuda_ms(plain, iters=3), "bound_ms": b, "bound_by": by,
             "library_ms": sum(ms[labels[-1]]) / 2}
    if labels[0] != name:
        entry["against_ms"] = sum(ms[labels[0]]) / 2
    print(f"{name} at {entry['shape']}, in turns (device time): " + "; ".join(
        f"{k} {t1:.4f} / {t2:.4f} ms" for k, (t1, t2) in ms.items()) +
        f"; eager {entry['ms_eager']:.4f} ms, plain {entry['plain_ms']:.4f} ms, bound "
        f"{b:.4f} ms ({by}), {b / entry['ms']:.2f} of the bound [{smi}]")
    entry["shape"] += "; ms and library_ms: device time of CUDA-graph replays, mean of two turns"
    return entry


def time_warp(dev, rng, smi, errs, against=None):
    """The interleaved warp pair at the largest bucket on one batch of ADA
    draws at p = 1 (the kernels-line entries, without launches): each kernel
    in turns with grid_sample and its backward as device time of CUDA-graph
    replays (graph_ms), and eagerly (cuda_ms); with `against` (against_warp:
    another checkout's kernels, e.g. the parent commit's), those too, in the
    same turns."""
    import torch.nn.functional as F

    from diagan_tpu_torch.ops import (
        affine_gather,
        affine_gather_plain,
        affine_scatter,
        affine_scatter_plain,
    )
    from diagan_tpu_torch.ops.warp import _taps as warp_taps

    win = ada_win()
    P = ada_pads()[-1]
    s2 = ada_s2(P)
    coef = ada_coef(P, SEED + 1).to(dev)
    x2 = torch.randn((16, 3, s2, s2), generator=rng, device=dev)
    gw = torch.randn((16, 3, win, win), generator=rng, device=dev)
    index, _ = warp_taps(coef, win, s2)
    touched = sum(torch.unique(torch.stack([i[k] for i in index])).numel() for k in range(16))
    del index
    idx = torch.arange(win, dtype=torch.float32, device=dev)
    ii, jj = idx[:, None], idx[None, :]
    c = coef[:, :, None, None]
    qy, qx = c[:, 0] * ii + c[:, 1] * jj + c[:, 2], c[:, 3] * ii + c[:, 4] * jj + c[:, 5]
    grid = torch.stack([2 * qx / (s2 - 1) - 1, 2 * qy / (s2 - 1) - 1], -1)

    def lib_gather():
        return F.grid_sample(x2, grid, mode="bilinear", padding_mode="border", align_corners=True)

    def lib_scatter():  # grid_sample's backward as one call: bilinear, border, x2's grad only
        return torch.ops.aten.grid_sampler_2d_backward(gw, x2, grid, 0, 1, True, [True, False])[0]

    out, dx2 = affine_gather(x2, coef, win), affine_scatter(gw, coef, s2)
    # grid_sample takes normalised coordinates, which round the source point
    # by about 1e-4 pixel: agreement to 1e-3 x max|.|
    check(max_err(lib_gather(), out) <= 1e-3 * x2.abs().max().item(),
          "grid_sample yardstick disagrees with the warp gather")
    check(max_err(lib_scatter(), dx2) <= 1e-3 * dx2.abs().max().item(),
          "grid_sample backward disagrees with the adjoint")
    gathers = {"affine_warp_gather": lambda: affine_gather(x2, coef, win),
               "grid_sample": lib_gather}
    scatters = {"affine_warp_scatter": lambda: affine_scatter(gw, coef, s2),
                "grid_sample backward": lib_scatter}
    if against:
        root, a_gather, a_scatter = against["root"], against["gather"], against["scatter"]
        check(torch.equal(a_gather(x2, coef, win), out), f"{root}: gather differs")
        a_dx2 = a_scatter(gw, coef, s2)
        diff = (a_dx2 - dx2).abs()
        check(bool((diff <= 2e-5 + 1e-4 * dx2.abs()).all()), f"{root}: adjoint differs")
        print(f"{root}'s interleaved adjoint on the timed draws ({warp_paths(coef, win, s2)}): "
              f"{'the same bits' if torch.equal(a_dx2, dx2) else 'other bits'}, max abs "
              f"difference {diff.max().item():.3e}")
        del a_dx2, diff
        gathers = {f"{root} gather": lambda: a_gather(x2, coef, win), **gathers}
        scatters = {f"{root} scatter": lambda: a_scatter(gw, coef, s2), **scatters}
    del out, dx2
    out_bytes, coef_bytes = gw.numel() * 4, coef.numel() * 4
    pix_ops = 16 * win * win * 12  # coordinates and weights, once per pixel
    kernels = [
        entry_in_turns(gathers, "affine_warp_gather", lambda: affine_gather_plain(x2, coef, win),
                       bound(touched * 3 * 4 + out_bytes + coef_bytes, pix_ops + gw.numel() * 9),
                       smi, replaces="diagan_tpu/ops/warp_pallas.py:239",
                       max_abs_err=errs["gather"],
                       shape=f"{tuple(x2.shape)} -> {tuple(gw.shape)} fp32, ADA draws at p=1 "
                             f"({touched} source pixels touched)"),
        entry_in_turns(scatters, "affine_warp_scatter", lambda: affine_scatter_plain(gw, coef, s2),
                       bound(out_bytes + x2.numel() * 4 + coef_bytes, pix_ops + gw.numel() * 8),
                       smi, replaces="diagan_tpu/ops/warp_pallas.py:397",
                       max_abs_err=errs["scatter"],
                       shape=f"{tuple(gw.shape)} -> {tuple(x2.shape)} fp32, ADA draws at p=1"),
    ]
    del x2, gw, grid
    return kernels


def ada_passes(dev, P):
    """Every FIR pass of ADA's resample at reflect pad P, batch 16, in both
    forms, and the backwards of the two interleaved up-passes (the largest
    down passes): (form, pass, input shape, taps, up, down, pad, one cuDNN
    depthwise call that computes the same function, up to a crop)."""
    import torch.nn.functional as F

    from diagan_tpu_torch.models.ada import PAD_K, _polyphase_taps, _sym6_taps
    from diagan_tpu_torch.ops.ada_phase import PARITIES

    s, win = SIZE + 2 * P, ada_win()
    h2 = win // 2
    kyf, kxf, ky, kx = _sym6_taps(dev)
    b0, b1, *down = _polyphase_taps(dev)

    def dw(t):  # one filter per channel
        return t.expand(3, 1, *t.shape).contiguous()

    def flip(t):
        return dw(torch.flip(t, (0, 1)))

    x_up = ("x up-pass", kxf, (2, 1), 1, (PAD_K, PAD_K - 1, 0, 0),
            lambda x: F.conv_transpose2d(x, dw(kxf), stride=(1, 2), padding=(0, PAD_K - 1),
                                         groups=3))
    passes = [
        ("interleaved", "y up-pass", (16, 3, s, s), kyf, (1, 2), 1, (0, 0, PAD_K, PAD_K - 1),
         lambda x: F.conv_transpose2d(x, dw(kyf), stride=(2, 1), padding=(PAD_K - 1, 0),
                                      groups=3)),
        ("interleaved", x_up[0], (16, 3, 2 * s, s), *x_up[1:]),
        ("interleaved", "y down-pass", (16, 3, win, win), ky, 1, (1, 2),
         (0, 0, PAD_K - 1, PAD_K - 1),
         lambda x: F.conv2d(x, flip(ky), stride=(2, 1), padding=(PAD_K - 1, 0), groups=3)),
        ("interleaved", "x down-pass", (16, 3, h2, win), kx, 1, (2, 1),
         (PAD_K - 1, PAD_K - 1, 0, 0),
         lambda x: F.conv2d(x, flip(kx), stride=(1, 2), padding=(0, PAD_K - 1), groups=3)),
        ("polyphase", x_up[0], (16, 3, s, s), *x_up[1:]),
    ]
    for phi, b in enumerate((b0, b1)):  # pads (0, 0, 3 - phi, 2 + phi): pad 3, crop phi
        passes.append(("polyphase", f"y phase-{phi} pass", (16, 3, s, 2 * s), b, 1, 1,
                       (0, 0, 3 - phi, 2 + phi),
                       lambda x, b=b, phi=phi: F.conv2d(x, flip(b), padding=(3, 0),
                                                        groups=3)[:, :, phi:phi + s]))
    for (a, b), k2 in zip(PARITIES, down):
        py0, px0 = (2, 3)[a], (2, 3)[b]
        passes.append(("polyphase", f"6x6 down-FIR Y{a}{b}", (16, 3, h2, h2), k2, 1, 1,
                       (px0, 5 - px0, py0, 5 - py0),
                       lambda x, k2=k2, py0=py0, px0=px0: F.conv2d(x, flip(k2), padding=3, groups=3)
                       [:, :, 3 - py0:3 - py0 + h2, 3 - px0:3 - px0 + h2]))
    # the backward of an up-pass: flipped taps, down 2, pads (5, 5)
    passes.append(("interleaved", "y up-pass backward", (16, 3, 2 * s, s),
                   torch.flip(kyf, (0, 1)), 1, (1, 2), (0, 0, PAD_K - 1, PAD_K - 1),
                   lambda x: F.conv2d(x, dw(kyf), stride=(2, 1), padding=(PAD_K - 1, 0),
                                      groups=3)))
    passes.append(("interleaved", "x up-pass backward", (16, 3, 2 * s, 2 * s),
                   torch.flip(kxf, (0, 1)), 1, (2, 1), (PAD_K - 1, PAD_K - 1, 0, 0),
                   lambda x: F.conv2d(x, dw(kxf), stride=(1, 2), padding=(0, PAD_K - 1),
                                      groups=3)))
    return passes


def time_fir_instances(dev, rng, ch, k4, smi, against=()):
    """Kernel A on every ADA pass of both forms at the largest pad and on the
    SIZE px blurs (the G upsample blur and its backward, the ToRGB skip and
    its backward), each against one cuDNN depthwise call and its bytes
    bound. Both are timed as device time (graph_ms) in turns, kernel A,
    cuDNN, cuDNN, kernel A, and kernel A also eagerly (cuda_ms: the host's
    launch cost included); with `against` (against_fir: other checkouts'
    kernel A) those too, first and last in the turns, after a check that
    each gives the same bits. Then each instance at its largest such shape,
    with its plain version. Returns {instance: kernels-line entry, without
    launches and error}."""
    import torch.nn.functional as F

    from diagan_tpu_torch.ops import upfirdn2d, upfirdn2d_plain
    from diagan_tpu_torch.ops.upfirdn2d import fir_instance

    c = ch[SIZE]
    k16 = k4 * 4

    def dw(t, n):  # one filter per channel
        return t.expand(n, 1, *t.shape).contiguous()

    passes = [
        ("blur", "G upsample blur", (16, c, SIZE + 1, SIZE + 1), k16, 1, 1, (1, 1),
         lambda x: F.conv2d(x, dw(k16, c), padding=1, groups=c)),
        ("blur", "G upsample blur backward", (16, c, SIZE, SIZE), k16, 1, 1, (2, 2),
         lambda x: F.conv2d(x, dw(k16, c), padding=2, groups=c)),
        ("blur", "ToRGB skip", (16, 3, SIZE // 2, SIZE // 2), k16, 2, 1, (2, 1),
         lambda x: F.conv_transpose2d(x, dw(k16, 3), stride=2, padding=1, groups=3)),
        ("blur", "ToRGB skip backward", (16, 3, SIZE, SIZE), k16, 1, 2, (1, 1),
         lambda x: F.conv2d(x, dw(k16, 3), stride=2, padding=1, groups=3)),
    ]
    passes += ada_passes(dev, ada_pads()[-1])
    largest, sums, ratios = {}, {}, {}
    for form, name, shape, taps, up, down, pad, lib in passes:
        xp = torch.randn(shape, generator=rng, device=dev)
        y = upfirdn2d(xp, taps, up, down, pad)
        check(max_err(lib(xp), y) <= 1e-5 * y.abs().max().item(),
              f"depthwise yardstick disagrees with the {form} {name}")
        inst = fir_instance(*taps.shape, up, down, xp.dtype, torch.contiguous_format)
        fns = {"a": lambda: upfirdn2d(xp, taps, up, down, pad), "lib": lambda: lib(xp)}
        for o in reversed(against):
            check(torch.equal(o(xp, taps, up, down, pad), y),
                  f"{o.root}'s fp32 {inst} gives other bits on the {form} {name}")
            fns = {o.root: lambda o=o: o(xp, taps, up, down, pad), **fns}
        ms = in_turns(fns)
        (a1, a2), (l1, l2) = ms["a"], ms["lib"]
        t_a, t_lib = (a1 + a2) / 2, (l1 + l2) / 2
        t_eager = cuda_ms(lambda: upfirdn2d(xp, taps, up, down, pad))
        nbytes = (xp.numel() + y.numel()) * 4
        real_taps = taps.numel() // (math.prod(up) if isinstance(up, tuple) else up**2)
        b_p, by = bound(nbytes, y.numel() * real_taps * 2)
        if form != "blur":
            sums.setdefault(form, [0.0, 0.0, 0.0])
            sums[form] = [u + v for u, v in zip(sums[form], (t_a, t_lib, b_p))]
        other = ""
        for o in against:
            o1, o2 = ms[o.root]
            ratios.setdefault(o.root, {})
            ratios[o.root][inst] = max(ratios[o.root].get(inst, 0.0), 2 * t_a / (o1 + o2))
            other += f", {o.root} {o1:.4f} / {o2:.4f} ms (the same bits)"
        print(f"kernel A {inst}, {form} {name} {tuple(xp.shape)} -> {tuple(y.shape)}: "
              f"{a1:.4f} / {a2:.4f} ms, cuDNN depthwise {l1:.4f} / {l2:.4f} ms{other} (device "
              f"time, two turns), bound {b_p:.4f} ms ({by}), {b_p / t_a:.2f} of the bound; "
              f"kernel A eager {t_eager:.4f} ms [{smi}]")
        if nbytes > largest.get(inst, (0,))[0]:
            plain = cuda_ms(lambda: upfirdn2d_plain(xp, taps, up, down, pad), iters=2, warmup=1)
            largest[inst] = (nbytes, {
                "name": f"upfirdn2d/{inst}", "route": "cuda",
                "source": "diagan_tpu_torch/csrc/upfirdn2d.cu",
                "replaces": "diagan_tpu/ops/fir_pallas.py:44,131,226",
                "ms": t_a, "plain_ms": plain, "bound_ms": b_p, "bound_by": by,
                "library_ms": t_lib,
                "shape": f"{tuple(xp.shape)} -> {tuple(y.shape)} fp32, {form} {name}; ms and "
                         f"library_ms: device time of CUDA-graph replays, mean of two turns; "
                         f"library: one cuDNN depthwise convolution",
            })
        del xp, y
    for form, (t_a, t_lib, b_p) in sums.items():
        print(f"ADA {form} FIR passes summed (forward, and the up-pass backwards): kernel A "
              f"{t_a:.4f} ms, cuDNN depthwise {t_lib:.4f} ms, bound {b_p:.4f} ms [{smi}]")
    for root, r in ratios.items():
        print(f"fp32 kernel A against {root}: time / the other's, the largest over each "
              f"instance's passes: { {k: round(v, 4) for k, v in r.items()} } [{smi}]")
    return {inst: entry for inst, (_, entry) in largest.items()}


def time_fir_generic(dev, rng, ch, k4, smi, against=()):
    """Kernel A's generic instance (A0) on channels-last input: the SIZE px G
    upsample blur, (16, 128, 257, 257) channels-last, the shape of the JAX
    package's NHWC FIR (`_fir2d_nhwc`, #2), in fp32 and bf16, and an up-2
    pass at the same width. Each launches the generic instance and the
    channels-last body named for it (cl_launches: the fixed 4x4 one, the
    run-time one), matches its plain version (fp32 1e-5,
    bf16 1e-2 x max|out|) and is timed as device time (graph_ms) in turns
    with one cuDNN call on the same channels-last input (and with `against`,
    other checkouts' kernel A), beside its plain version and its bytes
    bound."""
    import torch.nn.functional as F

    from diagan_tpu_torch.ops import _build, upfirdn2d, upfirdn2d_plain
    from diagan_tpu_torch.ops.upfirdn2d import fir_instance

    c, k16 = ch[SIZE], k4 * 4
    cl = torch.channels_last
    passes = [
        ("G upsample blur", (16, c, SIZE + 1, SIZE + 1), 1, 1, (1, 1), "fir_cl_fixed_kernel",
         (0, 1), lambda x, w: F.conv2d(x, w, padding=1, groups=c)),
        ("up-2 pass", (16, c, SIZE // 2, SIZE // 2), 2, 1, (2, 1), "fir_cl_kernel", (1, 0),
         lambda x, w: F.conv_transpose2d(x, w, stride=2, padding=1, groups=c)),
    ]
    for name, shape, up, down, pad, kernel, want_ran, lib in passes:
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=rng, device=dev).to(dt).contiguous(memory_format=cl)
            inst = fir_instance(4, 4, up, down, dt, cl)
            check(inst == "generic", f"the channels-last {name} takes {inst}")
            w = k16.to(dt).expand(c, 1, 4, 4).contiguous()
            before, cl0 = _build.FIR_INSTANCES["generic"], cl_launches()
            y = upfirdn2d(x, k16, up, down, pad)
            ran = tuple(b - a for a, b in zip(cl0, cl_launches()))
            check(_build.FIR_INSTANCES["generic"] == before + 1 and ran == want_ran
                  and y.is_contiguous(memory_format=cl),
                  f"the channels-last {name} launched the generic instance "
                  f"{_build.FIR_INSTANCES['generic'] - before} times, its bodies (run-time, "
                  f"fixed) {ran} times, not {kernel}")
            want = upfirdn2d_plain(x, k16, up, down, pad)
            err = max_err(y, want)
            tol = 1e-5 if dt == torch.float32 else 1e-2
            check(err <= tol * want.float().abs().max().item(), f"generic {name} {dt} err {err}")
            check(max_err(lib(x, w), y) <= 2 * tol * y.float().abs().max().item(),
                  f"the cuDNN yardstick disagrees with the generic instance's {name} {dt}")
            fns = {"a": lambda: upfirdn2d(x, k16, up, down, pad), "lib": lambda: lib(x, w)}
            for o in reversed(against):
                fns = {o.root: lambda o=o: o(x, k16, up, down, pad), **fns}
            ms = in_turns(fns)
            (a1, a2), (l1, l2) = ms["a"], ms["lib"]
            plain = cuda_ms(lambda: upfirdn2d_plain(x, k16, up, down, pad), iters=2, warmup=1)
            b_p, by = bound((x.numel() + y.numel()) * x.element_size(),
                            y.numel() * 16 // (up * up) * 2)
            other = "".join(f", {o.root} {ms[o.root][0]:.4f} / {ms[o.root][1]:.4f} ms"
                            for o in against)
            print(f"kernel A generic (A0) {kernel}, {name} channels-last "
                  f"{tuple(x.shape)} -> {tuple(y.shape)} {str(dt)[6:]}: {a1:.4f} / {a2:.4f} ms, "
                  f"cuDNN on the same channels-last input {l1:.4f} / {l2:.4f} ms{other} (device "
                  f"time, two turns), "
                  f"plain {plain:.4f} ms, bound {b_p:.4f} ms ({by}), {2 * b_p / (a1 + a2):.2f} "
                  f"of the bound; max abs err vs plain {err:.3e} [{smi}]")
            del x, y, want


def time_warp2(dev, rng, smi, errs, against=None):
    """The two-phase warp pair at the largest bucket on one batch of ADA
    draws at p = 1 (the kernels-line entries, without launches), as
    time_warp times the interleaved pair: device time of CUDA-graph replays
    in turns, and eagerly. #8 in turns with the interleaved gather (#6) on
    the same draws and grid_sample; #9 in turns with grid_sample's backward
    as one call; with `against` (against_warp), that checkout's #8 and #9
    too, #8 held to this one's bits. The
    library calls read and write the interleaved buffer on a grid whose rows
    are the four quarter grids one after another (the interleave is built
    once and not timed)."""
    import torch.nn.functional as F

    from diagan_tpu_torch.ops import (
        affine_gather,
        affine_gather2_plain,
        affine_gather_2phase,
        affine_scatter2,
        affine_scatter2_plain,
    )
    from diagan_tpu_torch.ops.ada_phase import PARITIES
    from diagan_tpu_torch.ops.warp import _taps as warp_taps

    win = ada_win()
    h2, P = win // 2, ada_pads()[-1]
    s2 = ada_s2(P)
    coef = ada_coef(P, SEED + 1).to(dev)
    v0, v1 = (torch.randn((16, 3, s2 // 2, s2), generator=rng, device=dev) for _ in range(2))
    gq = torch.randn((4, 16, 3, h2, h2), generator=rng, device=dev)
    index, _ = warp_taps(coef, win, s2)
    touched = sum(torch.unique(torch.stack([i[k] for i in index])).numel() for k in range(16))
    del index
    x2 = torch.stack([v0, v1], 3).reshape(16, 3, s2, s2)
    idx = torch.arange(h2, dtype=torch.float32, device=dev)
    c = coef[:, :, None, None]
    quarters = []
    for a, b in PARITIES:
        ii, jj = 2 * idx[:, None] + a, 2 * idx[None, :] + b
        qy, qx = c[:, 0] * ii + c[:, 1] * jj + c[:, 2], c[:, 3] * ii + c[:, 4] * jj + c[:, 5]
        quarters.append(torch.stack([2 * qx / (s2 - 1) - 1, 2 * qy / (s2 - 1) - 1], -1))
    grid = torch.cat(quarters, 1)  # (16, 4 * h2, h2, 2)
    g_lib = gq.permute(1, 2, 0, 3, 4).reshape(16, 3, 4 * h2, h2)  # the cotangent on that grid

    def lib_gather():
        return F.grid_sample(x2, grid, mode="bilinear", padding_mode="border", align_corners=True)

    def lib_scatter():  # grid_sample's backward as one call: bilinear, border, x2's grad only
        return torch.ops.aten.grid_sampler_2d_backward(g_lib, x2, grid, 0, 1, True,
                                                       [True, False])[0]

    out = torch.stack(affine_gather_2phase(v0, v1, coef, win, s2))
    check(max_err(lib_gather().reshape(16, 3, 4, h2, h2).permute(2, 0, 1, 3, 4), out)
          <= 1e-3 * x2.abs().max().item(), "grid_sample yardstick disagrees with the two-phase "
                                           "gather")
    dv = affine_scatter2(gq, coef, s2)
    dx2 = torch.stack(dv, 3).reshape(16, 3, s2, s2)
    check(max_err(lib_scatter(), dx2) <= 1e-3 * dx2.abs().max().item(),
          "grid_sample backward disagrees with the two-phase adjoint")
    gathers = {"affine_warp2_gather": lambda: affine_gather_2phase(v0, v1, coef, win, s2),
               "interleaved gather (#6)": lambda: affine_gather(x2, coef, win),
               "grid_sample": lib_gather}
    scatters = {"affine_warp2_scatter": lambda: affine_scatter2(gq, coef, s2),
                "grid_sample backward": lib_scatter}
    if against:
        root, a_gather2, a_scatter2 = against["root"], against["gather2"], against["scatter2"]
        check(torch.equal(a_gather2(v0, v1, coef, win), out), f"{root}: two-phase gather differs")
        print(f"{root}'s two-phase gather on the timed draws ({warp_paths(coef, win, s2)}): the "
              f"same bits")
        gathers = {f"{root} gather2": lambda: a_gather2(v0, v1, coef, win), **gathers}
        diffs = [(a - b).abs() for a, b in zip(a_scatter2(gq, coef, s2), dv)]
        check(all(bool((d <= 2e-5 + 1e-4 * b.abs()).all()) for d, b in zip(diffs, dv)),
              f"{root}: two-phase adjoint differs")
        print(f"{root}'s two-phase adjoint on the timed draws: max abs difference "
              f"{max(d.max().item() for d in diffs):.3e}")
        del diffs
        scatters = {f"{root} scatter2": lambda: a_scatter2(gq, coef, s2), **scatters}
    del out, dv, dx2
    out_bytes, coef_bytes = gq.numel() * 4, coef.numel() * 4
    pix_ops = 16 * win * win * 12  # coordinates and weights, once per pixel
    shape = f"2 x {tuple(v0.shape)} -> 4 x {tuple(gq.shape[1:])} fp32, ADA draws at p=1"
    kernels = [
        entry_in_turns(gathers, "affine_warp2_gather",
                       lambda: affine_gather2_plain(v0, v1, coef, win),
                       bound(touched * 3 * 4 + out_bytes + coef_bytes, pix_ops + gq.numel() * 9),
                       smi, replaces="diagan_tpu/ops/ada_phase.py:213",
                       max_abs_err=errs["gather2"],
                       shape=f"{shape} ({touched} source pixels touched); library: grid_sample "
                             f"on the interleaved buffer"),
        entry_in_turns(scatters, "affine_warp2_scatter",
                       lambda: affine_scatter2_plain(gq, coef, s2),
                       bound(out_bytes + 2 * v0.numel() * 4 + coef_bytes,
                             pix_ops + gq.numel() * 8),
                       smi, replaces="diagan_tpu/ops/ada_phase.py:327",
                       max_abs_err=errs["scatter2"],
                       shape=f"4 x {tuple(gq.shape[1:])} -> 2 x {tuple(v0.shape)} fp32, ADA "
                             f"draws at p=1; library: grid_sampler_2d_backward onto the "
                             f"interleaved buffer"),
    ]
    del v0, v1, gq, x2, grid, g_lib
    return kernels


def time_polyphase(dev, rng, smi):
    """One augment call, polyphase against interleaved at the same pad."""
    from diagan_tpu_torch.models import ada

    P = ada_pads()[-1]
    # one augment call (the resample of a batch of 16), both forms at P
    G = ada.sample_affine_matrices(16, 0.3, SIZE, SIZE, torch.Generator().manual_seed(SEED + 4))
    x = torch.randn((16, SIZE, SIZE, 3), generator=rng, device=dev).tanh().requires_grad_(True)
    gout = torch.randn(x.shape, generator=rng, device=dev)
    ms = {}
    for poly in (True, False, False, True):  # in turns
        fwd = cuda_ms(lambda: ada.apply_affine(x.detach(), G, polyphase=poly))
        both = cuda_ms(lambda: torch.autograd.grad(ada.apply_affine(x, G, polyphase=poly), x, gout))
        ms.setdefault(poly, []).append((fwd, both))
    for poly, name in ((True, "polyphase"), (False, "interleaved")):
        (f1, b1), (f2, b2) = ms[poly]
        print(f"ADA resample, {name}, batch 16 at {SIZE} px, P={P} (ADA draws at p=0.3): forward "
              f"{f1:.4f} / {f2:.4f} ms, forward + backward {b1:.4f} / {b2:.4f} ms (two turns) "
              f"[{smi}]")
    del x, gout


def time_training(tr, smi):
    """ms per training step (host clock around synchronised steps) for the
    three kinds of step; the plain step in the resample's three settings;
    then a profile of one ADA-live plain step in each form."""
    def step_ms(step, reps=2):
        tr.train_step(step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            tr.train_step(step)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    plain, path, both = step_ms(1), step_ms(4), step_ms(16)
    print(f"training StyleGAN2-{SIZE} batch 16 fp32, ADA p={tr.ada_aug_p}: plain step "
          f"{plain:.2f} ms, path-regularisation step {path:.2f} ms, R1 + path step "
          f"{both:.2f} ms (R1 about {both - path:.2f} ms); at the default cadence "
          f"(R1 every 16, path every 4) {(12 * plain + 3 * path + both) / 16:.2f} ms/step "
          f"[{smi}]")
    tags = (*FIR_TAGS, "flr_fwd", "flr_bwd", "flr_db", "gather_kernel", "scatter_kernel",
            "scatter_clamped_kernel", "gather2_kernel", "scatter2_kernel", "scatter2_clamped_kernel",
            "Memset")
    profile(lambda: tr.train_step(1), f"one ADA-live plain training step (batch 16, {SIZE} px)",
            smi, tags)

    # the plain step with the resample in three settings, in turns
    import contextlib

    from diagan_tpu_torch.ops import _build

    buckets = tr.ada_pad_buckets
    settings = {"interleaved, pad buckets": (contextlib.nullcontext, buckets),
                "interleaved, static P": (contextlib.nullcontext, None),
                "polyphase (static P)": (polyphase_env, buckets)}
    ms = {}
    for name in [*settings, *reversed(settings)]:
        env, tr.ada_pad_buckets = settings[name]
        _build.reset_launches()
        with env():
            ms.setdefault(name, []).append(step_ms(1, reps=2))
        ran, idle = (WARP2, WARP) if env is polyphase_env else (WARP, WARP2)
        check(all(_build.LAUNCHES[k] > 0 for k in ran) and
              all(_build.LAUNCHES[k] == 0 for k in idle), f"{name} launches {_build.LAUNCHES}")
    tr.ada_pad_buckets = buckets
    for name, (t1, t2) in ms.items():
        print(f"plain step, ADA p={tr.ada_aug_p}, {name}: {t1:.2f} / {t2:.2f} ms (two turns), "
              f"mean {(t1 + t2) / 2:.2f} ms [{smi}]")
    with polyphase_env():
        profile(lambda: tr.train_step(1), f"one polyphase ADA-live plain training step "
                f"(batch 16, {SIZE} px)", smi, tags)


SNGAN_N, SNGAN_BS, SNGAN_NDIS = 50000, 64, 5  # CIFAR-10's size; the reference's batch, n_dis


def write_cifar10(root, images):
    """uint8 (N, 32, 32, 3) images as root/cifar-10-batches-py/data_batch_{1..5},
    in CIFAR-10's python pickle format (what data/sources.py:load_cifar10 reads)."""
    import pickle

    base = root / "cifar-10-batches-py"
    base.mkdir(parents=True)
    for b, idx in enumerate(np.array_split(np.arange(len(images)), 5)):
        rows = images[idx].transpose(0, 3, 1, 2).reshape(len(idx), -1)
        with open(base / f"data_batch_{b + 1}", "wb") as f:
            pickle.dump({b"data": rows, b"labels": [0] * len(idx)}, f)
    return root


def no_kernel_launched(path):
    """The SNGAN path has no port kernel: every launch count stays 0."""
    from diagan_tpu_torch.ops import _build

    launched = {k: v for counts in (_build.LAUNCHES, _build.FIR_INSTANCES)
                for k, v in counts.items() if v}
    check(not launched, f"{path} launched port kernels {launched}")


def steps_per_s(tr, start, dev, n=10, fused=None):
    """Fused steps per second of a LogTrainer (or of `fused`, a fused step
    over its nets) from global step `start` on: one step to warm up, then n
    synchronised steps (host clock)."""
    from diagan_tpu_torch.train.steps import step_draws

    fused = fused or tr.fused_step
    fused(start, step_draws(SEED, start, dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(start + 1, start + 1 + n):
        fused(s, step_draws(SEED, s, dev))
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def finite_metrics(tr, keys):
    """The trainer's last metrics, checked finite and holding `keys`, as text."""
    m = {k: float(v) for k, v in tr.metrics.items()}
    check(all(math.isfinite(v) for v in m.values()), f"non-finite metrics {m}")
    check(set(keys) <= set(m), f"metrics {sorted(m)}")
    return "; ".join(f"{k} {v:.4f}" for k, v in m.items())


def sngan_path(dev, smi, work):
    """The SNGAN-32 Dia-GAN path at full width (ngf 256, ndf 128), batch 64,
    n_dis 5, hinge, fp32, through its CLIs on 50,000 synthetic CIFAR-format
    images: phase 1 for 30 steps with logit sweeps at 10, 20 and 30, phase 2
    for 10 steps from that checkpoint with ldr_conf_1.0_ratio_50 and the twin
    DRS discriminator, then load_eval_models and DRS at batch 256 from the
    phase-2 checkpoint. No port kernel may launch. Then steps/s of each
    phase, ms per 50k sweep, DRS accepted/s, peak memory and a profile of one
    phase-1 step."""
    import pickle

    from diagan_tpu_torch.cli import train_mimicry_phase1, train_mimicry_phase2
    from diagan_tpu_torch.eval.drs import DRS
    from diagan_tpu_torch.eval.evaluate import load_eval_models, make_disc_fn, make_gen_fn
    from diagan_tpu_torch.models.registry import get_gan_model
    from diagan_tpu_torch.ops import _build
    from diagan_tpu_torch.train.steps import step_draws

    t0 = time.perf_counter()
    data = write_cifar10(work / "cifar10", rolled_copies(SNGAN_N, 32, SNGAN_N // 5, seed=11))
    print(f"dataset: {SNGAN_N} synthetic 32 px images ({SNGAN_N // 5} and rolled copies) in "
          f"CIFAR-10's format in {time.perf_counter() - t0:.2f} s")
    common = ["-r", str(data), "--work_dir", str(work), "--device", dev.type,
              "--batch_size", str(SNGAN_BS), "--n_dis", str(SNGAN_NDIS), "--seed", str(SEED)]

    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # what earlier phases still hold
    _build.reset_launches()
    t0 = time.perf_counter()
    tr1 = train_mimicry_phase1.main(common + [
        "--exp_name", "p1", "--no_schedule_override", "--num_steps", "30",
        "--logit_save_steps", "10", "--save_logit_after", "10", "--stop_save_logit_after", "30"])
    torch.cuda.synchronize()
    t_p1 = time.perf_counter() - t0
    no_kernel_launched("train_mimicry_phase1")
    print(f"train_mimicry_phase1 (30 steps, 3 sweeps of {SNGAN_N}): {t_p1:.2f} s, metrics "
          f"{finite_metrics(tr1, ('errD', 'errG', 'D(x)', 'D(G(z))'))}; no port kernel launched")
    with open(work / "p1" / "logits_netD_eval.pkl", "rb") as f:
        logits = pickle.load(f)
    check(list(logits) == [10, 20, 30] and all(type(k) is int for k in logits),
          f"logit steps {list(logits)}")
    check(all(v.dtype == np.float64 and v.shape == (SNGAN_N,) and np.isfinite(v).all()
              for v in logits.values()), "logits dtype, shape or values")
    for net in ("netG", "netD"):
        check((work / "p1" / "checkpoints" / net / f"{net}_30_steps.pth").is_file(),
              f"phase 1 wrote no {net} checkpoint")

    _build.reset_launches()
    t0 = time.perf_counter()
    tr2 = train_mimicry_phase2.main(common + [
        "--exp_name", "p2", "--baseline_exp_name", "p1", "--p1_step", "30", "--num_steps", "40",
        "--resample_score", "ldr_conf_1.0_ratio_50"])
    torch.cuda.synchronize()
    t_p2 = time.perf_counter() - t0
    no_kernel_launched("train_mimicry_phase2")
    check(tr2.global_step == 40 and tr2.d_drs.count == tr2.d.count == 40 * SNGAN_NDIS,
          f"phase 2 ended at step {tr2.global_step}, D updates {tr2.d.count}")
    for net in ("netG", "netD", "netD_drs"):
        check((work / "p2" / "checkpoints" / net / f"{net}_40_steps.pth").is_file(),
              f"phase 2 wrote no {net} checkpoint")
    print(f"train_mimicry_phase2 (10 steps, ldr_conf_1.0_ratio_50, twin DRS D): {t_p2:.2f} s, "
          f"metrics {finite_metrics(tr2, ('errD', 'errG', 'errD_drs'))}; no port kernel launched")
    peak = torch.cuda.max_memory_allocated()

    _build.reset_launches()
    gen, disc = load_eval_models(get_gan_model("cifar10", drs=True, device=dev), work / "p2", 40,
                                 use_drs=True)
    t0 = time.perf_counter()
    drs = DRS(make_gen_fn(gen), make_disc_fn(disc), 128,
              generator=torch.Generator(dev).manual_seed(SEED + 3), batch_size=256, device=dev)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    accepted = drs.generate_images(4096)
    t_drs = time.perf_counter() - t0
    no_kernel_launched("DRS (SNGAN)")
    check(accepted.shape == (4096, 32, 32, 3) and np.isfinite(accepted).all(), "SNGAN DRS output")
    acc = drs.accepted / drs.proposed
    check(0.0 < acc < 1.0, f"SNGAN DRS acceptance {acc}")
    print(f"SNGAN DRS batch 256: warm-up 50 batches in {t_warm:.2f} s; 4096 accepted of "
          f"{drs.proposed} proposed (acceptance {acc:.4f}) in {t_drs:.2f} s = "
          f"{4096 / t_drs:.2f} accepted/s; no port kernel launched [{smi}]")

    p1_sps, p2_sps = steps_per_s(tr1, 30, dev, 5), steps_per_s(tr2, 40, dev, 5)
    sweep = [0.0, 0.0]
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr1.recorder.sweep(tr1.d.module, tr1.source)
        torch.cuda.synchronize()
        sweep[i] = (time.perf_counter() - t0) * 1e3
    print(f"SNGAN-32 batch {SNGAN_BS} n_dis {SNGAN_NDIS} fp32: phase 1 {p1_sps:.2f} steps/s, "
          f"phase 2 (with the twin D) {p2_sps:.2f} steps/s (host clock, 5 synchronised steps); "
          f"logit sweep of {SNGAN_N} at batch 256: {sweep[0]:.2f} / {sweep[1]:.2f} ms; peak "
          f"device memory of the training phases {(peak - held) / 2**30:.2f} GiB above the "
          f"{held / 2**30:.2f} GiB that earlier phases still held [{smi}]")
    profile(lambda: tr1.fused_step(41, step_draws(SEED, 41, dev)),
            f"one SNGAN-32 phase-1 step (batch {SNGAN_BS}, n_dis {SNGAN_NDIS})", smi, ())
    del tr1, tr2, drs, gen, disc


def sngan_step_card_vs_cpu(dev, smi, size=32):
    """One fused SNGAN-{size} step with the twin D (phase 2), card against
    CPU, from the same weights and the same injected draws, at width 64 (32
    px) or 128 (64 px), batch 16, n_dis 2: every Adam update's gradients and
    the metrics within 1e-3 x max(1, max|.|). At 64 px with lr 0: an Adam
    step moves a weight by ~lr whatever its gradient's size, so a gradient
    that is zero up to round-off moves it differently on each device, and
    the D update before the metrics' D step shifted D(x) and D(G(z)) by 2e-3
    (NVIDIA H100 80GB HBM3, 700 W); with lr 0 every update's gradients and
    every metric come from the same weights on both devices."""
    import copy

    from diagan_tpu_torch.data.arrays import ArrayDataset
    from diagan_tpu_torch.data.pipeline import DeviceDataSource
    from diagan_tpu_torch.data.synthetic import synthetic_natural
    from diagan_tpu_torch.models.registry import OptSpec
    from diagan_tpu_torch.models import sngan
    from diagan_tpu_torch.train.state import NetState
    from diagan_tpu_torch.train.steps import StepConfig, make_fused_step

    bs, n_dis, width, n = 16, 2, 64 if size == 32 else 128, 64
    lr = 2e-4 if size == 32 else 0.0
    gen, disc = ((sngan.SNGANGenerator32, sngan.SNGANDiscriminator32) if size == 32
                 else (sngan.SNGANGenerator64, sngan.SNGANDiscriminator64))
    torch.manual_seed(SEED)
    nets0 = [gen(ngf=width, device="cpu"), disc(ndf=width, device="cpu"),
             disc(ndf=width, device="cpu")]
    ds = ArrayDataset.from_images(synthetic_natural(n, size, seed=13)[0])
    rng = np.random.default_rng(SEED)
    draws = {k: [torch.from_numpy(rng.integers(0, n, bs)) for _ in range(n_dis)]
             for k in ("real", "drs")}
    draws.update({k: [torch.from_numpy(rng.standard_normal((bs, 128)).astype(np.float32))
                      for _ in range(n_dis)] for k in ("z", "drs_z", "g_z")})

    class Draws:
        def __init__(self, d):
            self.d = d

        def indices(self, kind, i, source, n):
            return draws[kind][i].to(self.d)

        def normal(self, kind, i, n, nz, device):
            return draws[kind][i].to(device)

    cfg = StepConfig(n_dis=n_dis, batch_size=bs, nz=128, loss_type="hinge", drs_loss_type="ns",
                     model="sngan", gold=False, gold_step=0, topk=False, epoch_steps=n // bs,
                     use_drs=True)
    out = []
    for d in (torch.device("cpu"), dev):
        spec, grads = OptSpec(lr, (0.0, 0.9)), {}
        nets = [NetState(copy.deepcopy(m).to(d), spec, 100, "linear", ups)
                for m, ups in zip(nets0, (1, n_dis, n_dis))]
        for name, net in zip(("G", "D", "D_drs"), nets):
            net.optim.register_step_pre_hook(
                lambda opt, args, kwargs, name=name, net=net: grads.setdefault(name, []).append(
                    [p.grad.detach().cpu().clone() for p in net.module.parameters()]))
        source = DeviceDataSource(ds, weights=np.linspace(0.1, 1.0, n), device=d)
        fused = make_fused_step(*nets, cfg, source, DeviceDataSource(ds, device=d))
        metrics = {k: float(v) for k, v in fused(5, Draws(d)).items()}
        out.append((metrics, grads))
    (m_cpu, g_cpu), (m_card, g_card) = out
    m_err = max(abs(m_card[k] - m_cpu[k]) / max(1.0, abs(m_cpu[k])) for k in m_cpu)
    check(m_cpu.keys() == m_card.keys() and m_err <= 1e-3, f"metrics {m_cpu} vs {m_card}")
    worst = {}
    for name, updates in g_cpu.items():
        check(len(updates) == len(g_card[name]), f"{name}: update counts differ")
        for want_all, got_all in zip(updates, g_card[name]):
            for want, got in zip(want_all, got_all):
                scale = max(1.0, want.abs().max().item())
                err = max_err(got, want)
                check(err <= 1e-3 * scale, f"{name} grad err {err} > 1e-3 x {scale}")
                worst[name] = max(worst.get(name, 0.0), err / scale)
    print(f"card vs CPU, one SNGAN-{size} phase-2 step (width {width}, batch {bs}, n_dis {n_dis}, "
          f"lr {lr}, "
          f"injected draws, fp32, TF32 off): losses rel err {m_err:.3e}; gradients max abs err "
          f"/ max(1, max|g|) by net {({k: f'{v:.3e}' for k, v in worst.items()})} (tol 1e-3) "
          f"[{smi}]")


EVAL_STEP, EVAL_P1_STEP, EVAL_SCORE = 40, 30, "ldr_conf_1.0_ratio_50"  # phase 8's runs
# phase 9b's sample counts: the eval CLIs' are at most EVAL_N (a depth cut of
# the CLIs' FID and IS counts of 50,000 and PR's 10,000, to keep the script
# inside its limit)
EVAL_N = 2000
EVAL_SG2_WARMUP = 10  # 9c's DRS warm-up batches of 32 (DRS's default 50, a depth cut)
# the JSONs of phase 9b: cli.eval_gan_drs's counts (FID, IS, PR), KID at
# EVAL_N, and cli.eval_gan_with_index's FID of the 100 highest- and
# lowest-scored reals against EVAL_N fakes
_K = f"{EVAL_N // 1000}k"
EVAL_JSON = (f"fid_{_K}_{_K}.json", f"inception_score_{_K}.json", f"pr_{_K}_{_K}.json",
             f"kid_{_K}_{_K}.json", f"fid_high_{EVAL_SCORE}_0k_{_K}.json",
             f"fid_low_{EVAL_SCORE}_0k_{_K}.json")


def capped_counts(evaluate):
    """evaluate_checkpoint with its sample counts cut to at most EVAL_N."""
    def run(metric, *args, num_real_samples=None, num_fake_samples=None, **kwargs):
        counts = {k: min(n, EVAL_N) for k, n in (("num_real_samples", num_real_samples),
                                                  ("num_fake_samples", num_fake_samples))
                  if n is not None}
        return evaluate(metric, *args, **counts, **kwargs)
    return run


def inception_card_vs_cpu(dev, smi):
    """9a: the FID InceptionV3 with random weights made from a seed on the
    CPU and copied to the card, 4 uint8 32 px images resized to 299: pool3
    and logits card against CPU within 1e-3 x max(1, max|out|), TF32 off."""
    import copy

    from diagan_tpu_torch.eval.inception import InceptionV3, inception_input, random_init_

    cpu = random_init_(InceptionV3(device="cpu"), seed=SEED).eval()
    card = copy.deepcopy(cpu).to(dev)
    x = np.random.default_rng(SEED).integers(0, 256, (4, 32, 32, 3)).astype(np.uint8)
    with torch.no_grad():
        want = cpu(inception_input(x, "cpu"))
        got = card(inception_input(x, dev))
    torch.cuda.synchronize()
    errs = []
    for what, g, w in zip(("pool3", "logits"), got, want):
        scale = max(1.0, w.abs().max().item())
        err = max_err(g.cpu(), w)
        check(err <= 1e-3 * scale, f"Inception {what} card vs CPU err {err} > 1e-3 x {scale}")
        errs.append(f"{what} {err:.3e} (max|out| {w.abs().max().item():.3e})")
    print(f"card vs CPU, FID InceptionV3 (random weights, seed {SEED}), 4 images 32 -> 299 px, "
          f"fp32, TF32 off: max abs err {'; '.join(errs)}; tol 1e-3 x max(1, max|out|) [{smi}]")


class PartTimer:
    """Wall seconds of evaluate_checkpoint's parts, by wrapping the functions
    that do them: the real features (InceptionFeaturizer.features), all
    featurisation (features_and_logits, real included), fake generation (the
    DRS and plain samplers) and the Frechet distance (scipy's sqrtm; its
    calls are counted, two in one distance being the eps-jitter retry)."""

    def __init__(self):
        from scipy import linalg as scipy_linalg

        from diagan_tpu_torch.eval import evaluate, inception, metrics
        from diagan_tpu_torch.eval.drs import DRS

        self.secs = {}
        self.calls = {}
        self._patches = [
            self._wrap(inception.InceptionFeaturizer, "features", "real features"),
            self._wrap(inception.InceptionFeaturizer, "features_and_logits", "featurisation"),
            self._wrap(DRS, "generate_images", "fake generation"),
            self._wrap(evaluate.Sampler, "generate_images", "fake generation"),
            self._wrap(metrics, "frechet_distance", "sqrtm"),
            self._wrap(scipy_linalg, "sqrtm", "scipy sqrtm"),
        ]

    def _wrap(self, owner, attr, label):
        orig = getattr(owner, attr)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = orig(*args, **kwargs)
            self.secs[label] = self.secs.get(label, 0.0) + time.perf_counter() - t0
            self.calls.setdefault(label, []).append(time.perf_counter() - t0)
            return out
        return mock.patch.object(owner, attr, timed)

    def __enter__(self):
        for p in self._patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self._patches:
            p.stop()

    def report(self, what, wall, smi):
        s = dict(self.secs)
        # features() runs through features_and_logits: the fakes' share is the rest
        s["fake featurisation"] = s.pop("featurisation", 0.0) - s.get("real features", 0.0)
        s.pop("scipy sqrtm", None)
        parts = ", ".join(f"{k} {v:.2f} s" for k, v in s.items())
        # two scipy sqrtm calls in one Frechet distance: the eps-jitter retry
        print(f"{what}: {wall:.2f} s wall; {parts}; Frechet distances "
              f"{[round(t, 2) for t in self.calls.get('sqrtm', [])]} s with "
              f"{len(self.calls.get('scipy sqrtm', []))} scipy sqrtm calls [{smi}]")
        return s


def eval_path(dev, smi, work):
    """9b and 9c. 9b: SNGAN-32 evaluation on phase 8's runs, the CLIs'
    counts cut to EVAL_N: cli.eval_gan_drs on the phase-2 run (step 40; FID,
    IS and PR at EVAL_N, DRS at batch 256) and its 50k synthetic
    CIFAR-format set, KID at EVAL_N reusing the cached DRS fakes, and
    cli.eval_gan_with_index against the phase-1 logits (--p1_step 30); no
    port kernel may launch.
    9c: evaluate_checkpoint("fid") of phase 6's StyleGAN2-256 phase-2
    checkpoint with DRS (EVAL_SG2_WARMUP warm-up batches) against its 512
    training images (512 real, 256 fake samples of 2048-d features: a
    singular covariance, the eps-jitter sqrtm),
    which launches kernel A and the fused bias-LeakyReLU. Returns 9c's
    (launches, kernel A launches by instance)."""
    from diagan_tpu_torch.cli import eval_gan, eval_gan_drs, eval_gan_with_index
    from diagan_tpu_torch.data.predefined import get_predefined_dataset
    from diagan_tpu_torch.eval.drs import DRS
    from diagan_tpu_torch.eval.evaluate import evaluate_checkpoint
    from diagan_tpu_torch.eval.inception import InceptionFeaturizer
    from diagan_tpu_torch.models.registry import get_gan_model
    from diagan_tpu_torch.ops import _build

    sngan, data = work / "sngan", work / "sngan" / "cifar10"
    common = ["-d", "cifar10", "-r", str(data), "--work_dir", str(sngan), "--exp_name", "p2",
              "--netG_ckpt_step", str(EVAL_STEP), "--device", dev.type]

    def run(what, fn):
        _build.reset_launches()
        t0 = time.perf_counter()
        with PartTimer() as timer, \
                mock.patch.object(eval_gan, "evaluate_checkpoint",
                                  capped_counts(eval_gan.evaluate_checkpoint)), \
                mock.patch.object(eval_gan_with_index, "evaluate_checkpoint",
                                  capped_counts(eval_gan_with_index.evaluate_checkpoint)):
            out = fn()
        wall = time.perf_counter() - t0
        no_kernel_launched(what)
        timer.report(what, wall, smi)
        return out

    n = f"{EVAL_N // 1000}k"
    run(f"cli.eval_gan_drs (FID {n}/{n}, IS {n}, PR {n}/{n}, DRS batch 256)",
        lambda: eval_gan_drs.main(common))
    real = get_predefined_dataset("cifar10", str(data)).images
    run(f"evaluate_checkpoint kid {n}/{n} (DRS, the cached fakes)", lambda: evaluate_checkpoint(
        "kid", get_gan_model("cifar10", drs=True, device=dev), sngan / "p2", EVAL_STEP,
        real_images=real, num_real_samples=EVAL_N, num_fake_samples=EVAL_N, use_drs=True,
        featurizer=InceptionFeaturizer(batch_size=128, device=dev), device=dev))
    run(f"cli.eval_gan_with_index (FID of 100 high / 100 low reals against {n} fakes)",
        lambda: eval_gan_with_index.main(common + [
            "--baseline_exp_name", "p1", "--p1_step", str(EVAL_P1_STEP),
            "--resample_score", EVAL_SCORE]))
    out = sngan / "p2" / "evaluate" / f"step-{EVAL_STEP}"
    found = sorted(p.name for p in out.glob("*.json"))
    check(found == sorted(EVAL_JSON), f"evaluation JSONs {found}")
    for name in EVAL_JSON:
        res = json.loads((out / name).read_text())
        scores = [v for s in res["scores"].values()
                  for v in (s.values() if isinstance(s, dict) else [s])]
        check(list(res["scores"]) == ["0"] and all(math.isfinite(v) for v in scores),
              f"{name} scores {res['scores']}")
        print(f"{name}: scores {res['scores']}, inception_weights {res['inception_weights']}, "
              f"use_drs {res['use_drs']}")
    print("SNGAN-32 evaluation: every score finite; no port kernel launched")

    # 9c. StyleGAN2-256 with DRS, through the port kernels
    train = work / "train"
    real = np.load(train / "data" / f"ffhq_{SIZE}.npy")
    _build.reset_launches()
    t0 = time.perf_counter()
    with PartTimer() as timer, mock.patch.object(DRS, "__init__", functools.partialmethod(
            DRS.__init__, warmup_batches=EVAL_SG2_WARMUP)):
        res = evaluate_checkpoint(
            "fid", get_gan_model("ffhq", drs=True, device=dev), train / "p2", 12,
            real_images=real, num_real_samples=512, num_fake_samples=256, use_drs=True,
            batch_size=32, featurizer=InceptionFeaturizer(batch_size=128, device=dev), device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    fir = fir_launches("evaluate_checkpoint (StyleGAN2-256, DRS)")
    check(all(launches[k] > 0 for k in FORWARD_KERNELS) and fir["fir4x4"] > 0
          and fir["fir4x4_up2"] > 0, f"StyleGAN2 evaluation launches {launches}, {fir}")
    check(math.isfinite(res["scores"]["0"]), f"StyleGAN2 FID {res['scores']}")
    timer.report("evaluate_checkpoint fid (StyleGAN2-256 phase-2 step 12, DRS batch 32, 512 "
                 "real / 256 fake)", wall, smi)
    print(f"StyleGAN2-256 FID (random Inception weights, {res['inception_weights']}): "
          f"{res['scores']['0']:.4f}; launches {launches}")
    return launches, fir


def time_inception(dev, smi):
    """9d: one Inception batch of 128 at 299 (32 px uint8 in, the resize
    included): ms and images/s by CUDA events, a profile, and the host's
    time to queue one batch; then the featurizer's own loop over 2560
    images from the host (host clock)."""
    from diagan_tpu_torch.eval.inception import InceptionFeaturizer

    feat = InceptionFeaturizer(batch_size=128, device=dev)
    x = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, (128, 32, 32, 3)).astype(np.uint8)).to(dev)
    ms = cuda_ms(lambda: feat._forward(x), iters=5, warmup=2)
    print(f"Inception batch 128 at 299 px fp32 (TF32 off), 32 px uint8 in: {ms:.2f} ms = "
          f"{128e3 / ms:.2f} images/s [{smi}]")
    profile(lambda: feat._forward(x), "one Inception batch (128 images, 299 px)", smi, ())
    enqueue = []
    for _ in range(5):  # the host's time to queue one batch, the card not waited for
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feat._forward(x)
        enqueue.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    print(f"Inception batch 128: the host queues it in {min(enqueue):.2f} ms (best of 5; "
          f"median {sorted(enqueue)[2]:.2f} ms), against {ms:.2f} ms per batch [{smi}]")
    host = x.cpu().numpy().repeat(20, axis=0)
    feat.features_and_logits(host[:256])
    t0 = time.perf_counter()
    feat.features_and_logits(host)
    dt = time.perf_counter() - t0
    print(f"features_and_logits of {len(host)} uint8 32 px images from the host (batches of "
          f"128, the copies in): {dt:.2f} s = {len(host) / dt:.2f} images/s [{smi}]")


CELEBA_N = 25000  # CelebA's 202,599 images, cut (a depth cut: sweeps and writes ~8x shorter)
CELEBA_CLF_N = 20000  # the attribute classifier's images (a depth cut)
CELEBA_ATTR, CELEBA_SCORE = "Bald", "ldr_conf_1.0_ratio_50"
# phase 1: 12 steps, sweeps at 5 and 10 (phase 2 scores the window before
# --p1_step 12); phase 2 to step 16; evaluation counts
CELEBA_P1, CELEBA_P2, CELEBA_SAMPLES = 12, 16, 1024


def write_celeba(root, n, n_base=2048, seed=21):
    """A procedural CelebA in its on-disk layout: celeba_64.npy of n images
    (n_base 1/f-noise images, each successive tile of them rolled sideways
    by one more pixel), written in chunks through open_memmap, and
    list_attr_celeba.txt (a count line, the 40 names, then a file name and
    40 values per image) with synthetic_celeba_attrs' attributes of the base
    images."""
    from diagan_tpu_torch.data.sources import CELEBA_ATTR_NAMES, synthetic_celeba_attrs
    from diagan_tpu_torch.data.synthetic import synthetic_natural

    root.mkdir(parents=True)
    base = synthetic_natural(n_base, 64, seed=seed)[0]
    rows = [" ".join(f"{int(a):2d}" for a in r) for r in synthetic_celeba_attrs(base, seed=seed)]
    out = np.lib.format.open_memmap(root / "celeba_64.npy", mode="w+", dtype=np.uint8,
                                    shape=(n, 64, 64, 3))
    for t, lo in enumerate(range(0, n, n_base)):
        hi = min(lo + n_base, n)
        out[lo:hi] = np.roll(base[: hi - lo], t, axis=2)
    out.flush()
    del out
    lines = [str(n), " ".join(CELEBA_ATTR_NAMES)]
    lines += [f"{i + 1:06d}.jpg {rows[i % n_base]}" for i in range(n)]
    (root / "list_attr_celeba.txt").write_text("\n".join(lines) + "\n")
    return root


def celeba_subset(src, root, n):
    """The first n images and attribute lines of a CelebA directory."""
    root.mkdir(parents=True)
    np.save(root / "celeba_64.npy", np.load(src / "celeba_64.npy", mmap_mode="r")[:n])
    lines = (src / "list_attr_celeba.txt").read_text().splitlines()
    (root / "list_attr_celeba.txt").write_text("\n".join([str(n)] + lines[1:n + 2]) + "\n")
    return root


def attr_classifier_card_vs_cpu(dev, smi):
    """AttrClassifier (num_attrs 2, 64 px, full width) with weights from a
    seed, batch 16: the eval forward's logits and features card against CPU
    in fp32 (TF32 off) within 1e-3 x max(1, max|.|); one train step's loss
    gradients (softmax CE, one fixed dropout mask) card against CPU in
    float64 within 1e-6 x max(1, max|g|), and each device's fp32 gradients
    against the float64 CPU ones within 1e-2 x max(1, max|g|), printed with
    the tensor furthest off, with the ReLUs and max pools free and with
    every ReLU side and pool pick the float64 CPU run's (ActSides), then on
    the card with the shared decisions and cuDNN off, or train-mode
    BatchNorm in plain tensor ops. 1e-3 does not hold in fp32 with the
    sides free: the card's fp32 gradients came 2.27e-3 off at conv5.weight
    with cuDNN and 2.4e-4 (as the CPU's) with cuDNN off, whatever the TF32
    and determinism settings (NVIDIA H100 80GB HBM3, 700 W)."""
    import copy

    import torch.nn.functional as F

    from diagan_tpu_torch.models.convnets import AttrClassifier

    torch.manual_seed(SEED)
    net = AttrClassifier(num_attrs=2, device="cpu")
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.integers(0, 256, (16, 64, 64, 3)).astype(np.uint8)).float() / 127.5 - 1
    y = torch.from_numpy(rng.integers(0, 2, 16))
    mask = torch.from_numpy(rng.random((16, 512)) < 0.5)

    def forward(d):
        with torch.no_grad():
            return [t.cpu() for t in copy.deepcopy(net).to(d).eval()(x.to(d))]

    def gradients(d, dtype):
        m = copy.deepcopy(net).to(d, dtype).train()
        loss = F.cross_entropy(m(x.to(d, dtype), mask.to(d))[0], y.to(d))
        grads = torch.autograd.grad(loss, list(m.parameters()))
        return {n: g.cpu().double() for (n, _), g in zip(m.named_parameters(), grads)}

    def worst(got, want):
        errs = {k: max_err(got[k], want[k]) / max(1.0, want[k].abs().max().item()) for k in want}
        k = max(errs, key=errs.get)
        return errs[k], k

    fwd_err = max(max_err(g, w) / max(1.0, w.abs().max().item())
                  for w, g in zip(forward(torch.device("cpu")), forward(dev)))
    check(fwd_err <= 1e-3, f"AttrClassifier forward err {fwd_err} > 1e-3 x max(1, max|out|)")
    sides = ActSides()
    with sides.record():
        ref = gradients(torch.device("cpu"), torch.float64)
    err64, at64 = worst(gradients(dev, torch.float64), ref)
    check(err64 <= 1e-6, f"AttrClassifier float64 gradients err {err64} at {at64} > 1e-6")
    def plain_batch_norm(x, mean, var, weight, bias, training, momentum, eps):
        """Train-mode batch norm in plain tensor ops (not cuDNN's kernel)."""
        if not training:
            return batch_norm(x, mean, var, weight, bias, training, momentum, eps)
        dims, shape = (0, *range(2, x.ndim)), (1, -1) + (1,) * (x.ndim - 2)
        var, mean = torch.var_mean(x, dim=dims, unbiased=False, keepdim=True)
        return (x - mean) * torch.rsqrt(var + eps) * weight.view(shape) + bias.view(shape)

    batch_norm = F.batch_norm
    free, shared = {}, {}
    for name, d in (("card", dev), ("CPU", torch.device("cpu"))):
        free[name] = worst(gradients(d, torch.float32), ref)
        with sides.apply():
            shared[name] = worst(gradients(d, torch.float32), ref)
        check(sides.in_step(), "activation sides out of step")
    # which of the card's kernels the shared-sides error comes from
    probes = {}
    with sides.apply(), torch.backends.cudnn.flags(enabled=False):
        probes["cuDNN off"] = worst(gradients(dev, torch.float32), ref)
    with sides.apply(), mock.patch.object(F, "batch_norm", plain_batch_norm):
        probes["plain train-mode BatchNorm, cuDNN convs"] = worst(gradients(dev, torch.float32),
                                                                  ref)
    check(max(e for errs in (free, shared) for e, _ in errs.values()) <= 1e-2,
          f"AttrClassifier fp32 gradients err: free {free}, the float64 run's ReLU sides and "
          f"pool picks {shared}; tol 1e-2")

    def fmt(errs):
        return ", ".join(f"{k} {e:.3e} at {at}" for k, (e, at) in errs.items())
    print(f"card vs CPU, AttrClassifier at 64 px, batch 16: eval forward fp32 (TF32 off) max abs "
          f"err / max(1, max|out|) {fwd_err:.3e} (tol 1e-3); one train step's gradients in "
          f"float64 {err64:.3e} at {at64} (tol 1e-6); in fp32 against the float64 CPU ones, "
          f"every ReLU side and max-pool pick the float64 run's: {fmt(shared)}; free: "
          f"{fmt(free)} (tol 1e-2); the card with the shared decisions and {fmt(probes)} "
          f"[{smi}]")


def timed(owner, attr, log):
    """Patch owner.attr to append (its positional arguments, synchronised
    seconds) to log on every call."""
    orig = getattr(owner, attr)

    def call(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*args, **kwargs)
        torch.cuda.synchronize()
        log.append((args, time.perf_counter() - t0))
        return out
    return mock.patch.object(owner, attr, call)


def celeba_path(dev, smi, work):
    """10. The CelebA-64 Dia-GAN path and its attribute study at full width
    (SNGAN-64 ngf 1024, ndf 1024, nz 128, batch 64, n_dis 5, hinge;
    AttrClassifier at 64 px) through the CLIs, on CELEBA_N procedural images
    in CelebA's layout: phase 1 for 12 steps with sweeps of the whole set at
    5 and 10, phase 2 to step 16 (ldr_conf_1.0_ratio_50, the twin DRS D),
    the disc-score means of Bald, the attribute classifier for 1 epoch on
    the first 20,000 images, count_attr with DRS at batch 256 on
    CELEBA_SAMPLES samples, and the DRS evaluation's partial recall and
    attribute-sliced FID at CELEBA_SAMPLES fakes and at most CELEBA_SAMPLES
    reals a subset. No port kernel may
    launch. Steps/s, sweep seconds, DRS accepted/s and acceptance,
    classifier images/s, each CLI's wall time and peak device memory."""
    from diagan_tpu_torch.cli import (
        count_attr_celeba,
        disc_score_celeba_with_attr,
        eval_gan_drs_celeba_with_attr,
        train_convnet_celeba,
        train_mimicry_phase1,
        train_mimicry_phase2,
    )
    from diagan_tpu_torch.eval.drs import DRS
    from diagan_tpu_torch.ops import _build
    import pickle

    from diagan_tpu_torch.train.logit_recorder import LogitRecorder

    t0 = time.perf_counter()
    data = write_celeba(work / "celeba", CELEBA_N)
    sub = celeba_subset(data, work / "celeba_clf", CELEBA_CLF_N)
    print(f"dataset: {CELEBA_N} procedural 64 px images in CelebA's layout (celeba_64.npy, "
          f"{CELEBA_N * 64 * 64 * 3 / 1e9:.2f} GB, and list_attr_celeba.txt), and the first "
          f"{CELEBA_CLF_N} apart for the classifier, in {time.perf_counter() - t0:.2f} s")
    common = ["--work_dir", str(work), "--device", dev.type, "--seed", str(SEED)]
    train = common + ["-d", "celeba", "-r", str(data), "--batch_size", "64", "--n_dis", "5"]
    walls = {}

    def drive(what, fn):
        _build.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[what] = time.perf_counter() - t0
        no_kernel_launched(what)
        return out

    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # what earlier phases still hold
    sweeps = []
    with timed(LogitRecorder, "sweep", sweeps):
        tr1 = drive("train_mimicry_phase1", lambda: train_mimicry_phase1.main(train + [
            "--exp_name", "p1", "--no_schedule_override", "--num_steps", str(CELEBA_P1),
            "--logit_save_steps", "5", "--save_logit_after", "5",
            "--stop_save_logit_after", "10"]))
    with open(work / "p1" / "logits_netD_eval.pkl", "rb") as f:
        logits = pickle.load(f)
    check(list(logits) == [5, 10] and all(v.dtype == np.float64 and v.shape == (CELEBA_N,)
                                           and np.isfinite(v).all() for v in logits.values()),
          f"phase 1 logits {list(logits)}")
    print(f"train_mimicry_phase1 -d celeba ({CELEBA_P1} steps, 2 sweeps of {CELEBA_N}): "
          f"{walls['train_mimicry_phase1']:.2f} s, metrics "
          f"{finite_metrics(tr1, ('errD', 'errG', 'D(x)', 'D(G(z))'))}; sweeps "
          f"{[round(t, 2) for _, t in sweeps]} s; no port kernel launched [{smi}]")

    tr2 = drive("train_mimicry_phase2", lambda: train_mimicry_phase2.main(train + [
        "--exp_name", "p2", "--baseline_exp_name", "p1", "--p1_step", str(CELEBA_P1),
        "--num_steps", str(CELEBA_P2), "--resample_score", CELEBA_SCORE]))
    check(tr2.global_step == CELEBA_P2 and tr2.d_drs.count == tr2.d.count == CELEBA_P2 * 5,
          f"phase 2 ended at step {tr2.global_step}, D updates {tr2.d.count}")
    for net in ("netG", "netD", "netD_drs"):
        check((work / "p2" / "checkpoints" / net / f"{net}_{CELEBA_P2}_steps.pth").is_file(),
              f"phase 2 wrote no {net} checkpoint")
    print(f"train_mimicry_phase2 -d celeba ({CELEBA_P2 - CELEBA_P1} steps, {CELEBA_SCORE}, twin "
          f"DRS D): {walls['train_mimicry_phase2']:.2f} s, metrics "
          f"{finite_metrics(tr2, ('errD', 'errG', 'errD_drs'))}; no port kernel launched")
    p1_sps = steps_per_s(tr1, CELEBA_P2 + 1, dev, 3)
    p2_sps = steps_per_s(tr2, CELEBA_P2 + 1, dev, 3)
    print(f"SNGAN-64 batch 64 n_dis 5 fp32: phase 1 {p1_sps:.3f} steps/s, phase 2 (with the twin "
          f"D) {p2_sps:.3f} steps/s (host clock, 3 synchronised steps); one logit sweep of "
          f"{CELEBA_N} at batch 256: {sweeps[0][1]:.2f} / {sweeps[1][1]:.2f} s [{smi}]")
    del tr1, tr2

    means = drive("disc_score_celeba_with_attr", lambda: disc_score_celeba_with_attr.main([
        "-r", str(data), "--work_dir", str(work), "--exp_name", "p1",
        "--p1_step", str(CELEBA_P1), "--resample_score", CELEBA_SCORE, "--attr", CELEBA_ATTR]))
    check(all(math.isfinite(v) and v > 0 for v in means.values()), f"disc-score means {means}")
    print(f"disc_score_celeba_with_attr ({CELEBA_ATTR}): {walls['disc_score_celeba_with_attr']:.2f}"
          f" s; mean weight with {means['attr']:.6f}, without {means['not_attr']:.6f}")

    fits, preds = [], []
    with timed(train_convnet_celeba, "train_classifier", fits), \
            timed(train_convnet_celeba, "predict_classifier", preds):
        _, hist, val_acc, test_acc = drive("train_convnet_celeba", lambda: train_convnet_celeba.main(
            common + ["-r", str(sub), "--num_epochs", "1", "--attr", CELEBA_ATTR]))
    clf = work / "attr_classifier"
    check((clf / f"{CELEBA_ATTR}.pth").is_file(), "no classifier file")
    csv_lines = (clf / f"{CELEBA_ATTR}_results.csv").read_text().splitlines()
    check(csv_lines[0] == "attr,train_acc,val_acc,test_acc" and len(csv_lines) == 2
          and all(math.isfinite(float(v)) for v in csv_lines[1].split(",")[1:]),
          f"classifier CSV {csv_lines}")
    n_fit = len(fits[0][0][1]) // 128 * 128
    n_pred = sum(len(args[1]) for args, _ in preds)
    print(f"train_convnet_celeba (AttrClassifier, 1 epoch, {n_fit} images at batch 128): "
          f"{walls['train_convnet_celeba']:.2f} s; train {n_fit / fits[0][1]:.2f} images/s, "
          f"predict {n_pred / sum(t for _, t in preds):.2f} images/s ({n_pred} images at "
          f"batch 256); train acc {hist[-1]['acc']:.4f}, val {val_acc:.4f}, test {test_acc:.4f} "
          f"[{smi}]")

    draws = []
    with timed(DRS, "generate_images", draws):
        counted = drive("count_attr_celeba", lambda: count_attr_celeba.main(common + [
            "--exp_name", "p2", "--netG_ckpt_step", str(CELEBA_P2), "--attr", CELEBA_ATTR,
            "--drs", "--num_samples", str(CELEBA_SAMPLES)]))
    saved = json.loads((work / "p2" / f"count_attr_{CELEBA_ATTR}_drs.json").read_text())
    check(saved == counted and saved["total"] == CELEBA_SAMPLES and 0 <= saved["fraction"] <= 1,
          f"count JSON {saved}")
    (drs, *_), t_drs = draws[0]
    acc = drs.accepted / drs.proposed
    check(0.0 < acc < 1.0, f"SNGAN-64 DRS acceptance {acc}")
    print(f"count_attr_celeba --drs ({CELEBA_SAMPLES} samples): {walls['count_attr_celeba']:.2f} s; "
          f"{saved}; SNGAN-64 DRS batch 256: {CELEBA_SAMPLES} accepted of {drs.proposed} proposed "
          f"(acceptance {acc:.4f}) in {t_drs:.2f} s = {CELEBA_SAMPLES / t_drs:.2f} accepted/s "
          f"[{smi}]")

    what = "eval_gan_drs_celeba_with_attr"
    with PartTimer() as timer:
        res = drive(what, lambda: eval_gan_drs_celeba_with_attr.main(common + [
            "-r", str(data), "--exp_name", "p2", "--netG_ckpt_step", str(CELEBA_P2),
            "--attr", CELEBA_ATTR, "--metric", "all", "--num_real_samples", str(CELEBA_SAMPLES),
            "--num_fake_samples", str(CELEBA_SAMPLES)]))
    feats = timer.calls["real features"]  # the fakes first, then the real subsets
    print(f"{what} --metric all ({CELEBA_SAMPLES} DRS fakes, at most {CELEBA_SAMPLES} reals a "
          f"subset): {walls[what]:.2f} s wall; fakes drawn {timer.secs['fake generation']:.2f} s, "
          f"featurised {feats[0]:.2f} s; reals featurised {sum(feats[1:]):.2f} s in "
          f"{len(feats) - 1} calls; Frechet distances "
          f"{[round(t, 2) for t in timer.calls['sqrtm']]} s; no port kernel launched [{smi}]")
    out = work / "p2" / "evaluate" / f"step-{CELEBA_P2}"
    pr = json.loads((out / f"partial_recall_drs_{CELEBA_ATTR}.json").read_text())
    fid = json.loads((out / f"fid_drs_{CELEBA_ATTR}.json").read_text())
    check(all(0.0 <= pr[k]["recall"] <= 1.0 for k in ("attr", "not_attr"))
          and all(math.isfinite(fid[k]) for k in ("attr", "not_attr"))
          and res["fid"] == fid, f"evaluation JSONs {pr} {fid}")
    stats = list((work / "p2" / "metrics" / "fid" / "statistics").glob("*.npz"))
    check([p.name for p in stats] == [f"fid_stats_sngan_celeba_{CELEBA_ATTR}_cap"
                                      f"{CELEBA_SAMPLES}_run_{SEED}.npz"], f"stats {stats}")
    print(f"partial recall {pr}; attribute-sliced FID {fid}")
    peak = torch.cuda.max_memory_allocated()
    print(f"CelebA phase wall s by CLI {({k: round(v, 2) for k, v in walls.items()})}; no port "
          f"kernel launched in any; peak device memory {(peak - held) / 2**30:.2f} GiB above the "
          f"{held / 2**30:.2f} GiB that earlier phases still held [{smi}]")

MNIST_N = 10000  # the scripts' --num_data
MNIST_P1, MNIST_P2, MNIST_PAC, TOY_STEPS = 300, 400, 100, 500  # steps (depth cuts)


def write_mnist_idx(root, n, seed=0):
    """n procedural digits (data/synthetic.py) as MNIST's train idx-ubyte
    files under root."""
    import struct

    from diagan_tpu_torch.data.synthetic import synthetic_mnist

    root.mkdir(parents=True, exist_ok=True)
    for name, arr in zip(("images-idx3", "labels-idx1"), synthetic_mnist(n, seed=seed)):
        arr = np.ascontiguousarray(arr, dtype=np.uint8)
        with open(root / f"train-{name}-ubyte", "wb") as f:
            f.write(struct.pack(">I", 0x0800 | arr.ndim))
            f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
            f.write(arr.tobytes())
    return root


def check_logits(path, steps, n):
    import pickle

    with open(path, "rb") as f:
        logits = pickle.load(f)
    check(list(logits) == steps and all(type(k) is int for k in logits)
          and all(v.dtype == np.float64 and v.shape == (n,) and np.isfinite(v).all()
                  for v in logits.values()), f"{path.name}: steps {list(logits)}")


def mnist_path(dev, smi, work):
    """11. The Colored-MNIST and MNIST-FMNIST Dia-GAN path and the
    25-Gaussians toy at full width (MNIST DCGAN: G nz 100, widths
    384/192/96/48; D widths 16-512; batch 64, n_dis 1; the toy's MLPs of 256,
    n_dis 5) through the CLIs: per family phase 1 for MNIST_P1 steps with
    train-mode sweeps of the 10,000 images every 100 steps, phase 2 to
    MNIST_P2 (colour: ldr_conf_1.0_ratio_50, the twin DRS D and DRS at batch
    250 with its red/green counts; fmnist: the same with --gold), the GOLD
    phase 2 to MNIST_P2; a PacGAN phase 1 (--num_pack 2, no logits); both
    bias probes for 1 epoch; train_mimicry_phase1 -d 25gaussian for 500
    steps with sweeps every 100. Colored-MNIST from 10,000 procedural digits
    written as MNIST idx files; MNIST-FMNIST (which needs FashionMNIST apart)
    from the procedural fallback of both. No port kernel may launch. Steps/s,
    ms per sweep, DRS accepted/s, the counts, probe images/s, peak memory and
    profiles of one DRS proposal batch and one DCGAN step."""
    from diagan_tpu_torch.cli import (
        train_color_mnist_feature,
        train_mimicry_color_mnist_phase1,
        train_mimicry_color_mnist_phase2,
        train_mimicry_color_mnist_phase2_gold,
        train_mimicry_mnist_fmnist_phase1,
        train_mimicry_mnist_fmnist_phase2,
        train_mimicry_mnist_fmnist_phase2_gold,
        train_mimicry_phase1,
        train_mnist_fmnist_feature,
    )
    from diagan_tpu_torch.eval.drs import DRS
    from diagan_tpu_torch.ops import _build
    from diagan_tpu_torch.train import classifier
    from diagan_tpu_torch.train.logit_recorder import LogitRecorder
    from diagan_tpu_torch.train.steps import step_draws

    work = work.resolve()  # the probes run in it (their roots are relative)
    t0 = time.perf_counter()
    colour = write_mnist_idx(work / "dataset" / "colour_mnist", MNIST_N)
    fmnist = work / "dataset" / "mnist_fmnist"  # the probes' roots are relative to the cwd
    print(f"dataset: {MNIST_N} procedural digits as MNIST idx files in "
          f"{time.perf_counter() - t0:.2f} s")
    exp = work / "exp_results"
    common = ["--device", dev.type, "--work_dir", str(exp), "--seed", str(SEED)]
    p1 = ["--num_steps", str(MNIST_P1), "--logit_save_steps", "100"]
    p2 = ["--p1_step", str(MNIST_P1), "--num_steps", str(MNIST_P2)]
    walls, sweeps, draws, fits = {}, [], [], []

    def drive(what, fn):
        _build.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[what] = time.perf_counter() - t0
        no_kernel_launched(what)
        return out

    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # what earlier phases still hold
    cwd = os.getcwd()
    os.chdir(work)
    try:
        with timed(LogitRecorder, "sweep", sweeps), timed(DRS, "generate_images", draws), \
                timed(classifier, "train_classifier", fits):
            c1 = drive("colour phase 1", lambda: train_mimicry_color_mnist_phase1.main(
                common + ["-r", str(colour)] + p1))
            c2 = drive("colour phase 2", lambda: train_mimicry_color_mnist_phase2.main(
                common + ["-r", str(colour), "--exp_name", "colour_p2",
                          "--resample_score", "ldr_conf_1.0_ratio_50"] + p2))
            c3 = drive("colour GOLD phase 2", lambda: train_mimicry_color_mnist_phase2_gold.main(
                common + ["-r", str(colour), "--exp_name", "colour_gold"] + p2))
            f1 = drive("fmnist phase 1", lambda: train_mimicry_mnist_fmnist_phase1.main(
                common + ["-r", str(fmnist), "--exp_name", "mnist_fmnist_baseline"] + p1))
            f2 = drive("fmnist phase 2 --gold", lambda: train_mimicry_mnist_fmnist_phase2.main(
                common + ["-r", str(fmnist), "--exp_name", "fmnist_p2", "--gold",
                          "--resample_score", "ldr_conf_1.0_ratio_50"] + p2))
            f3 = drive("fmnist GOLD phase 2", lambda: train_mimicry_mnist_fmnist_phase2_gold.main(
                common + ["-r", str(fmnist), "--exp_name", "fmnist_gold"] + p2))
            pac = drive("PacGAN phase 1", lambda: train_mimicry_color_mnist_phase1.main(
                common + ["-r", str(colour), "--exp_name", "colour_pacgan", "--num_pack", "2",
                          "--num_steps", str(MNIST_PAC)]))
            probe = ["--device", dev.type, "--epochs", "1", "--seed", str(SEED)]
            drive("colour probe", lambda: train_color_mnist_feature.main(probe))
            drive("fmnist probe", lambda: train_mnist_fmnist_feature.main(probe))
            toy = drive("25gaussian phase 1", lambda: train_mimicry_phase1.main(
                common + ["-d", "25gaussian", "--exp_name", "toy", "--num_steps", str(TOY_STEPS),
                          "--logit_save_steps", "100", "--save_logit_after", "100",
                          "--stop_save_logit_after", str(TOY_STEPS)]))
    finally:
        os.chdir(cwd)
    peak = torch.cuda.max_memory_allocated()

    steps = list(range(100, MNIST_P1 + 1, 100))
    for run in ("colour_mnist", "mnist_fmnist_baseline"):
        check_logits(exp / run / "logits_netD_train.pkl", steps, MNIST_N)
    check(not list((exp / "colour_pacgan").glob("logits_*")), "PacGAN wrote logits")
    check_logits(exp / "toy" / "logits_netD_eval.pkl", list(range(100, TOY_STEPS + 1, 100)),
                 10000)
    check((exp / "toy" / "images" / f"gaussian_step_{TOY_STEPS}.png").is_file(), "no scatter")
    for tr, end in ((c1, MNIST_P1), (c2, MNIST_P2), (c3, MNIST_P2), (f1, MNIST_P1),
                    (f2, MNIST_P2), (f3, MNIST_P2), (pac, MNIST_PAC), (toy, TOY_STEPS)):
        check(tr.global_step == end, f"a run ended at step {tr.global_step}, not {end}")
        finite_metrics(tr, ("errD", "errG"))
    check(f2.cfg.gold and c2.d_drs.count == f2.d_drs.count == MNIST_P2, "phase 2 nets")
    counts = {"colour p1": c1.channel_counts, "colour p2": c2.channel_counts,
              "colour p2 DRS": c2.drs_channel_counts, "colour GOLD p2": c3.channel_counts}
    check(all(sum(c) == 1000 for c in counts.values()), f"red/green counts {counts}")
    print(f"MNIST path wall s by CLI {({k: round(v, 2) for k, v in walls.items()})}; no port "
          f"kernel launched in any [{smi}]")
    print(f"red/green counts of 1000 samples {counts}")
    # each call's arguments: (the recorder, D, the source, ...)
    train_sweeps = [t * 1e3 for args, t in sweeps if args[1] is not toy.d.module]
    toy_sweeps = [t * 1e3 for args, t in sweeps if args[1] is toy.d.module]
    print(f"train-mode sweeps of {MNIST_N} (40 batches of 256, masks drawn): "
          f"{[round(t, 2) for t in train_sweeps]} ms; the toy's eval sweeps of 10000 points "
          f"{[round(t, 2) for t in toy_sweeps]} ms [{smi}]")
    (drs, *_), t_drs = draws[0]
    acc = drs.accepted / drs.proposed
    check(0.0 < acc < 1.0, f"DCGAN DRS acceptance {acc}")
    print(f"DRS batch 250 (colour phase 2's netD_drs): 1000 accepted of {drs.proposed} proposed "
          f"(acceptance {acc:.4f}) in {t_drs:.3f} s = {1000 / t_drs:.2f} accepted/s [{smi}]")
    profile(lambda: drs.disc_fn(drs.gen_fn(drs._latents())),
            "one DRS proposal batch of 250 (DCGAN G + netD_drs, eval mode)", smi, ())
    for (args, t), what in zip(fits, ("colour", "fmnist")):
        n = len(args[1]) // 128 * 128
        print(f"{what} bias probe (SimpleConvNet, 1 epoch, {n} images at batch 128): "
              f"{t:.3f} s = {n / t:.2f} images/s [{smi}]")
    rates = {what: steps_per_s(tr, end + 1, dev, 10) for what, tr, end in (
        ("colour phase 1", c1, MNIST_P1), ("colour phase 2 (twin D)", c2, MNIST_P2),
        ("colour GOLD phase 2", c3, MNIST_P2), ("fmnist phase 2 --gold (twin D)", f2, MNIST_P2),
        ("PacGAN phase 1", pac, MNIST_PAC), ("25gaussian (n_dis 5)", toy, TOY_STEPS))}
    print(f"steps/s (host clock, 10 synchronised steps): "
          f"{({k: round(v, 2) for k, v in rates.items()})}; peak device memory of phase 11 "
          f"{(peak - held) / 2**30:.3f} GiB above the {held / 2**30:.2f} GiB that earlier "
          f"phases still held [{smi}]")
    profile(lambda: c1.fused_step(MNIST_P1 + 30, step_draws(SEED, MNIST_P1 + 30, dev)),
            "one MNIST DCGAN phase-1 step (batch 64, n_dis 1)", smi, ())


class ActSides:
    """The sides (x > 0) of every ReLU and LeakyReLU of one run, and the
    element each 2-D max pool picks, in call order (`record`), applied in
    place of the activations' and pools' own decisions in another run
    (`apply`): torch.nn.functional's relu, leaky_relu and max_pool2d
    patched."""

    def __init__(self):
        self.sides, self.used = [], 0
        self.picks, self.picked = [], 0

    def record(self):
        F = torch.nn.functional
        relu, leaky, pool = F.relu, F.leaky_relu, F.max_pool2d

        def keep(orig):
            def act(x, *a, **k):
                self.sides.append((x > 0).cpu())
                return orig(x, *a, **k)
            return act

        def keep_pick(x, *a, **k):
            out, idx = pool(x, *a, **k, return_indices=True)
            self.picks.append(idx.cpu())
            return out
        return mock.patch.multiple(F, relu=keep(relu), leaky_relu=keep(leaky),
                                   max_pool2d=keep_pick)

    def _next(self, x):
        self.used += 1
        return self.sides[self.used - 1].to(x.device)

    def apply(self):
        self.used = self.picked = 0

        def relu(x, *a, **k):
            return torch.where(self._next(x), x, torch.zeros((), dtype=x.dtype, device=x.device))

        def leaky(x, negative_slope=0.01, inplace=False):
            return torch.where(self._next(x), x, negative_slope * x)

        def pool(x, *a, **k):
            self.picked += 1
            idx = self.picks[self.picked - 1].to(x.device)
            return x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
        return mock.patch.multiple(torch.nn.functional, relu=relu, leaky_relu=leaky,
                                   max_pool2d=pool)

    def in_step(self):
        return self.used == len(self.sides) and self.picked == len(self.picks)


def dcgan_step_card_vs_cpu(dev, smi):
    """11b. One fused MNIST DCGAN phase-2 step (full width, nc 1 as
    MNIST-FMNIST, batch 16, n_dis 2, the twin DRS D, GOLD active, ns loss),
    card against CPU from the same weights, draws and dropout masks, at lr 0
    (one Adam update moves a weight by ~lr whatever its gradient's size,
    PERF.md section 6): the metrics within 1e-3 x max(1, |.|), D's and D_drs's
    BatchNorm running statistics after the step within 1e-4, every update's
    gradients in float64 within 1e-6 x max(1, max|g|), and each device's
    fp32 gradients against the float64 CPU ones within 1e-2 with every ReLU
    and LeakyReLU taking the float64 run's side (ActSides): a pre-activation
    within fp32 round-off of 0 that takes the other side moves a gradient
    by (1 - 0.2) x its upstream value, and the card's fp32 gradients read
    1.27e-2 off at D_drs's conv.8 bias with the sides free (CPU fp32: 8.1e-7;
    NVIDIA H100 80GB HBM3, 700 W). Both are printed, free and shared."""
    import copy

    from diagan_tpu_torch.data.arrays import ArrayDataset
    from diagan_tpu_torch.data.pipeline import DeviceDataSource
    from diagan_tpu_torch.models.mnist_dcgan import (
        MNISTDCGANDiscriminator,
        MNISTDCGANGenerator,
    )
    from diagan_tpu_torch.models.registry import OptSpec
    from diagan_tpu_torch.train.state import NetState
    from diagan_tpu_torch.train.steps import StepConfig, make_fused_step

    bs, n_dis, n, nc = 16, 2, 64, 1
    torch.manual_seed(SEED)
    nets0 = [MNISTDCGANGenerator(nc=nc, device="cpu"), MNISTDCGANDiscriminator(nc=nc, device="cpu"),
             MNISTDCGANDiscriminator(nc=nc, device="cpu")]
    rng = np.random.default_rng(SEED)
    ds = ArrayDataset.from_images(rng.integers(0, 256, (n, 32, 32, nc)).astype(np.uint8))
    draws = {k: [torch.from_numpy(rng.integers(0, n, bs)) for _ in range(n_dis)]
             for k in ("real", "drs")}
    draws.update({k: [torch.from_numpy(rng.standard_normal((bs, 100))) for _ in range(n_dis)]
                  for k in ("z", "drs_z", "g_z")})
    masks = [[torch.from_numpy(rng.random(s) < 0.5) for s in nets0[1].dropout_shapes(bs)]
             for _ in range(n_dis)]

    class Draws:
        def __init__(self, dtype):
            self.dtype = dtype

        def dropout_masks(self, i, shapes, device):
            return [m.to(device) for m in masks[i]]

        def indices(self, kind, i, source, n):
            return draws[kind][i].to(source.device)

        def normal(self, kind, i, n, nz, device):
            return draws[kind][i].to(device, self.dtype)

    class Source(DeviceDataSource):
        def __init__(self, *a, dtype, **k):
            super().__init__(*a, **k)
            self.dtype = dtype

        def gather(self, idx):
            return super().gather(idx).to(self.dtype)

    cfg = StepConfig(n_dis=n_dis, batch_size=bs, nz=100, loss_type="ns", drs_loss_type="ns",
                     model="dcgan", gold=True, gold_step=0, topk=False, epoch_steps=n // bs,
                     use_drs=True)

    def run(d, dtype):
        spec, grads = OptSpec(0.0, (0.5, 0.9)), {}
        nets = [NetState(copy.deepcopy(m).to(d, dtype), spec, 100, None, ups)
                for m, ups in zip(nets0, (1, n_dis, n_dis))]
        for name, net in zip(("G", "D", "D_drs"), nets):
            named = list(net.module.named_parameters())
            net.optim.register_step_pre_hook(
                lambda opt, args, kwargs, name=name, named=named: grads.setdefault(name, []).append(
                    {k: p.grad.detach().cpu().double() for k, p in named}))
        source = Source(ds, weights=np.linspace(0.1, 1.0, n), device=d, dtype=dtype)
        fused = make_fused_step(*nets, cfg, source, Source(ds, device=d, dtype=dtype))
        metrics = {k: float(v) for k, v in fused(5, Draws(dtype)).items()}
        stats = {f"{name}.{k}": t.detach().cpu().double()
                 for name, net in zip(("D", "D_drs"), nets[1:])
                 for k, t in net.module.state_dict().items() if "running" in k}
        return metrics, grads, stats

    def worst(got, want):
        errs = {f"{name}[{u}].{k}": max_err(g[k], w[k]) / max(1.0, w[k].abs().max().item())
                for name in want for u, (g, w) in enumerate(zip(got[name], want[name]))
                for k in w}
        k = max(errs, key=errs.get)
        return errs[k], k

    cpu = torch.device("cpu")
    (m_cpu, g_cpu, s_cpu), (m_card, g_card, s_card) = run(cpu, torch.float32), \
        run(dev, torch.float32)
    m_err = max(abs(m_card[k] - m_cpu[k]) / max(1.0, abs(m_cpu[k])) for k in m_cpu)
    check(m_cpu.keys() == m_card.keys() and m_err <= 1e-3, f"metrics {m_cpu} vs {m_card}")
    s_err = max(max_err(s_card[k], s_cpu[k]) / max(1.0, s_cpu[k].abs().max().item())
                for k in s_cpu)
    check(s_err <= 1e-4, f"running statistics card vs CPU err {s_err}")
    sides = ActSides()
    with sides.record():
        _, ref, _ = run(cpu, torch.float64)
    err64, at64 = worst(run(dev, torch.float64)[1], ref)
    check(err64 <= 1e-6, f"DCGAN float64 gradients err {err64} at {at64} > 1e-6")
    free = {"card": worst(g_card, ref), "CPU": worst(g_cpu, ref)}
    shared = {}
    for name, d in (("card", dev), ("CPU", cpu)):
        with sides.apply():
            shared[name] = worst(run(d, torch.float32)[1], ref)
        check(sides.in_step(), "activation sides out of step")
    check(max(e for e, _ in shared.values()) <= 1e-2,
          f"DCGAN fp32 gradients err with the float64 run's activation sides {shared}; tol 1e-2")

    def fmt(errs):
        return ", ".join(f"{k} {e:.3e} at {at}" for k, (e, at) in errs.items())
    print(f"card vs CPU, one MNIST DCGAN phase-2 step (full width, nc {nc}, batch {bs}, n_dis "
          f"{n_dis}, twin D, GOLD, injected draws and masks, lr 0, TF32 off): losses rel err "
          f"{m_err:.3e} (tol 1e-3); D and D_drs running statistics {s_err:.3e} (tol 1e-4); "
          f"gradients in float64 {err64:.3e} at {at64} (tol 1e-6); in fp32 against the "
          f"float64 CPU ones, the activations' sides shared: {fmt(shared)} (tol 1e-2); "
          f"free: {fmt(free)} [{smi}]")


# depth cuts: the scripts' 50 CAE epochs, 20,000 Inclusive steps and 10 latents
# per real image in a refresh
CAE_EPOCHS, INCL_STEPS, INCL_LATENT_FACTOR = 2, 4, 1
CAE_GEN = 20000  # generated images a CAE run (the scripts' 50,000, cut)


def cae_inclusive_path(dev, smi, work):
    """12. The CAE reconstruction-error protocol and the Inclusive GAN on
    phase 11's runs (`work` is phase 11's directory), through the CLIs at the
    scripts' widths and counts: colour phase 1 resumed with its own CLI to
    MNIST_P2 (the phase-2 run's last step, so both runs have a G there);
    cli.train_cae on the colour baseline (plain sampler) and on the phase-2
    run (DRS at batch 256 through netD_drs), each on CAE_GEN generated
    images and the 10,000 real ones; cli.eval_ae_score --use_loss
    (its CSV); cli.train_cae -d mnist_fmnist on phase 11's FMNIST run (CAE32,
    nc 1); cli.train_mimicry_inclusive at full DCGAN and full Inception width
    on the 10,000 Colored-MNIST images for INCL_STEPS steps (its construction
    registers the real features and refreshes the nearest latents:
    INCL_LATENT_FACTOR x 10,000 latents through G and the Inception at 299);
    cli.train_cae_inclusive on its checkpoint. Cuts (depth only): CAE_GEN
    generated images of the scripts' 50,000, CAE_EPOCHS CAE epochs of the
    scripts' 50, INCL_STEPS Inclusive steps of 20,000 (the
    refresh every 3120 steps is not reached after construction), a refresh
    of 10,000 latents where the script draws 100,000. No port kernel may launch. Readings:
    generated images/s, CAE train images/s, ms per RE sweep of 10,000,
    Inclusive ms per step beside the plain DCGAN step's, s per refresh, s to
    register the real features, the eval_ae_score rows, peak memory, the
    phase's wall s and a profile of one Inclusive step."""
    import pickle

    from diagan_tpu_torch.cli import (
        eval_ae_score,
        train_cae,
        train_cae_inclusive,
        train_mimicry_color_mnist_phase1,
        train_mimicry_inclusive,
    )
    from diagan_tpu_torch.eval import cae_protocol
    from diagan_tpu_torch.eval.drs import DRS
    from diagan_tpu_torch.eval.inception import InceptionFeaturizer
    from diagan_tpu_torch.ops import _build
    from diagan_tpu_torch.train.inclusive import InclusiveTrainer
    from diagan_tpu_torch.train.steps import step_draws

    t_phase = time.perf_counter()
    work = work.resolve()
    exp = work / "exp_results"
    colour, fmnist = work / "dataset" / "colour_mnist", work / "dataset" / "mnist_fmnist"
    common = ["--device", dev.type, "--work_dir", str(exp), "--seed", str(SEED),
              "--num_data", str(MNIST_N)]
    cae = ["--epochs", str(CAE_EPOCHS)]
    g_step = {"colour_mnist": MNIST_P2, "colour_p2": MNIST_P2,
              "mnist_fmnist_baseline": MNIST_P1, "colour_inclusive": INCL_STEPS}
    walls, gens, fits, sweeps, draws, feats, refreshes = {}, [], [], [], [], [], []

    def drive(what, fn):
        _build.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[what] = time.perf_counter() - t0
        no_kernel_launched(what)
        return out

    re_runs = {}

    def cae_run(what, cli, dataset, root, run):
        re_runs[run] = drive(what, lambda: cli.main(common + cae + [
            "-d", dataset, "-r", str(root), "--exp_name", run, "--netG_step", str(g_step[run])]))

    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # what earlier phases still hold
    cwd = os.getcwd()
    os.chdir(work)  # eval_ae_score writes its CSV to the cwd
    try:
        with mock.patch.object(train_cae, "generate_dataset", functools.partial(
                    cae_protocol.generate_dataset, num_images=CAE_GEN)), \
                timed(train_cae, "generate_dataset", gens), timed(train_cae, "train_cae", fits), \
                timed(cae_protocol, "reconstruction_errors", sweeps), \
                timed(DRS, "generate_images", draws), \
                timed(InceptionFeaturizer, "features", feats), \
                timed(InclusiveTrainer, "refresh_nearest_latents", refreshes), \
                mock.patch.object(InclusiveTrainer, "__init__", functools.partialmethod(
                    InclusiveTrainer.__init__, latent_factor=INCL_LATENT_FACTOR)):
            base = drive("colour phase 1 resumed", lambda: train_mimicry_color_mnist_phase1.main(
                common + ["-r", str(colour), "--num_steps", str(MNIST_P2), "--logit_save_steps",
                          "100", "--auto_resume"]))
            cae_run("train_cae colour baseline", train_cae, "color_mnist", colour, "colour_mnist")
            cae_run("train_cae colour phase 2", train_cae, "color_mnist", colour, "colour_p2")
            rows = drive("eval_ae_score", lambda: eval_ae_score.main([
                "-d", "color_mnist", "-r", str(colour), "--device", dev.type,
                "--baseline_exp_path", str(exp / "colour_mnist"),
                "--resample_exp_path", str(exp / "colour_p2"), "--p1_step", str(MNIST_P1),
                "--p2_step", str(MNIST_P2), "--resample_score", "ldr_conf_1.0_ratio_50",
                "--use_loss", "--seed", str(SEED), "--num_data", str(MNIST_N),
                "--name", "chip_smoke"]))
            cae_run("train_cae -d mnist_fmnist", train_cae, "mnist_fmnist", fmnist,
                    "mnist_fmnist_baseline")
            incl = drive("train_mimicry_inclusive", lambda: train_mimicry_inclusive.main(
                common + ["-r", str(colour), "--exp_name", "colour_inclusive", "--num_steps",
                          str(INCL_STEPS)]))
            cae_run("train_cae_inclusive", train_cae_inclusive, "color_mnist", colour,
                    "colour_inclusive")
    finally:
        os.chdir(cwd)
    peak = torch.cuda.max_memory_allocated()

    for run, r in re_runs.items():
        check(r.shape == (MNIST_N, CAE_EPOCHS) and bool(np.isfinite(r).all()),
              f"{run}: RE matrix {r.shape}, finite {np.isfinite(r).all()}")
        check((exp / run / "cae_checkpoints" / f"{g_step[run]}_steps_seed{SEED}"
               / "cae_training_loss.npy").is_file(), f"{run}: no cae_training_loss.npy")
    csv = work / "re_color_mnist_chip_smoke.csv"
    check(csv.is_file() and [r[2] for r in rows] == ["all", "green"]
          and all(math.isfinite(v) for r in rows for v in r[3:]), f"eval_ae_score rows {rows}")
    check(base.global_step == MNIST_P2 and incl.global_step == INCL_STEPS, "a run's last step")
    m = {k: float(v) for k, v in incl.metrics.items()}
    check({"reconsG", "itpG"} <= set(m) and all(math.isfinite(v) for v in m.values()),
          f"Inclusive metrics {m}")
    check(len(draws) == 1 and len(gens) == 4, f"DRS calls {len(draws)}, generations {len(gens)}")
    for run in re_runs:
        with open(exp / run / f"netG_{g_step[run]}_steps_seed{SEED}_generated_dataset.pkl",
                  "rb") as f:
            gen_imgs = pickle.load(f)
        nc = 1 if run == "mnist_fmnist_baseline" else 3
        check(gen_imgs.dtype == np.uint8 and gen_imgs.shape == (CAE_GEN, 32, 32, nc),
              f"{run}: generated {gen_imgs.dtype} {gen_imgs.shape}")
    (drs, *_), t_drs = draws[0]
    print(f"CAE and Inclusive wall s by CLI {({k: round(v, 2) for k, v in walls.items()})}; no "
          f"port kernel launched in any [{smi}]")
    for (args, t), run in zip(gens, ("colour baseline", "colour phase 2 (DRS)", "fmnist",
                                     "Inclusive")):
        print(f"generated {CAE_GEN} for the CAE ({run}): {t:.3f} s = {CAE_GEN / t:.2f} "
              f"images/s [{smi}]")
    print(f"DRS batch 256: {drs.accepted} accepted of {drs.proposed} proposed (acceptance "
          f"{drs.accepted / drs.proposed:.4f}) in {t_drs:.3f} s = {drs.accepted / t_drs:.2f} "
          f"accepted/s [{smi}]")
    sweep_s = [t for _, t in sweeps]
    n_train = CAE_EPOCHS * (CAE_GEN // 128) * 128
    for k, ((args, t), run) in enumerate(zip(fits, re_runs)):
        own = sum(sweep_s[k * CAE_EPOCHS:(k + 1) * CAE_EPOCHS])
        print(f"CAE {run} ({'CAE32 nc 1' if 'fmnist' in run else 'CAE32 nc 3'}): "
              f"{CAE_EPOCHS} epochs of {CAE_GEN} at batch 128 in {t - own:.3f} s = "
              f"{n_train / (t - own):.2f} images/s, then {CAE_EPOCHS} RE sweeps [{smi}]")
    print(f"RE sweeps of {MNIST_N} (batches of 256, eval mode): "
          f"{[round(t * 1e3, 2) for t in sweep_s]} ms [{smi}]")
    print(f"eval_ae_score rows (type, baseline RE, resampled RE, difference %; ratio 0.99, "
          f"seed {SEED}): {[(r[2], *map(float, r[3:])) for r in rows]} [{smi}]")
    (_, t_feats), = feats
    print(f"Inclusive: real features of {MNIST_N} images (Inception at 299, batch 100) "
          f"{t_feats:.3f} s; nearest-latent refresh ({INCL_LATENT_FACTOR * MNIST_N} latents, "
          f"chunks of 500) "
          f"{[round(t, 3) for _, t in refreshes]} s; metrics {m} [{smi}]")
    incl_sps = steps_per_s(incl, INCL_STEPS + 1, dev, 5)
    plain_sps = steps_per_s(base, MNIST_P2 + 1, dev, 20)
    print(f"Inclusive step (batch 64, n_dis 1; G's loss with 3 G and 3 Inception forwards at "
          f"299 and their backward) {1e3 / incl_sps:.2f} ms; the plain DCGAN phase-1 step in "
          f"this process {1e3 / plain_sps:.2f} ms (host clock, synchronised) [{smi}]")
    print(f"peak device memory of phase 12 {(peak - held) / 2**30:.3f} GiB above the "
          f"{held / 2**30:.2f} GiB that earlier phases still held; phase 12 wall "
          f"{time.perf_counter() - t_phase:.2f} s [{smi}]")
    s = INCL_STEPS + 10
    profile(lambda: incl.fused_step(s, step_draws(SEED, s, dev)),
            "one Inclusive step (batch 64, n_dis 1)", smi, ())


def cae_inclusive_card_vs_cpu(dev, smi):
    """12b. The CAE (CAE32, nc 3, batch 16) eval- and train-mode forwards,
    and the Inclusive hook (the MNIST DCGAN, the FID InceptionV3 at 299 with
    its random weights, batch 2, fixed draws) with its G gradients, card
    against CPU from the same weights. The hook's real features are G's own
    raw features scaled by 1 + 0.1 N(0, 1), so that its distances depend on
    G (raw pool3 under random weights is tiny beside unit-scale features).
    The CAE within 1e-3 x max(1, max|out|); the hook's values within 1e-3
    relative, each G gradient within 1e-2 of its tensor's max|g| with every
    ReLU taking the CPU run's side (ActSides)."""
    import copy

    from diagan_tpu_torch.eval.inception import InceptionFeaturizer, pool3_with_grad
    from diagan_tpu_torch.models.cae import CAE32
    from diagan_tpu_torch.models.mnist_dcgan import MNISTDCGANGenerator
    from diagan_tpu_torch.train.inclusive import InclusiveLoss

    cpu = torch.device("cpu")
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(np.tanh(rng.standard_normal((16, 32, 32, 3))).astype(np.float32))
    cae_cpu = CAE32(3, seed=SEED, device="cpu")
    cae_card = copy.deepcopy(cae_cpu).to(dev)
    cae_err = 0.0
    with torch.no_grad():
        for mode in ("eval", "train"):
            want = getattr(cae_cpu, mode)()(x)
            got = getattr(cae_card, mode)()(x.to(dev)).cpu()
            cae_err = max(cae_err, max_err(got, want) / max(1.0, want.abs().max().item()))
    check(cae_err <= 1e-3, f"CAE card vs CPU err {cae_err}")

    bs, n, nz = 2, 8, 100
    torch.manual_seed(SEED)
    g_cpu = MNISTDCGANGenerator(nc=3, device="cpu")
    incep = InceptionFeaturizer(device="cpu").model.requires_grad_(False)
    nearest = torch.from_numpy(rng.standard_normal((n, nz)).astype(np.float32))
    with torch.no_grad():
        raw = pool3_with_grad(incep, g_cpu(nearest).permute(0, 3, 1, 2))
    feats = raw * (1 + 0.1 * torch.from_numpy(rng.standard_normal(raw.shape).astype(np.float32)))
    fixed = {"inclusive_idx1": torch.from_numpy(rng.integers(0, n, bs)),
             "inclusive_idx2": torch.from_numpy(rng.integers(0, n, bs)),
             "inclusive_z1": torch.from_numpy(rng.standard_normal((bs, nz)).astype(np.float32)),
             "inclusive_z2": torch.from_numpy(rng.standard_normal((bs, nz)).astype(np.float32)),
             "inclusive_alpha": torch.from_numpy(rng.random(bs).astype(np.float32))}

    class Draws:
        def indices(self, kind, i, source, n):
            return fixed[kind].to(source.train_feats.device)

        def normal(self, kind, i, n, nz, device):
            return fixed[kind].to(device)

        def uniform(self, kind, i, n, device):
            return fixed[kind].to(device)

    def run(d):
        gen = copy.deepcopy(g_cpu).to(d).train()
        hook = InclusiveLoss(copy.deepcopy(incep).to(d), feats.to(d), bs, nz)
        hook.nearest_latent = nearest.to(d)
        metrics = {}
        loss = hook(gen, Draws(), 0, metrics)
        grads = torch.autograd.grad(loss, list(gen.parameters()))
        metrics["loss"] = loss
        return {k: float(v.detach()) for k, v in metrics.items()}, [g.cpu() for g in grads]

    sides = ActSides()
    with sides.record():
        m_cpu, g_cpu_grads = run(cpu)
    with sides.apply():
        m_card, g_card_grads = run(dev)
    check(sides.used == len(sides.sides), "activation sides out of step")
    m_err = max(abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k]) for k in m_cpu)
    g_err = max(max_err(a, b) / b.abs().max().item() for a, b in zip(g_card_grads, g_cpu_grads))
    check(m_err <= 1e-3 and g_err <= 1e-2, f"Inclusive hook card vs CPU: values {m_err}, "
          f"gradients {g_err}")
    print(f"card vs CPU, TF32 off: CAE32 forwards (eval, train; batch 16) rel err "
          f"{cae_err:.3e} (tol 1e-3); the Inclusive hook (DCGAN G, Inception at 299, batch 2) "
          f"loss / reconsG / itpG rel err {m_err:.3e} (tol 1e-3), G gradients with the CPU "
          f"run's ReLU sides {g_err:.3e} of each tensor's max|g| (tol 1e-2); values {m_cpu}; "
          f"max|g| {max(g.abs().max().item() for g in g_cpu_grads):.3e} [{smi}]")



SS_P1, SS_P2, SS_FLAG_STEPS, SS_MNIST_STEPS, SS_CELEBA_STEPS = 12, 16, 6, 100, 4  # depth cuts
SS_RATE_STEPS = 3  # synchronised steps a steps/s reading takes (a depth cut)
SS_DRS_N = 2048  # DRS samples a model (a depth cut)


def sngan_twin_step(tr, dataset, dev, **fusions):
    """A fused step of fresh full-width SNGAN nets (the registry's, from seed
    0) on a trainer's data and step configuration, phase 1, with `fusions`:
    SNGAN's step beside the trainer's own, in the same process."""
    from diagan_tpu_torch.models.registry import get_gan_model
    from diagan_tpu_torch.train.state import NetState
    from diagan_tpu_torch.train.steps import make_fused_step

    torch.manual_seed(SEED)
    b = get_gan_model(dataset, device=dev)
    cfg = tr.cfg._replace(model="sngan", use_drs=False, **fusions)
    g = NetState(b.gen, b.opt_g, 1000, "linear", 1)
    d = NetState(b.disc, b.opt_d, 1000, "linear", cfg.n_dis)
    return make_fused_step(g, d, None, cfg, tr.source)


def ssgan_infomax_path(dev, smi, work):
    """13. SSGAN and InfoMax-GAN through the Dia-GAN path, --simultaneous_g
    and --bf16, at full width (ngf 256, ndf 128, nrkhs 1024; 64 px: ngf, ndf
    1024), batch 64, n_dis 5, on the earlier phases' data (`work` holds
    phase 8's sngan/cifar10, phase 10's celeba/celeba and phase 11's
    mnist/dataset/colour_mnist). Per model, cli.train_mimicry_phase1 for
    SS_P1 steps with 50k sweeps at 5 and 10, cli.train_mimicry_phase2 to
    SS_P2 (ldr_conf_1.0_ratio_50, the twin D), load_eval_models and DRS at
    batch 256 (SS_DRS_N samples) from the phase-2 checkpoint; SNGAN-32
    phase 1 with --simultaneous_g, then with --bf16; a Colored-MNIST phase 1 with --bf16;
    SSGAN-64 and InfoMax-64 phase 1 on CelebA with the sweep window past the
    run's end. No port kernel may launch. Steps/s of each beside SNGAN's
    (and SNGAN's under concat_d and fuse_g) in this process, ms per 50k
    sweep, DRS accepted/s, peak memory and profiles of one SSGAN and one
    InfoMax step."""
    from diagan_tpu_torch.cli import (
        train_mimicry_color_mnist_phase1,
        train_mimicry_phase1,
        train_mimicry_phase2,
    )
    from diagan_tpu_torch.eval.drs import DRS
    from diagan_tpu_torch.eval.evaluate import load_eval_models, make_disc_fn, make_gen_fn
    from diagan_tpu_torch.models.registry import get_gan_model
    from diagan_tpu_torch.ops import _build
    from diagan_tpu_torch.train.steps import step_draws

    out = work / "ssgan_infomax"
    cifar = work / "sngan" / "cifar10"
    celeba = work / "celeba" / "celeba"
    colour = work / "mnist" / "dataset" / "colour_mnist"
    common = ["--work_dir", str(out), "--device", dev.type, "--seed", str(SEED),
              "--batch_size", str(SNGAN_BS), "--n_dis", str(SNGAN_NDIS)]
    cifar_args = common + ["-r", str(cifar)]
    walls, sps = {}, {}

    def drive(what, fn):
        _build.reset_launches()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        walls[what] = time.perf_counter() - t0
        no_kernel_launched(what)
        return result

    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # what earlier phases still hold
    trainers = {}
    for model in ("ssgan", "infomax_gan"):
        args = cifar_args + ["--model", model]
        tr1 = drive(f"{model} phase 1", lambda: train_mimicry_phase1.main(args + [
            "--exp_name", f"{model}_p1", "--no_schedule_override", "--num_steps", str(SS_P1),
            "--logit_save_steps", "5", "--save_logit_after", "5",
            "--stop_save_logit_after", "10"]))
        check_logits(out / f"{model}_p1" / "logits_netD_eval.pkl", [5, 10], SNGAN_N)
        aux = ("errD", "errG", "D(x)", "D(G(z))")
        print(f"train_mimicry_phase1 --model {model} ({SS_P1} steps, 2 sweeps of {SNGAN_N}): "
              f"{walls[f'{model} phase 1']:.2f} s, metrics {finite_metrics(tr1, aux)}; no port "
              f"kernel launched")
        tr2 = drive(f"{model} phase 2", lambda: train_mimicry_phase2.main(args + [
            "--exp_name", f"{model}_p2", "--baseline_exp_name", f"{model}_p1", "--p1_step",
            str(SS_P1), "--num_steps", str(SS_P2), "--resample_score", EVAL_SCORE]))
        check(tr2.global_step == SS_P2 and tr2.d_drs.count == tr2.d.count == SS_P2 * SNGAN_NDIS,
              f"{model} phase 2 ended at step {tr2.global_step}, D updates {tr2.d.count}")
        print(f"train_mimicry_phase2 --model {model} ({SS_P2 - SS_P1} steps, {EVAL_SCORE}, twin "
              f"DRS D): {walls[f'{model} phase 2']:.2f} s, metrics "
              f"{finite_metrics(tr2, ('errD', 'errG', 'errD_drs'))}; no port kernel launched")

        def drs_run():
            gen, disc = load_eval_models(get_gan_model("cifar10", model=model, drs=True,
                                                       device=dev), out / f"{model}_p2", SS_P2,
                                         use_drs=True)
            drs = DRS(make_gen_fn(gen), make_disc_fn(disc), 128, batch_size=256, device=dev,
                      generator=torch.Generator(dev).manual_seed(SEED + 3))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            images = drs.generate_images(SS_DRS_N)
            return drs, images, time.perf_counter() - t0
        drs, accepted, t_drs = drive(f"{model} DRS", drs_run)
        acc = drs.accepted / drs.proposed
        check(accepted.shape == (SS_DRS_N, 32, 32, 3) and np.isfinite(accepted).all()
              and 0.0 < acc < 1.0, f"{model} DRS output, acceptance {acc}")
        sps[f"{model} phase 1"] = steps_per_s(tr1, SS_P2 + 1, dev, SS_RATE_STEPS)
        sps[f"{model} phase 2"] = steps_per_s(tr2, SS_P2 + 1, dev, SS_RATE_STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr1.recorder.sweep(tr1.d.module, tr1.source)
        torch.cuda.synchronize()
        sweep = (time.perf_counter() - t0) * 1e3
        print(f"{model}: DRS batch 256 {SS_DRS_N} accepted of {drs.proposed} (acceptance "
              f"{acc:.4f}) in {t_drs:.2f} s = {SS_DRS_N / t_drs:.2f} accepted/s; logit sweep of "
              f"{SNGAN_N} at batch 256 {sweep:.2f} ms; no port kernel launched [{smi}]")
        trainers[model] = tr1
        del tr2, drs

    tr_ss = trainers["ssgan"]
    for name, fusions in (("sngan", {}), ("sngan concat_d", {"concat_d": True}),
                          ("sngan fuse_g", {"fuse_g": True})):
        sps[name] = steps_per_s(None, SS_P2 + 1, dev, SS_RATE_STEPS,
                                fused=sngan_twin_step(tr_ss, "cifar10", dev, **fusions))
    for flag in ("--simultaneous_g", "--bf16"):
        tr = drive(f"sngan {flag}", lambda: train_mimicry_phase1.main(cifar_args + [
            "--exp_name", f"sngan{flag.replace('-', '_')}", "--no_schedule_override",
            "--num_steps", str(SS_FLAG_STEPS), "--no_save_logits", flag]))
        check(tr.cfg.simultaneous_g == (flag == "--simultaneous_g") and tr.g.count ==
              SS_FLAG_STEPS and tr.d.count == SS_FLAG_STEPS * SNGAN_NDIS, f"{flag} run {tr.cfg}")
        check((tr.g.module.l1.dtype == torch.bfloat16) == (flag == "--bf16"), f"{flag} dtype")
        print(f"train_mimicry_phase1 SNGAN-32 {flag} ({SS_FLAG_STEPS} steps): "
              f"{walls[f'sngan {flag}']:.2f} s, metrics "
              f"{finite_metrics(tr, ('errD', 'errG', 'D(x)', 'D(G(z))'))}; no port kernel "
              f"launched")
        sps[f"sngan {flag}"] = steps_per_s(tr, SS_FLAG_STEPS, dev, SS_RATE_STEPS)
        del tr
    print(f"SNGAN-family steps/s at 32 px, batch 64, n_dis 5 (host clock, {SS_RATE_STEPS} "
          f"synchronised steps, fp32 unless bf16): {({k: round(v, 3) for k, v in sps.items()})} [{smi}]")

    tr = drive("colour phase 1 --bf16", lambda: train_mimicry_color_mnist_phase1.main([
        "--work_dir", str(out), "--device", dev.type, "--seed", str(SEED), "-r", str(colour),
        "--exp_name", "colour_bf16", "--bf16", "--num_steps", str(SS_MNIST_STEPS),
        "--logit_save_steps", "100"]))
    check(tr.g.module.fc.dtype == torch.bfloat16, "colour --bf16 dtype")
    check_logits(out / "colour_bf16" / "logits_netD_train.pkl", [100], MNIST_N)
    print(f"train_mimicry_color_mnist_phase1 --bf16 ({SS_MNIST_STEPS} steps, a train-mode sweep "
          f"of {MNIST_N} at 100): {walls['colour phase 1 --bf16']:.2f} s, metrics "
          f"{finite_metrics(tr, ('errD', 'errG'))}; {steps_per_s(tr, 101, dev):.3f} steps/s; "
          f"no port kernel launched [{smi}]")
    del tr

    sps64 = {}
    for model in ("ssgan", "infomax_gan"):
        tr = drive(f"celeba {model}", lambda: train_mimicry_phase1.main(common + [
            "-d", "celeba", "-r", str(celeba), "--model", model, "--exp_name",
            f"celeba_{model}", "--no_schedule_override", "--num_steps", str(SS_CELEBA_STEPS),
            "--logit_save_steps", "100", "--save_logit_after", "100",
            "--stop_save_logit_after", "200"]))
        check(tr.g.count == SS_CELEBA_STEPS and not tr.recorder.count, f"celeba {model} run")
        print(f"train_mimicry_phase1 -d celeba --model {model} ({SS_CELEBA_STEPS} steps, no "
              f"sweep): {walls[f'celeba {model}']:.2f} s, metrics "
              f"{finite_metrics(tr, ('errD', 'errG', 'D(x)', 'D(G(z))'))}; no port kernel "
              f"launched")
        sps64[model] = steps_per_s(tr, SS_CELEBA_STEPS, dev, SS_RATE_STEPS)
        if model == "ssgan":
            sps64["sngan"] = steps_per_s(None, SS_CELEBA_STEPS, dev, SS_RATE_STEPS,
                                         fused=sngan_twin_step(tr, "celeba", dev))
        del tr
    print("SNGAN-family steps/s at 64 px (ngf, ndf 1024), batch 64, n_dis 5, fp32 (host clock, "
          f"{SS_RATE_STEPS} synchronised steps): {({k: round(v, 3) for k, v in sps64.items()})} "
          f"[{smi}]")
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 13 wall s by run {({k: round(v, 2) for k, v in walls.items()})}; no port "
          f"kernel launched in any; peak device memory {(peak - held) / 2**30:.2f} GiB above the "
          f"{held / 2**30:.2f} GiB that earlier phases still held [{smi}]")
    for model, tr in trainers.items():
        profile(lambda: tr.fused_step(SS_P2 + 20, step_draws(SEED, SS_P2 + 20, dev)),
                f"one {model} phase-1 step (32 px, batch {SNGAN_BS}, n_dis {SNGAN_NDIS})", smi,
                ())


class TypedSource:
    """A DeviceDataSource whose batches come in `dtype` (float64 runs)."""

    def __init__(self, source, dtype):
        self.source, self.dtype, self.device = source, dtype, source.device

    def gather(self, idx):
        return self.source.gather(idx).to(self.dtype)


class FixedDraws:
    """A fused step's draws from a dict {kind: [per-iteration tensors]}."""

    def __init__(self, draws, dtype):
        self.draws, self.dtype = draws, dtype

    def indices(self, kind, i, source, n):
        return self.draws[kind][i].to(source.device)

    def normal(self, kind, i, n, nz, device):
        return self.draws[kind][i].to(device, self.dtype)


def fused_step_grads(mods, cfg, ds, draws, d, dtype, lr):
    """(metrics, {net: [per update [grads]]}) of one fused step of copies of
    the CPU modules `mods` (G, D, D_drs) on device d; dtype float64 moves
    them and the data to float64 (bf16 modules keep their compute dtype)."""
    import copy

    from diagan_tpu_torch.data.pipeline import DeviceDataSource
    from diagan_tpu_torch.models.registry import OptSpec
    from diagan_tpu_torch.train.state import NetState
    from diagan_tpu_torch.train.steps import make_fused_step

    spec, grads = OptSpec(lr, (0.0, 0.9)), {}
    nets = [NetState(copy.deepcopy(m).to(d, dtype), spec, 100, "linear", ups)
            for m, ups in zip(mods, (1, cfg.n_dis, cfg.n_dis))]
    for name, net in zip(("G", "D", "D_drs"), nets):
        named = list(net.module.named_parameters())
        net.optim.register_step_pre_hook(
            lambda opt, args, kwargs, name=name, named=named: grads.setdefault(name, []).append(
                {k: p.grad.detach().cpu().double() for k, p in named}))
    n = len(ds)
    source = TypedSource(DeviceDataSource(ds, weights=np.linspace(0.1, 1.0, n), device=d), dtype)
    fused = make_fused_step(*nets, cfg, source, TypedSource(DeviceDataSource(ds, device=d), dtype))
    return {k: float(v) for k, v in fused(5, FixedDraws(draws, dtype)).items()}, grads


def worst_grad(got, want):
    """(max over updates and tensors of |got - want| / max(1, max|want|), where)."""
    errs = {f"{name}[{u}].{k}": max_err(g[k], w[k]) / max(1.0, w[k].abs().max().item())
            for name in want for u, (g, w) in enumerate(zip(got[name], want[name])) for k in w}
    k = max(errs, key=errs.get)
    return errs[k], k


def aux_step_card_vs_cpu(dev, smi, model, size, width, bs, lr, label, **fusions):
    """One fused phase-2 step (twin D, n_dis 2, hinge) of `model` at `size`
    px, width `width` (ngf = ndf; InfoMax's nrkhs 1024), card against CPU
    from the same weights and injected draws, every ReLU taking the side of
    the CPU float64 run (ActSides): the metrics and every update's gradients
    in fp32 within 1e-3 x max(1, max|.|). Returns the errors."""
    from diagan_tpu_torch.data.arrays import ArrayDataset
    from diagan_tpu_torch.data.synthetic import synthetic_natural
    from diagan_tpu_torch.models import registry
    from diagan_tpu_torch.train.steps import StepConfig

    n_dis, n = 2, 64
    gens, discs = ((registry._GEN_32, registry._DISC_32) if size == 32
                   else (registry._GEN_64, registry._DISC_64))
    torch.manual_seed(SEED)
    mods = [gens[model](ngf=width, device="cpu"), discs[model](ndf=width, device="cpu"),
            discs[model](ndf=width, device="cpu")]
    ds = ArrayDataset.from_images(synthetic_natural(n, size, seed=13)[0])
    rng = np.random.default_rng(SEED)

    def normal(m):
        return torch.from_numpy(rng.standard_normal((m, 128)).astype(np.float32))
    draws = {k: [torch.from_numpy(rng.integers(0, n, bs)) for _ in range(n_dis)]
             for k in ("real", "drs")}
    draws.update({k: [normal(bs) for _ in range(n_dis)] for k in ("z", "drs_z", "g_z")})
    draws["z_all"] = [normal(2 * n_dis * bs)]
    cfg = StepConfig(n_dis=n_dis, batch_size=bs, nz=128, loss_type="hinge", drs_loss_type="ns",
                     model=model, gold=False, gold_step=0, topk=False, epoch_steps=n // bs,
                     use_drs=True, **fusions)
    cpu = torch.device("cpu")
    sides = ActSides()
    with sides.record():
        fused_step_grads(mods, cfg, ds, draws, cpu, torch.float64, lr)
    runs = {}
    for name, d in (("CPU", cpu), ("card", dev)):
        with sides.apply():
            runs[name] = fused_step_grads(mods, cfg, ds, draws, d, torch.float32, lr)
        check(sides.used == len(sides.sides), f"{label}: ReLU sides out of step on the {name}")
    (m_cpu, g_cpu), (m_card, g_card) = runs["CPU"], runs["card"]
    m_err = max(abs(m_card[k] - m_cpu[k]) / max(1.0, abs(m_cpu[k])) for k in m_cpu)
    check(m_cpu.keys() == m_card.keys() and m_err <= 1e-3, f"{label}: metrics {m_cpu} vs {m_card}")
    g_err, at = worst_grad(g_card, g_cpu)
    check(g_err <= 1e-3, f"{label}: gradients err {g_err} at {at} > 1e-3")
    print(f"card vs CPU, {label} ({model}, {size} px, width {width}, batch {bs}, n_dis {n_dis}, "
          f"twin D, lr {lr}, fusions {fusions or 'none'}, injected draws, the CPU float64 run's "
          f"ReLU sides, fp32, TF32 off): losses rel err {m_err:.3e}; gradients {g_err:.3e} at "
          f"{at} (tol 1e-3) [{smi}]")
    return m_err, g_err


BF16_TOL = 1e-1  # bf16 rounding after every conv / dense: CPU bf16 vs fp32 read 2e-2 - 4.5e-2


def bf16_card_vs_cpu(dev, smi):
    """SNGAN-32 (width 64) with the bf16 compute dtype on the card against the
    fp32 CPU run from the same weights: G's images (eval mode) and D's
    logits within BF16_TOL x max(1, max|out|), and one fused phase-2 step at
    lr 0 (twin D, batch 16, n_dis 2, injected draws): metrics and gradients
    within BF16_TOL x max(1, max|.|); the CPU's own bf16 run's distance from
    its fp32 one is printed beside each as the yardstick."""
    from diagan_tpu_torch.data.arrays import ArrayDataset
    from diagan_tpu_torch.data.synthetic import synthetic_natural
    from diagan_tpu_torch.models import sngan
    from diagan_tpu_torch.train.steps import StepConfig

    bs, n_dis, n, width = 16, 2, 64, 64
    torch.manual_seed(SEED)

    def nets(dtype):
        return [sngan.SNGANGenerator32(ngf=width, device="cpu", dtype=dtype),
                sngan.SNGANDiscriminator32(ndf=width, device="cpu", dtype=dtype),
                sngan.SNGANDiscriminator32(ndf=width, device="cpu", dtype=dtype)]
    fp32 = nets(torch.float32)
    bf16 = nets(torch.bfloat16)
    for m, m0 in zip(bf16, fp32):
        m.load_state_dict(m0.state_dict())
    ds = ArrayDataset.from_images(synthetic_natural(n, 32, seed=13)[0])
    rng = np.random.default_rng(SEED)
    draws = {k: [torch.from_numpy(rng.integers(0, n, bs)) for _ in range(n_dis)]
             for k in ("real", "drs")}
    draws.update({k: [torch.from_numpy(rng.standard_normal((bs, 128)).astype(np.float32))
                      for _ in range(n_dis)] for k in ("z", "drs_z", "g_z")})
    z = draws["z"][0]
    x = torch.tanh(torch.from_numpy(rng.standard_normal((bs, 32, 32, 3)).astype(np.float32)))

    def forward(mods, d):
        g, disc = (m.to(d) for m in mods[:2])
        with torch.no_grad():
            out = g.eval()(z.to(d)).float().cpu(), disc(x.to(d))[0].float().cpu()
        mods[0].cpu(), mods[1].cpu()
        return out

    def rel(got, want):
        return (got - want).abs().max().item() / max(1.0, want.abs().max().item())
    want = forward(fp32, torch.device("cpu"))
    card, cpu16 = forward(bf16, dev), forward(bf16, torch.device("cpu"))
    fwd = [rel(c, w) for c, w in zip(card, want)]
    yard = [rel(c, w) for c, w in zip(cpu16, want)]
    check(max(fwd) <= BF16_TOL, f"bf16 forwards card vs CPU fp32 {fwd}")
    for m in fp32 + bf16:
        m.train()
    cfg = StepConfig(n_dis=n_dis, batch_size=bs, nz=128, loss_type="hinge", drs_loss_type="ns",
                     model="sngan", gold=False, gold_step=0, topk=False, epoch_steps=n // bs,
                     use_drs=True)
    cpu = torch.device("cpu")
    m32, g32 = fused_step_grads(fp32, cfg, ds, draws, cpu, torch.float32, 0.0)
    m_card, g_card = fused_step_grads(bf16, cfg, ds, draws, dev, torch.float32, 0.0)
    m_cpu16, g_cpu16 = fused_step_grads(bf16, cfg, ds, draws, cpu, torch.float32, 0.0)
    m_err = max(abs(m_card[k] - m32[k]) / max(1.0, abs(m32[k])) for k in m32)
    m_yard = max(abs(m_cpu16[k] - m32[k]) / max(1.0, abs(m32[k])) for k in m32)
    (g_err, at), (g_yard, _) = worst_grad(g_card, g32), worst_grad(g_cpu16, g32)
    check(m_err <= BF16_TOL and g_err <= BF16_TOL,
          f"bf16 step card vs CPU fp32: metrics {m_err}, gradients {g_err} at {at}")
    print(f"card bf16 vs CPU fp32, SNGAN-32 width {width} (tol {BF16_TOL} x max(1, max|.|); "
          f"the CPU's bf16 run's distance in parentheses): G images (eval) {fwd[0]:.3e} "
          f"({yard[0]:.3e}), D logits {fwd[1]:.3e} ({yard[1]:.3e}); one phase-2 step at lr 0: "
          f"losses {m_err:.3e} ({m_yard:.3e}), gradients {g_err:.3e} at {at} ({g_yard:.3e}) "
          f"[{smi}]")


def ssgan_infomax_card_vs_cpu(dev, smi):
    """13b. The SNGAN family's new step paths, card against CPU
    (aux_step_card_vs_cpu): SSGAN-32 and InfoMax-32 (width 64, batch 16, lr
    2e-4); SSGAN-64 and InfoMax-64 at full width (1024) with batch 2 and lr
    0 (an Adam step moves a weight by ~lr whatever its gradient's size,
    PERF.md section 6); SNGAN-32 under simultaneous_g, concat_d and fuse_g;
    then bf16 (bf16_card_vs_cpu)."""
    for model in ("ssgan", "infomax_gan"):
        aux_step_card_vs_cpu(dev, smi, model, 32, 64, 16, 2e-4, f"one {model}-32 step")
    for model in ("ssgan", "infomax_gan"):
        aux_step_card_vs_cpu(dev, smi, model, 64, 1024, 2, 0.0, f"one {model}-64 step")
    for fusion in ("simultaneous_g", "concat_d", "fuse_g"):
        aux_step_card_vs_cpu(dev, smi, "sngan", 32, 64, 16, 2e-4, f"one SNGAN-32 {fusion} step",
                             **{fusion: True})
    bf16_card_vs_cpu(dev, smi)


# --- 14. the FFHQ trainer's flags and the checkpoint readers ----------------
FLAG_KERNELS = ("upfirdn2d", "upfirdn2d_backward", "fused_leaky_relu",
                "fused_leaky_relu_backward", "fused_leaky_relu_db", *WARP)
BF16_FIR = ("fir4x4", "fir4x4_up2", "fir4x4_down2")  # A1-A3: G and D blurs, the ToRGB skip
BF16_FLR = ("fused_leaky_relu", "fused_leaky_relu_backward", "fused_leaky_relu_db")


def to_reference(g_sd, d_sd):
    """The port's StyleGAN2 state_dicts in the reference's (rosinality's)
    key layout, as its `{iter:06d}.pt` holds them, with the fixed blur and
    noise buffers it also saves; D's ResBlock skip convs have no bias there,
    so theirs are dropped. The inverse of utils/jax_params.py's
    reference_*_state_dict."""
    g, d = {}, {}
    for key, t in g_sd.items():
        t = t.detach().cpu()
        if key.startswith("mapping.layers."):
            i, name = key[len("mapping.layers."):].split(".", 1)
            g[f"style.{int(i) + 1}.{name}"] = t
            continue
        if key == "synthesis.input":
            g["input.input"] = t
            continue
        layer, rest = key[len("synthesis.layers."):].split(".", 1)
        if layer.startswith(("conv_up_", "conv_", "to_rgb_")):
            j = int(math.log2(int(layer.rsplit("_", 1)[1]))) - 3
            prefix = (f"to_rgbs.{j}" if layer.startswith("to_rgb_") else
                      f"convs.{2 * j + (0 if layer.startswith('conv_up_') else 1)}")
        else:
            prefix = layer
        rgb = prefix.startswith("to_rgb")
        if rest == "conv.weight":
            g[f"{prefix}.conv.weight"] = t[None]
        elif rest == "noise.weight":
            g[f"{prefix}.noise.weight"] = t.reshape(1)
        elif rest == "bias":
            g[f"{prefix}.bias" if rgb else f"{prefix}.activate.bias"] = (
                t.reshape(1, 3, 1, 1) if rgb else t)
        else:
            g[f"{prefix}.{rest}"] = t
    blur = torch.full((4, 4), 1 / 16)
    n_res = int(math.log2(SIZE)) - 2
    for j in range(n_res):
        g[f"convs.{2 * j}.conv.blur.kernel"] = blur * 4
        g[f"to_rgbs.{j}.upsample.kernel"] = blur * 4
    for i in range(2 * n_res + 1):
        res = 2 ** ((i + 5) // 2)
        g[f"noises.noise_{i}"] = torch.randn(1, 1, res, res)
    top = {"from_rgb.conv.weight": "convs.0.0.weight", "from_rgb.bias": "convs.0.1.bias",
           "final_conv.conv.weight": "final_conv.0.weight", "final_conv.bias": "final_conv.1.bias",
           "final_linear.weight": "final_linear.0.weight",
           "final_linear.bias": "final_linear.0.bias", "out_linear.weight": "final_linear.1.weight",
           "out_linear.bias": "final_linear.1.bias"}
    inner = {"conv1.conv.weight": "conv1.0.weight", "conv1.bias": "conv1.1.bias",
             "conv2.conv.weight": "conv2.1.weight", "conv2.bias": "conv2.2.bias",
             "skip.conv.weight": "skip.1.weight", "skip.conv.bias": None}
    for key, t in d_sd.items():
        t = t.detach().cpu()
        if key in top:
            d[top[key]] = t
            continue
        _, b, rest = key.split(".", 2)
        if inner[rest] is not None:
            d[f"convs.{int(b) + 1}.{inner[rest]}"] = t
        if rest == "conv2.conv.weight":
            d[f"convs.{int(b) + 1}.conv2.0.kernel"] = blur
            d[f"convs.{int(b) + 1}.skip.0.kernel"] = blur
    return g, d


def flags_path(dev, smi, work):
    """14a. cli.train_ffhq --bf16 --remat --stream_data --no_fuse --max_chunk 4
    for 8 steps with logit sweeps at 2, 4 and 6 on phase 6's 512 images,
    then cli.train_ffhq_phase2 --bf16 --stream_data for 4 steps from that
    checkpoint (ldr_conf_3.0_ratio_50, the twin D); each run launches every
    training kernel (the generic kernel A instance and the two-phase warp
    pair none), and A1-A3 and the fused act's three kernels on bf16 tensors.
    Then the phase-1 checkpoint copied into the reference's key layout goes
    through read_stylegan2_ckpt and cli.generate. Returns (the phase-1
    trainer, {run: (launches, kernel A launches by instance, bf16 launches)})."""
    import pickle

    from diagan_tpu_torch.cli import generate, train_ffhq, train_ffhq_phase2
    from diagan_tpu_torch.eval.evaluate import read_stylegan2_ckpt
    from diagan_tpu_torch.models.stylegan2 import StyleGAN2Discriminator, StyleGAN2Generator
    from diagan_tpu_torch.ops import _build

    data = work / "train" / "data"
    check((data / f"ffhq_{SIZE}.npy").is_file(), "phase 6's dataset is missing")
    common = ["-d", "ffhq", "-r", str(data), "--size", str(SIZE), "--batch", "16",
              "--augment", "--augment_p", "0.3", "--work_dir", str(work / "flags"),
              "--seed", str(SEED), "--device", dev.type]
    runs = {}

    def drive(name, fn):
        _build.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, bf16 = dict(_build.LAUNCHES), dict(_build.BF16_LAUNCHES)
        fir = fir_launches(name)
        check(all(launches[k] > 0 for k in FLAG_KERNELS) and
              all(launches[k] == 0 for k in WARP2), f"{name} launches {launches}")
        check(all(bf16.get(f"upfirdn2d/{i}", 0) > 0 for i in BF16_FIR) and
              all(bf16.get(k, 0) > 0 for k in BF16_FLR), f"{name} bf16 launches {bf16}")
        print(f"{name}: {wall:.2f} s [{smi}], launches {launches}; of them on bf16 tensors "
              f"{bf16}")
        runs[name] = (launches, fir, bf16)
        return out

    torch.cuda.reset_peak_memory_stats()
    tr1 = drive("train_ffhq --bf16 --remat --stream_data --no_fuse --max_chunk 4 (8 steps)",
                lambda: train_ffhq.main(common + [
                    "--exp_name", "p1", "--iter", "8", "--logit_save_steps", "2",
                    "--save_logit_after", "0", "--bf16", "--remat", "--stream_data",
                    "--no_fuse", "--max_chunk", "4"]))
    peak = torch.cuda.max_memory_allocated()
    check(tr1.stream and tr1.images is None and tr1.gen.synthesis.remat and tr1.disc.remat
          and tr1.disc.dtype == torch.bfloat16, "phase 1 did not take the flags")
    print(f"phase 1 (bf16, remat, streamed) metrics: "
          f"{finite_metrics(tr1, ('d', 'g', 'r1', 'path'))}; peak device memory "
          f"{peak / 2**30:.2f} GiB [{smi}]")
    ckpt1, pkl = work / "flags" / "p1" / "checkpoint" / "000008.pt", work / "flags" / "p1" / \
        "logits_netD.pkl"
    check(ckpt1.is_file() and pkl.is_file(), "phase 1 wrote no checkpoint or logits")
    with open(pkl, "rb") as f:
        logits = pickle.load(f)
    check(sorted(logits) == [2, 4, 6] and all(
        v.shape == (N_DATA,) and np.isfinite(v).all() for v in logits.values()),
        f"logits {sorted(logits)}")
    tr2 = drive("train_ffhq_phase2 --bf16 --stream_data (4 steps)",
                lambda: train_ffhq_phase2.main(common + [
                    "--exp_name", "p2", "--baseline_exp_name", "p1", "--p1_step", "8",
                    "--resample_score", "ldr_conf_3.0_ratio_50", "--iter", "12", "--bf16",
                    "--stream_data"]))
    check(tr2.stream and tr2._w_sampler is not None and tr2.drs_disc is not None and
          (work / "flags" / "p2" / "checkpoint" / "000012.pt").is_file(),
          "phase 2 did not stream its weighted draws or wrote no checkpoint")
    print(f"phase 2 (bf16, streamed) metrics: {finite_metrics(tr2, ('d', 'g', 'path'))}")

    # the reference's format: phase 1's weights under rosinality's keys
    raw = torch.load(ckpt1, map_location="cpu", weights_only=True)
    g_ref, d_ref = to_reference(raw["g"], raw["d"])
    ema_ref = to_reference(raw["g_ema"], raw["d"])[0]
    ref = work / "flags" / "reference" / "000008.pt"
    ref.parent.mkdir(parents=True)
    torch.save({"g": g_ref, "d": d_ref, "g_ema": ema_ref, "ada_aug_p": 0.3}, ref)
    g = StyleGAN2Generator(SIZE, STYLE_DIM, N_MLP, CH_MULT, device=dev)
    d = StyleGAN2Discriminator(SIZE, CH_MULT, device=dev)
    read_stylegan2_ckpt(ref, g, d, use_drs=True)
    want_d = {k: torch.zeros_like(v) if k.endswith("skip.conv.bias") else v
              for k, v in raw["d"].items()}
    check(all(torch.equal(v.cpu(), raw["g_ema"][k]) for k, v in g.state_dict().items()) and
          all(torch.equal(v.cpu(), want_d[k]) for k, v in d.state_dict().items()),
          "read_stylegan2_ckpt of the reference-format copy differs")
    _build.reset_launches()
    imgs = generate.main(["--size", str(SIZE), "--sample", "4", "--pics", "1", "--ckpt", str(ref),
                          "--out_dir", str(work / "flags" / "ref_samples"), "--seed", str(SEED),
                          "--device", dev.type])
    check(imgs.shape == (4, SIZE, SIZE, 3) and np.isfinite(imgs).all() and
          all(_build.LAUNCHES[k] > 0 for k in FORWARD_KERNELS), "generate from the reference file")
    print(f"the reference-format copy of phase 1's checkpoint ({len(g_ref)} G and {len(d_ref)} "
          f"D keys): read_stylegan2_ckpt exact, cli.generate 4 images finite")
    return tr1, runs


def flags_against_plain(dev, smi, work, tr1):
    """14b. The streamed logit sweep of phase 1's D over the 512 images
    against the device-resident sweep: bit for bit. One fp32 training step
    (D with ADA, R1, G through ADA, path length) with and without remat from
    the same weights and draws: losses and gradients within 1e-6 x max(1,
    max|.|), and each run's peak device memory. Then ms per step (host
    clock, synchronised) of the plain, path and R1 + path steps in fp32 and
    in bf16, and of the plain step streamed and with remat. The remat
    comparison runs at lr 0, so each piece starts from the same weights in
    every run, with cuDNN's deterministic algorithms; a second plain run
    gives the run-to-run spread that is left (ADA's adjoint adds its clamped
    pass with atomics)."""
    from diagan_tpu_torch.models.ada import sample_augment
    from diagan_tpu_torch.models.stylegan2 import (
        NoiseInjection,
        StyleGAN2Discriminator,
        StyleGAN2Generator,
    )
    from diagan_tpu_torch.train.stylegan2_trainer import FakeDraws, StyleGAN2Trainer

    images = np.load(work / "train" / "data" / f"ffhq_{SIZE}.npy", mmap_mode="r")
    resident = StyleGAN2Trainer(work / "flags" / "sweep", tr1.gen, tr1.disc, images, num_steps=0,
                                augment_p=None, stream_data=False, device=dev)
    ms = {}
    for name, tr in (("streamed", tr1), ("resident", resident)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr._record_logits(-1)
        ms[name] = (time.perf_counter() - t0) * 1e3
    a = tr1.logit_results["netD_eval"].pop(-1)
    b = resident.logit_results["netD_eval"].pop(-1)
    check(a.shape == b.shape == (N_DATA,) and np.array_equal(a, b),
          f"streamed sweep differs from the resident one: max abs {np.abs(a - b).max()}")
    print(f"logit sweep of {N_DATA} images (phase 1's bf16 D): streamed {ms['streamed']:.2f} ms, "
          f"resident {ms['resident']:.2f} ms, bit for bit equal [{smi}]")
    del resident

    torch.manual_seed(SEED)
    g0 = StyleGAN2Generator(SIZE, STYLE_DIM, N_MLP, CH_MULT, device=dev)
    d0 = StyleGAN2Discriminator(SIZE, CH_MULT, device=dev)
    with torch.no_grad():
        for m in g0.modules():
            if isinstance(m, NoiseInjection):
                m.weight.fill_(0.1)
    bs = 16

    def trainer(name, dtype=torch.float32, remat=False, stream=False, lr=0.002):
        g = StyleGAN2Generator(SIZE, STYLE_DIM, N_MLP, CH_MULT, dtype=dtype, remat=remat,
                               device=dev)
        d = StyleGAN2Discriminator(SIZE, CH_MULT, dtype=dtype, remat=remat, device=dev)
        g.load_state_dict(g0.state_dict())
        d.load_state_dict(d0.state_dict())
        return StyleGAN2Trainer(work / "flags" / name, g, d, images, num_steps=1, batch_size=bs,
                                lr=lr, augment_p=0.3, stream_data=stream, seed=SEED, device=dev)

    gen = torch.Generator(dev).manual_seed(SEED + 40)
    real = torch.from_numpy(np.array(images[:bs])).to(dev).float() / 127.5 - 1.0
    fakes = FakeDraws(torch.randn((bs, STYLE_DIM), generator=gen, device=dev),
                      torch.randn((bs, STYLE_DIM), generator=gen, device=dev), 5,
                      [torch.randn(s, generator=gen, device=dev)
                       for s in g0.synthesis.noise_shapes(bs)])
    aug = [sample_augment(bs, 0.3, SIZE, SIZE, torch.Generator().manual_seed(SEED + k))
           for k in range(3)]
    path = (torch.randn((bs // 2, STYLE_DIM), generator=gen, device=dev),
            [torch.randn(s, generator=gen, device=dev) for s in g0.synthesis.noise_shapes(bs // 2)],
            torch.randn((bs // 2, SIZE, SIZE, 3), generator=gen, device=dev))
    pieces = ("D loss (ADA)", "R1", "G through ADA", "path length")
    runs = {}
    # cuDNN's deterministic algorithms: its default weight and data gradients
    # add with atomics in a run-dependent order, and path length's penalty,
    # (|J^T y| - mean)^2, magnifies that round-off (1.2e-4 of max|g| between
    # two runs on an H100 80GB HBM3 without them); what is left is the order
    # of ADA's adjoint's clamped pass in the G step, printed as the plain
    # run's spread. TF32 stays off: flags() turns it on unless told
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        for name in ("plain", "remat", "plain again"):
            # lr 0: every piece starts from the same weights (Adam turns a
            # round-off-sized gradient into a step of lr, whatever its size)
            tr = trainer(name.replace(" ", "_"), remat=name == "remat", lr=0.0)
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            res = []
            for run, net in (
                    (lambda: tr.d_step(tr.disc, tr.d_optim, real, fakes, aug[0], aug[1]),
                     tr.disc),
                    (lambda: tr.r1_step(tr.disc, tr.d_optim, real, aug[2]), tr.disc),
                    (lambda: tr.g_step(fakes, aug[0]), tr.gen),
                    (lambda: tr.path_step(*path), tr.gen)):
                m = run()
                res.append(({k: float(v) for k, v in m.items()},
                            [p.grad.detach().clone() for p in net.parameters()
                             if p.grad is not None]))
            torch.cuda.synchronize()
            runs[name] = (res, torch.cuda.max_memory_allocated() - held, held)
            del tr

    def errors(other):
        """Per piece: (losses, gradients) of run `other` against the plain
        run, each relative to max(1, max|.|)."""
        out = []
        for (m0, g0_), (m1, g1_) in zip(runs["plain"][0], runs[other][0]):
            check(m0.keys() == m1.keys() and len(g0_) == len(g1_) > 0, f"{other}: pieces differ")
            scale = max(1.0, max(w.abs().max().item() for w in g0_))
            out.append((max(abs(m1[k] - m0[k]) / max(1.0, abs(m0[k])) for k in m0),
                        max(max_err(a, b) for a, b in zip(g1_, g0_)) / scale))
        return out

    remat, spread = errors("remat"), errors("plain again")
    report = "; ".join(f"{p}: losses {r[0]:.3e} ({s_[0]:.3e}), gradients {r[1]:.3e} ({s_[1]:.3e})"
                       for p, r, s_ in zip(pieces, remat, spread))
    check(all(r[0] <= 1e-6 and r[1] <= 1e-6 for r in remat),
          f"remat against plain (the plain run's own spread in parentheses): {report}")
    print(f"one fp32 step (batch 16, {SIZE} px, ADA p=0.3, lr 0, cuDNN deterministic) with remat "
          f"against without, of max(1, max|.|), tol 1e-6 (a second plain run's distance in "
          f"parentheses): {report} [{smi}]")
    held = runs["plain"][2]
    print(f"peak device memory of that step above the trainer's {held / 2**30:.2f} GiB: plain "
          f"{runs['plain'][1] / 2**30:.2f} GiB, remat {runs['remat'][1] / 2**30:.2f} GiB [{smi}]")
    del runs

    def step_ms(tr, step, reps=2):
        tr.train_step(step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            tr.train_step(step)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        tr = trainer(f"time_{name}", dtype=dtype)
        plain, path_ms, both = step_ms(tr, 1), step_ms(tr, 4), step_ms(tr, 16)
        cadence = (12 * plain + 3 * path_ms + both) / 16
        print(f"training StyleGAN2-{SIZE} batch 16 {name}, ADA p=0.3, device-resident: plain "
              f"{plain:.2f} ms, path {path_ms:.2f} ms, R1 + path {both:.2f} ms; default cadence "
              f"{cadence:.2f} ms/step = {1e3 / cadence:.3f} steps/s [{smi}]")
        del tr
    turns = {}
    for name in ("resident", "streamed", "remat", "remat", "streamed", "resident"):
        tr = trainer(name, remat=name == "remat", stream=name == "streamed")
        turns.setdefault(name, []).append(step_ms(tr, 1))
        del tr
    for name, (t1, t2) in turns.items():
        print(f"plain step fp32 {name}: {t1:.2f} / {t2:.2f} ms (two turns), mean "
              f"{(t1 + t2) / 2:.2f} ms [{smi}]")


def bf16_train_step_card_vs_cpu(dev, smi, work):
    """14c. One bf16 training step on the card against the fp32 CPU run at
    6b's size (32 px, width 1/4, batch 4) with its injected draws: G's images
    and D's logits, then the D loss with ADA at p = 1, R1, the G step through
    ADA and path length, losses and gradients, each within BF16_TOL x max(1,
    max|.|); the CPU's own bf16 run's distance from fp32 is printed beside
    each as the yardstick."""
    import copy

    from diagan_tpu_torch.data.synthetic import synthetic_natural
    from diagan_tpu_torch.models.ada import sample_augment
    from diagan_tpu_torch.models.stylegan2 import (
        NoiseInjection,
        StyleGAN2Discriminator,
        StyleGAN2Generator,
    )
    from diagan_tpu_torch.train.stylegan2_trainer import FakeDraws, StyleGAN2Trainer

    size, bs, width = 32, 4, 0.25
    cpu = torch.device("cpu")
    torch.manual_seed(SEED)
    nets = {}
    for dtype in (torch.float32, torch.bfloat16):
        nets[dtype] = (StyleGAN2Generator(size, STYLE_DIM, N_MLP, CH_MULT, width_scale=width,
                                          dtype=dtype, device="cpu"),
                       StyleGAN2Discriminator(size, CH_MULT, width_scale=width, dtype=dtype,
                                              device="cpu"))
    g32, d32 = nets[torch.float32]
    with torch.no_grad():
        for m in g32.modules():
            if isinstance(m, NoiseInjection):
                m.weight.fill_(0.1)
    for m, m32 in zip(nets[torch.bfloat16], (g32, d32)):
        m.load_state_dict(m32.state_dict())
    rng = np.random.default_rng(SEED)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    real = torch.from_numpy(rng.uniform(-1, 1, (bs, size, size, 3)).astype(np.float32))
    z1, z2 = normal(bs, STYLE_DIM), normal(bs, STYLE_DIM)
    noises = [normal(*s) for s in g32.synthesis.noise_shapes(bs)]
    aug = [sample_augment(bs, 1.0, size, size, torch.Generator().manual_seed(k)) for k in range(3)]
    zp = normal(bs // 2, STYLE_DIM)
    noises_p = [normal(*s) for s in g32.synthesis.noise_shapes(bs // 2)]
    path_noise = normal(bs // 2, size, size, 3)
    images = synthetic_natural(8, size, seed=3)[0]

    def rel(got, want):
        return (got.float().cpu() - want).abs().max().item() / max(1.0, want.abs().max().item())

    sides = {"cpu fp32": (torch.float32, cpu), "card bf16": (torch.bfloat16, dev),
             "cpu bf16": (torch.bfloat16, cpu)}
    fwd = {}
    for side, (dtype, d) in sides.items():
        g, disc = (copy.deepcopy(m).to(d) for m in nets[dtype])
        with torch.no_grad():
            fwd[side] = (g.sample([z1.to(d), z2.to(d)], 3, noises=[n.to(d) for n in noises]).cpu(),
                         disc(real.to(d))[0].cpu())
    want = fwd["cpu fp32"]
    f_err = [rel(c, w) for c, w in zip(fwd["card bf16"], want)]
    f_yard = [rel(c, w) for c, w in zip(fwd["cpu bf16"], want)]
    tr = {side: StyleGAN2Trainer(work / side.replace(" ", "_"),
                                 *(copy.deepcopy(m).to(d) for m in nets[dtype]), images,
                                 num_steps=1, batch_size=bs, augment_p=1.0, device=d)
          for side, (dtype, d) in sides.items()}
    pieces = {
        "D loss (ADA p=1)": ("disc", lambda t, d: t.d_step(
            t.disc, t.d_optim, real.to(d), FakeDraws(z1.to(d), z2.to(d), 3,
                                                     [n.to(d) for n in noises]), aug[0], aug[1])),
        "R1": ("disc", lambda t, d: t.r1_step(t.disc, t.d_optim, real.to(d), aug[2])),
        "G through ADA": ("gen", lambda t, d: t.g_step(FakeDraws(
            z1.to(d), z2.to(d), 3, [n.to(d) for n in noises]), aug[0])),
        "path length": ("gen", lambda t, d: t.path_step(
            zp.to(d), [n.to(d) for n in noises_p], path_noise.to(d))),
    }
    m_err, m_yard, g_err, g_yard = {}, {}, {}, {}
    for name, (net, run) in pieces.items():
        res = {}
        start = [{k: v.clone() for k, v in getattr(tr["cpu fp32"], n).state_dict().items()}
                 for n in ("gen", "disc")] + [tr["cpu fp32"].pl_mean.clone()]
        for side, (dtype, d) in sides.items():  # each from the fp32 run's weights before it
            t = tr[side]
            t.gen.load_state_dict(start[0])
            t.disc.load_state_dict(start[1])
            t.pl_mean = start[2].to(d)
            m = run(t, d)
            res[side] = ({k: float(v) for k, v in m.items()},
                         [p.grad.float().cpu() for p in getattr(t, net).parameters()
                          if p.grad is not None])
        (mw, gw) = res["cpu fp32"]
        for side, m_out, g_out in (("card bf16", m_err, g_err), ("cpu bf16", m_yard, g_yard)):
            mg, gg = res[side]
            check(len(gg) == len(gw) > 0, f"{name}: gradient sets differ")
            m_out[name] = max(abs(mg[k] - mw[k]) / max(1.0, abs(mw[k])) for k in mw)
            scale = max(1.0, max(w.abs().max().item() for w in gw))
            g_out[name] = max(max_err(a, b) for a, b in zip(gg, gw)) / scale
    check(max(f_err) <= BF16_TOL and max(m_err.values()) <= BF16_TOL and
          max(g_err.values()) <= BF16_TOL,
          f"bf16 card vs CPU fp32: forwards {f_err}, losses {m_err}, gradients {g_err}")
    print(f"card bf16 vs CPU fp32, StyleGAN2-{size} width {width} batch {bs} (tol {BF16_TOL} x "
          f"max(1, max|.|); the CPU's bf16 run's distance in parentheses): G images "
          f"{f_err[0]:.3e} ({f_yard[0]:.3e}), D logits {f_err[1]:.3e} ({f_yard[1]:.3e}) [{smi}]")
    for name in pieces:
        print(f"  {name}: losses {m_err[name]:.3e} ({m_yard[name]:.3e}), gradients "
              f"{g_err[name]:.3e} ({g_yard[name]:.3e}) [{smi}]")
    print(f"  in all: losses {max(m_err.values()):.3e} ({max(m_yard.values()):.3e}), gradients "
          f"{max(g_err.values()):.3e} ({max(g_yard.values()):.3e}) [{smi}]")


def time_bf16_kernels(dev, rng, ch, k4, smi, runs, against=()):
    """14d. The bf16 instances A1-A3 and the fused act's kernels at the bf16
    step's shapes (the SIZE px G upsample blur, the ToRGB skip and its
    backward; the styled conv's activation and its epilogue build at SIZE
    px): each against its plain version in bf16 (kernel A 1e-2 x max|out|,
    as phase 3; the fused act 1 ulp, its db 1e-5 x sum|dx| per channel, the
    epilogue bit for bit), its time (kernel A by CUDA-graph
    replay in turns with one cuDNN call in bf16, the fused act eagerly, as
    their fp32 rows), its plain version's and its bytes bound (bf16 reads and
    writes: half the fp32 bytes). Launches: the bf16 launches of phase 14a's
    runs (`runs`, empty in phase 3d). A1 also on the G upsample blur's
    backward at SIZE and SIZE / 2 px, whose rows are 2^k + 1 wide (printed
    only). With `against` (against_fir: other checkouts' kernel A), A1-A3
    must give their bits, and each is timed in the same turns. Returns the
    kernels-line entries."""
    import torch.nn.functional as F

    from diagan_tpu_torch.ops import (
        fused_leaky_relu,
        fused_leaky_relu_backward,
        fused_leaky_relu_backward_plain,
        fused_leaky_relu_plain,
        styled_leaky_relu,
        styled_leaky_relu_plain,
        upfirdn2d,
        upfirdn2d_plain,
    )
    from diagan_tpu_torch.ops.upfirdn2d import fir_instance

    bf = torch.bfloat16
    bf16 = {k: sum(r[2].get(k, 0) for r in runs.values())
            for k in {k for r in runs.values() for k in r[2]}}
    c, k16 = ch[SIZE], k4 * 4

    def dw(t, n):
        return t.to(bf).expand(n, 1, *t.shape).contiguous()

    passes = [
        ("G upsample blur", (16, c, SIZE + 1, SIZE + 1), 1, 1, (1, 1),
         lambda x: F.conv2d(x, dw(k16, c), padding=1, groups=c)),
        ("ToRGB skip", (16, 3, SIZE // 2, SIZE // 2), 2, 1, (2, 1),
         lambda x: F.conv_transpose2d(x, dw(k16, 3), stride=2, padding=1, groups=3)),
        ("ToRGB skip backward", (16, 3, SIZE, SIZE), 1, 2, (1, 1),
         lambda x: F.conv2d(x, dw(k16, 3), stride=2, padding=1, groups=3)),
        ("G upsample blur backward", (16, c, SIZE, SIZE), 1, 1, (2, 2),
         lambda x: F.conv2d(x, dw(k16, c), padding=2, groups=c)),
        (f"G upsample blur backward at {SIZE // 2} px", (16, ch[SIZE // 2], SIZE // 2, SIZE // 2),
         1, 1, (2, 2), lambda x: F.conv2d(x, dw(k16, ch[SIZE // 2]), padding=2,
                                          groups=ch[SIZE // 2])),
    ]
    kernels = []
    for name, shape, up, down, pad, lib in passes:
        x = torch.randn(shape, generator=rng, device=dev).to(bf)
        inst = fir_instance(4, 4, up, down, bf, torch.contiguous_format)
        y = upfirdn2d(x, k16, up, down, pad)
        want = upfirdn2d_plain(x, k16, up, down, pad)
        err = max_err(y, want)
        check(y.dtype == bf and err <= 1e-2 * want.float().abs().max().item(),
              f"kernel A {inst} bf16 {name} err {err}")
        fns = {"a": lambda: upfirdn2d(x, k16, up, down, pad), "lib": lambda: lib(x)}
        for o in reversed(against):
            theirs = o(x, k16, up, down, pad)
            same = torch.equal(theirs.view(torch.int16), y.view(torch.int16))
            check(same, f"kernel A {inst} bf16 {name}: not {o.root}'s bits (max abs "
                        f"difference {max_err(theirs, y):.3e})")
            fns = {o.root: lambda o=o: o(x, k16, up, down, pad), **fns}
        ms = in_turns(fns)
        (a1, a2), (l1, l2) = ms["a"], ms["lib"]
        plain = cuda_ms(lambda: upfirdn2d_plain(x, k16, up, down, pad), iters=2, warmup=1)
        b_p, by = bound((x.numel() + y.numel()) * 2, y.numel() * 16 // (up * up) * 2)
        other = "".join(f", {o.root} {ms[o.root][0]:.4f} / {ms[o.root][1]:.4f} ms (the same "
                        f"bits)" for o in against)
        print(f"kernel A {inst} bf16, {name} {tuple(x.shape)} -> {tuple(y.shape)}: {a1:.4f} / "
              f"{a2:.4f} ms, cuDNN in bf16 {l1:.4f} / {l2:.4f} ms{other} (device time, two "
              f"turns), bound {b_p:.4f} ms ({by}), {2 * b_p / (a1 + a2):.2f} of the bound "
              f"[{smi}]")
        if "blur backward" in name:
            continue
        kernels.append({
            "name": f"upfirdn2d_bf16/{inst}", "route": "cuda",
            "source": "diagan_tpu_torch/csrc/upfirdn2d.cu",
            "replaces": "diagan_tpu/ops/fir_pallas.py:44,131,226",
            "launches": bf16.get(f"upfirdn2d/{inst}", 0), "max_abs_err": err,
            "ms": (a1 + a2) / 2, "plain_ms": plain, "bound_ms": b_p, "bound_by": by,
            "library_ms": (l1 + l2) / 2,
            "shape": f"{tuple(x.shape)} -> {tuple(y.shape)} bf16, {name}; ms and library_ms: "
                     f"device time of CUDA-graph replays, mean of two turns; library: one cuDNN "
                     f"depthwise convolution in bf16",
        })
        del x, y, want

    xb = torch.randn((16, c, SIZE, SIZE), generator=rng, device=dev).to(bf)
    bb = torch.randn(c, generator=rng, device=dev).to(bf)
    y = fused_leaky_relu(xb, bb)
    want = fused_leaky_relu_plain(xb, bb)
    check(bool(((y.float() - want.float()).abs() <= bf16_ulp(want)).all()),
          "fused_leaky_relu bf16 differs from plain by more than 1 ulp")
    b_f, by_f = bound(2 * xb.numel() * 2 + c * 2, xb.numel() * 3)
    kernels.append({
        "name": "fused_leaky_relu_bf16", "route": "triton",
        "source": "diagan_tpu_torch/ops/fused_act.py", "replaces": "diagan_tpu/ops/fused_act.py:41",
        "launches": bf16.get("fused_leaky_relu", 0), "max_abs_err": max_err(y, want),
        "ms": cuda_ms(lambda: fused_leaky_relu(xb, bb)),
        "plain_ms": cuda_ms(lambda: fused_leaky_relu_plain(xb, bb)),
        "bound_ms": b_f, "bound_by": by_f, "library_ms": None,
        "shape": f"{tuple(xb.shape)} bf16 (styled conv at {SIZE} px)",
    })
    styled = styled_inputs(dev, rng, (16, c, SIZE, SIZE), bf)
    check(torch.equal(styled_leaky_relu(*styled), styled_leaky_relu_plain(*styled)),
          "styled_leaky_relu bf16 differs from plain")
    ys, _, ds, ns, _ = styled
    b_s, by_s = bound((2 * ys.numel() + ns.numel() + ds.numel() + c + 1) * 2, 6 * ys.numel())
    kernels.append({
        "name": "styled_leaky_relu_bf16", "route": "triton",
        "source": "diagan_tpu_torch/ops/fused_act.py",
        "replaces": "diagan_tpu/ops/fused_act.py:41 and the two passes before it",
        "launches": bf16.get("styled_leaky_relu", 0), "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: styled_leaky_relu(*styled)),
        "plain_ms": cuda_ms(lambda: styled_leaky_relu_plain(*styled)),
        "bound_ms": b_s, "bound_by": by_s, "library_ms": None,
        "shape": f"{tuple(ys.shape)} bf16, demod (N, C), noise (N, 1, H, W) (StyledConv "
                 f"epilogue at {SIZE} px)",
    })
    g = torch.randn(xb.shape, generator=rng, device=dev).to(bf)
    dx, db = fused_leaky_relu_backward(g, y)
    dx_p, db_p = fused_leaky_relu_backward_plain(g, y)
    check(bool(((dx.float() - dx_p.float()).abs() <= bf16_ulp(dx_p)).all()) and bool(
        ((db - db_p).abs() <= 1e-5 * dx_p.float().abs().sum((0, 2, 3))).all()),
        "fused_leaky_relu_backward bf16 differs from plain")
    b_b, by_b = bound(3 * g.numel() * 2 + c * 4, 4 * g.numel())
    kernels.append({
        "name": "fused_leaky_relu_backward_bf16", "route": "triton",
        "source": "diagan_tpu_torch/ops/fused_act.py", "replaces": "diagan_tpu/ops/fused_act.py:68",
        "launches": bf16.get("fused_leaky_relu_backward", 0),
        "max_abs_err": max(max_err(dx, dx_p), max_err(db, db_p)),
        "ms": cuda_ms(lambda: fused_leaky_relu_backward(g, y)),
        "plain_ms": cuda_ms(lambda: fused_leaky_relu_backward_plain(g, y)),
        "bound_ms": b_b, "bound_by": by_b, "library_ms": None,
        "shape": f"{tuple(g.shape)} bf16, dx (bf16) and db (fp32) (styled conv at {SIZE} px)",
    })
    for k in kernels:
        print(f"{k['name']} at {k['shape']}: {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
              f"library {k['library_ms']}, bound {k['bound_ms']:.4f} ms ({k['bound_by']}), "
              f"{k['bound_ms'] / k['ms']:.2f} of the bound; bf16 launches in phase 14a "
              f"{k['launches']} [{smi}]")
    if runs:
        print(f"phase 14a's bf16 launches in all: {bf16} (flr_db "
              f"{bf16.get('fused_leaky_relu_db', 0)}) [{smi}]")
    return kernels


def stock_spectral_names(sd):
    """A mimicry state_dict as torch.nn.utils.spectral_norm saves it (the
    reference's torch-mimicry files): weight_orig, weight_u and weight_v."""
    out = {}
    for key, t in sd.items():
        if key.endswith(".weight_u"):
            w = sd[key[: -len("_u")]].reshape(len(t), -1)
            v = w.t() @ t
            out[key[: -len("_u")] + "_v"] = v / v.norm()
            out[key] = t
        elif key.endswith(".weight") and key + "_u" in sd:
            out[key + "_orig"] = t
        else:
            out[key] = t
    return out


CARRY_P1, CARRY_STEPS = 30, 4  # phase 8's phase-1 step; phase-2 steps from the reference files


def carried_run_path(dev, smi, work):
    """15a. Phase 8's SNGAN-32 phase-1 netG / netD rewritten as the reference
    writes them (torch-mimicry's save_checkpoint wrapper, stock spectral-norm
    names, no update_count) and cli.train_mimicry_phase2 from them for
    CARRY_STEPS steps at full width (ngf 256, ndf 128, batch 64, n_dis 5):
    the global step is the files' global_step and each net's first update
    runs at lr0 from fresh Adam moments (the JAX package's import_torch_net
    rule); no port kernel may launch. Then the same weights as bare
    state_dicts through load_eval_models and DRS at batch 256."""
    from diagan_tpu_torch.cli import train_mimicry_phase2
    from diagan_tpu_torch.eval.drs import DRS
    from diagan_tpu_torch.eval.evaluate import load_eval_models, make_disc_fn, make_gen_fn
    from diagan_tpu_torch.models.registry import get_gan_model
    from diagan_tpu_torch.ops import _build
    from diagan_tpu_torch.train.checkpoint import ckpt_path
    from diagan_tpu_torch.train.state import NetState

    sngan = work / "sngan"
    ref, bare = sngan / "ref_p1", sngan / "bare"
    for name, bare_name in (("netG", "netG"), ("netD", "netD_drs")):
        raw = torch.load(ckpt_path(sngan / "p1" / "checkpoints", name, CARRY_P1),
                         map_location="cpu", weights_only=True)
        for root, key, payload in (
                (ref, name, {"model_state_dict": stock_spectral_names(raw["model_state_dict"]),
                             "optimizer_state_dict": raw["optimizer_state_dict"],
                             "global_step": CARRY_P1}),
                (bare, bare_name, raw["model_state_dict"])):
            path = ckpt_path(root / "checkpoints", key, CARRY_P1)
            path.parent.mkdir(parents=True, exist_ok=True)
            torch.save(payload, path)
    shutil.copy(sngan / "p1" / "logits_netD_eval.pkl", ref / "logits_netD_eval.pkl")

    first = {}  # each net's first update: (lr, update count, step)
    apply_update = NetState.apply_update

    def recording_update(net):
        first.setdefault(id(net), (net.schedule(net.count), net.count, net.step))
        apply_update(net)

    num_steps = CARRY_P1 + CARRY_STEPS
    _build.reset_launches()
    t0 = time.perf_counter()
    with mock.patch.object(NetState, "apply_update", recording_update):
        tr = train_mimicry_phase2.main([
            "-r", str(sngan / "cifar10"), "--work_dir", str(sngan), "--device", dev.type,
            "--batch_size", str(SNGAN_BS), "--n_dis", str(SNGAN_NDIS), "--seed", str(SEED),
            "--exp_name", "ref_p2", "--baseline_exp_name", "ref_p1", "--p1_step",
            str(CARRY_P1), "--num_steps", str(num_steps), "--resample_score",
            "ldr_conf_1.0_ratio_50"])
    torch.cuda.synchronize()
    t_p2 = time.perf_counter() - t0
    no_kernel_launched("train_mimicry_phase2 from reference files")
    check(tr.global_step == num_steps, f"resumed run ended at step {tr.global_step}")
    for label, net, ups in (("G", tr.g, 1), ("D", tr.d, SNGAN_NDIS),
                            ("D_drs", tr.d_drs, SNGAN_NDIS)):
        lr, count, step = first[id(net)]
        lr0 = tr.bundle.opt_g.lr if label == "G" else tr.bundle.opt_d.lr
        check(count == 0 and step == CARRY_P1 and lr == lr0,
              f"{label}'s first resumed update: lr {lr}, count {count}, step {step}")
        check(net.count == CARRY_STEPS * ups and net.step == CARRY_P1 + CARRY_STEPS * ups,
              f"{label} after the run: count {net.count}, step {net.step}")
    ref_lr = tr.bundle.opt_g.lr * (1 - CARRY_P1 / num_steps)
    print(f"train_mimicry_phase2 from torch-mimicry files (global_step {CARRY_P1}, no "
          f"update_count): {CARRY_STEPS} steps in {t_p2:.2f} s, global step {CARRY_P1} -> "
          f"{tr.global_step}; every net's first update at lr0 {tr.bundle.opt_g.lr} from fresh "
          f"Adam (the JAX package's rule; the reference's own phase 2 would use "
          f"{ref_lr:.6g}); metrics {finite_metrics(tr, ('errD', 'errG', 'errD_drs'))}; no port "
          f"kernel launched")
    print(f"phase 2 from reference files: {steps_per_s(tr, num_steps, dev, n=4):.2f} steps/s "
          f"(host clock, 4 synchronised steps) [{smi}]")
    del tr

    _build.reset_launches()
    gen, disc = load_eval_models(get_gan_model("cifar10", drs=True, device=dev), bare,
                                 CARRY_P1, use_drs=True)
    want_g, want_d = load_eval_models(get_gan_model("cifar10", drs=True, device=dev),
                                      sngan / "p1", CARRY_P1, use_drs=True,
                                      use_original_netD=True)
    for got, want in ((gen, want_g), (disc, want_d)):
        for key, t in want.state_dict().items():
            check(torch.equal(got.state_dict()[key], t), f"bare state_dict load differs at {key}")
    t0 = time.perf_counter()
    drs = DRS(make_gen_fn(gen), make_disc_fn(disc), 128,
              generator=torch.Generator(dev).manual_seed(SEED + 15), batch_size=256, device=dev)
    accepted = drs.generate_images(1024)
    t_drs = time.perf_counter() - t0
    no_kernel_launched("load_eval_models and DRS from bare state_dicts")
    check(accepted.shape == (1024, 32, 32, 3) and np.isfinite(accepted).all(),
          "DRS from bare state_dicts")
    print(f"load_eval_models of bare state_dicts: the phase-1 weights exactly; DRS batch 256 "
          f"(warm-up included) 1024 accepted of {drs.proposed} in {t_drs:.2f} s; no port kernel "
          f"launched [{smi}]")


def downsample_conv_path(dev, smi):
    """15b. ModulatedConv(downsample=True) at StyleGAN2-256's widths (512
    channels, style 512, 64 -> 32 px, batch 16), k = 3 and 1: its blur runs
    kernel A's fir4x4 instance (A1), which must launch (and the generic
    instance not); card against CPU at 1e-3 x max(1, max|out|), TF32 off; A1
    on the blur's input against its plain version at kernel A's fp32
    tolerance; ms per forward. Returns the forwards' launches (per kernel,
    and kernel A's per instance)."""
    from diagan_tpu_torch.models.stylegan2 import ModulatedConv
    from diagan_tpu_torch.ops import _build, upfirdn2d, upfirdn2d_plain

    launches, fir = {}, {}
    for k in (3, 1):
        torch.manual_seed(SEED + 15 + k)
        conv = ModulatedConv(512, 512, STYLE_DIM, k, downsample=True, device=dev)
        cpu = ModulatedConv(512, 512, STYLE_DIM, k, downsample=True, device="cpu")
        cpu.load_state_dict({n: t.cpu() for n, t in conv.state_dict().items()})
        g = torch.Generator(dev).manual_seed(SEED + 15 + k)
        x = torch.randn((16, 512, 64, 64), generator=g, device=dev)
        s = torch.randn((16, STYLE_DIM), generator=g, device=dev)
        with torch.no_grad():
            _build.reset_launches()
            y = conv(x, s)
            torch.cuda.synchronize()
            for name, n in _build.LAUNCHES.items():
                launches[name] = launches.get(name, 0) + n
            for inst, n in _build.FIR_INSTANCES.items():
                fir[inst] = fir.get(inst, 0) + n
            check(_build.FIR_INSTANCES["fir4x4"] > 0 and _build.FIR_INSTANCES["generic"] == 0,
                  f"downsample k={k} launched {dict(_build.FIR_INSTANCES)}")
            y_cpu = cpu(x.cpu(), s.cpu())
            err, scale = max_err(y.cpu(), y_cpu), y_cpu.abs().max().item()
            check(y.shape == (16, 512, 32, 32) and err <= 1e-3 * max(1.0, scale),
                  f"downsample k={k} card vs CPU err {err} (max|out| {scale})")
            xs = (x * conv.modulation(s)[:, :, None, None]).contiguous()
            a1 = upfirdn2d(xs, conv.blur.kernel, pad=conv.blur.pad)
            plain = upfirdn2d_plain(xs, conv.blur.kernel, pad=conv.blur.pad)
            a1_err = max_err(a1, plain)
            check(a1_err <= 1e-5 * plain.abs().max().item(), f"A1 k={k} vs plain err {a1_err}")
            ms = cuda_ms(lambda: conv(x, s))
        print(f"ModulatedConv(downsample=True) k={k} 512 -> 512 ch, 64 -> 32 px, batch 16, fp32: "
              f"{ms:.3f} ms; card vs CPU max abs err {err:.3e} (max|out| {scale:.3e}); A1 on "
              f"its {tuple(xs.shape)} input pad {conv.blur.pad} vs plain {a1_err:.3e} [{smi}]")
    print(f"15b launches: {launches}; kernel A by instance {fir}")
    return launches, fir


def write_vgg16(path, seed):
    """Seeded random VGG16 weights in torchvision's layout
    (features.{i}.weight / bias, and a small classifier that the loaders
    skip)."""
    g = torch.Generator().manual_seed(seed)
    sd, cin = {}, 3
    for i, cout in zip((0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28),
                       (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)):
        sd[f"features.{i}.weight"] = torch.randn((cout, cin, 3, 3), generator=g) / (9 * cin) ** 0.5
        sd[f"features.{i}.bias"] = 0.01 * torch.randn(cout, generator=g)
        cin = cout
    for i in (0, 3, 6):
        sd[f"classifier.{i}.weight"] = torch.randn((4, 4), generator=g)
        sd[f"classifier.{i}.bias"] = torch.randn(4, generator=g)
    torch.save(sd, path)
    return path


def weights_gate_path(dev, smi, work):
    """15c. cli.validate_weights on the card with seeded random files: an
    InceptionV3 state_dict in pytorch-fid's layout, VGG16 in torchvision's
    and the lpips heads (lin{i}.model.1.weight); every stage must pass.
    Then LPIPS with those files, card against CPU at 1e-4 relative at 64 and
    256 px, batch 16, d(x, x) = 0, and ms per batch. Returns the Inception
    file."""
    from diagan_tpu_torch.cli import validate_weights
    from diagan_tpu_torch.eval.inception import InceptionV3, random_init_
    from diagan_tpu_torch.eval.lpips import LPIPS
    from diagan_tpu_torch.ops import _build

    work.mkdir(parents=True, exist_ok=True)
    fid = work / "pt_inception.pth"
    torch.save(random_init_(InceptionV3(device="cpu"), seed=SEED + 15).state_dict(), fid)
    vgg = write_vgg16(work / "vgg16.pth", SEED + 16)
    g = torch.Generator().manual_seed(SEED + 17)
    lins = work / "lpips_lin.pth"
    torch.save({f"lin{i}.model.1.weight": torch.rand((1, c, 1, 1), generator=g)
                for i, c in enumerate((64, 128, 256, 512, 512))}, lins)
    _build.reset_launches()
    t0 = time.perf_counter()
    rc = validate_weights.main(["--inception", str(fid), "--lpips_vgg", str(vgg),
                                "--lpips_lin", str(lins), "--device", dev.type])
    t_gate = time.perf_counter() - t0
    check(rc == 0, "cli.validate_weights failed a stage")
    no_kernel_launched("cli.validate_weights")
    print(f"cli.validate_weights: every stage passed in {t_gate:.2f} s")

    lp, lp_cpu = LPIPS(vgg, lins, device=dev), LPIPS(vgg, lins, device="cpu")
    for size in (64, 256):
        x = torch.rand((16, 3, size, size), generator=g) * 2 - 1
        y = torch.rand((16, 3, size, size), generator=g) * 2 - 1
        xd, yd = x.to(dev), y.to(dev)
        d_card, d_cpu = lp(xd, yd).cpu(), lp_cpu(x, y)
        rel = ((d_card - d_cpu).abs().max() / d_cpu.abs().max()).item()
        check(rel <= 1e-4, f"LPIPS {size} px card vs CPU rel err {rel}")
        check(bool((lp(xd, xd) == 0).all()), f"LPIPS {size} px d(x, x) != 0")
        ms = cuda_ms(lambda: lp(xd, yd), iters=5)
        print(f"LPIPS (VGG16 + heads) batch 16 at {size} px: {ms:.2f} ms per batch; card vs "
              f"CPU rel err {rel:.3e}; d(x, x) = 0 [{smi}]")
    return fid


def index_loader_path(dev, smi, work, fid):
    """15d. data/index_loader.py on phase 10's CelebA (CELEBA_N images,
    celeba_64.npy): get_celeba_images_with_index and get_index_images on
    2,048 indices against the plain CPU gather (bytes), and the featurizer
    on the card on both (features equal)."""
    from diagan_tpu_torch.data.index_loader import get_celeba_images_with_index, get_index_images
    from diagan_tpu_torch.eval.inception import InceptionFeaturizer

    cache = np.load(work / "celeba" / "celeba" / "celeba_64.npy", mmap_mode="r")
    index = np.random.default_rng(SEED + 15).choice(len(cache), 2048, replace=False)
    want = np.ascontiguousarray(cache[index])
    t0 = time.perf_counter()
    got = get_celeba_images_with_index(index, root=work / "celeba", size=64)
    t_load = time.perf_counter() - t0
    check(got.dtype == np.uint8 and got.shape == (2048, 64, 64, 3) and
          got.tobytes() == want.tobytes(), "get_celeba_images_with_index differs from the gather")
    check(get_index_images(cache, index).tobytes() == want.tobytes(),
          "get_index_images differs from the gather")
    feat = InceptionFeaturizer(weights_path=str(fid), batch_size=256, device=dev)
    t0 = time.perf_counter()
    f_got = feat.features(got)
    t_feat = time.perf_counter() - t0
    check(np.array_equal(f_got, feat.features(want)) and np.isfinite(f_got).all(),
          "features of the loaded images differ from the gather's")
    print(f"index_loader on {len(cache)} CelebA images: 2048 by index in {t_load:.2f} s (the "
          f"loader reads the whole cache), equal to the gather; featurized on the card in "
          f"{t_feat:.2f} s, features equal [{smi}]")


# 16. data parallelism --------------------------------------------------------------
DP_WORLD = 2  # 16b: two ranks sharing the one card over gloo
DP_SNGAN_STEPS, DP_FFHQ_STEPS = 10, 4
# 16a's StyleGAN2 runs at 64 px (full width), a depth cut: in fp32 cuDNN's
# deterministic algorithms take 1883 ms a 256 px step
DP_FFHQ_SIZE = 64


def run_state(tr):
    """{name: tensor} of what a training run leaves: a LogTrainer's nets
    (weights, buffers, Adam state, update counts) and logit rows, or a
    StyleGAN2Trainer's G, D, G_ema, both Adams, ADA's p, pl_mean and logit
    rows."""
    out = {}

    def module(name, m):
        out.update({f"{name}.{k}": v for k, v in m.state_dict().items()})

    def adam(name, opt):
        for i, st in enumerate(opt.state.values()):
            out.update({f"{name}.adam{i}.{k}": v for k, v in st.items()})

    if hasattr(tr, "recorder"):
        for name, net in (("g", tr.g), ("d", tr.d), ("d_drs", tr.d_drs)):
            if net is not None:
                module(name, net.module)
                adam(name, net.optim)
                out[f"{name}.counts"] = torch.tensor([net.count, net.step])
        out["logits"] = tr.recorder.buffer[:tr.recorder.count]
        return out
    for name, m in (("g", tr.gen), ("d", tr.disc), ("g_ema", tr.g_ema)):
        module(name, m)
    adam("g", tr.g_optim)
    adam("d", tr.d_optim)
    out["ada_p"] = torch.tensor(tr.ada_aug_p, dtype=torch.float64)
    out["pl_mean"] = tr.pl_mean
    for step, row in tr.logit_results.get("netD_eval", {}).items():
        out[f"logits@{step}"] = torch.from_numpy(row)
    return out


def state_diff(a, b):
    """The names whose tensors differ between two run_state()s (any bit),
    and the largest absolute difference among them."""
    check(a.keys() == b.keys(), f"run states hold different tensors: {set(a) ^ set(b)}")
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    worst = max((max_err(a[k], b[k]) for k in differ), default=0.0)
    return differ, worst


def timed_fused_steps(log):
    """Patch the trainer's make_fused_step so that every fused step appends
    its synchronised seconds to log."""
    from diagan_tpu_torch.train import trainer as TT

    make = TT.make_fused_step

    def timed_make(*args, **kwargs):
        step = make(*args, **kwargs)

        def run(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*a)
            torch.cuda.synchronize()
            log.append(time.perf_counter() - t0)
            return out
        return run
    return mock.patch.object(TT, "make_fused_step", timed_make)


def dp_world1_path(dev, smi, work):
    """16a. --data_parallel at world 1 over NCCL, in process, through the
    CLIs, against the plain run, with cuDNN's deterministic algorithms
    (fp32). Bit for bit (weights, buffers, Adam state, pl_mean, logit rows):
    SNGAN-32 phase 1 at full width on phase 8's 50k files (DP_SNGAN_STEPS
    steps, a sweep at the last) and cli.train_ffhq at DP_FFHQ_SIZE px, full
    width, batch 16, on phase 6's kind of procedural images, without ADA
    (DP_FFHQ_STEPS steps, a sweep at step 2). With ADA
    at a fixed p = 0.3, whose adjoint's atomics make no two runs equal:
    step 0 up to G's first update bit for bit, the state beside a second
    plain run's spread. ms per step with and without the flag. Then
    cli.train_ffhq --data_parallel with adaptive ADA: p moves at the first
    update (256 images) from the all-reduced sign sums, and equals a host
    replay of them. Every training kernel (#1-#7: kernel A's A1-A7, the
    fused act's and the warp's kernels) must launch on the DP FFHQ runs.
    Returns their launches: (by kernel, kernel A's by instance)."""
    import torch.distributed as dist

    from diagan_tpu_torch.cli import train_ffhq, train_mimicry_phase1
    from diagan_tpu_torch.data.synthetic import synthetic_natural
    from diagan_tpu_torch.models.ada import AdaptiveAugment
    from diagan_tpu_torch.ops import _build
    from diagan_tpu_torch.train.stylegan2_trainer import StyleGAN2Trainer

    cifar = work / "sngan" / "cifar10"
    check(cifar.is_dir(), "phase 8's dataset is missing")
    out = work / "dp"
    sngan = ["-r", str(cifar), "--work_dir", str(out), "--device", dev.type, "--batch_size",
             str(SNGAN_BS), "--n_dis", str(SNGAN_NDIS), "--seed", str(SEED),
             "--no_schedule_override", "--num_steps", str(DP_SNGAN_STEPS),
             "--logit_save_steps", str(DP_SNGAN_STEPS), "--save_logit_after",
             str(DP_SNGAN_STEPS), "--stop_save_logit_after", str(DP_SNGAN_STEPS)]
    ffhq = out / "data"
    ffhq.mkdir(parents=True)
    np.save(ffhq / f"ffhq_{DP_FFHQ_SIZE}.npy", synthetic_natural(N_DATA, DP_FFHQ_SIZE, seed=7)[0])
    ffhq_args = ["-d", "ffhq", "-r", str(ffhq), "--size", str(DP_FFHQ_SIZE), "--batch", "16",
                 "--work_dir", str(out), "--seed", str(SEED), "--device", dev.type]
    runs, ms = {}, {}
    # cuDNN's deterministic algorithms (its default algorithms add with
    # atomics, forwards included), in IEEE fp32 as every CLI pins it: fp32's
    # deterministic algorithms are slow (a plain StyleGAN2-256 step 1887.83
    # ms against 183.38 with TF32 convs, an H100 80GB HBM3 at 700 W)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        for flag in ("", "--data_parallel"):
            steps = []
            with timed_fused_steps(steps):
                tr = train_mimicry_phase1.main(sngan + ["--exp_name", f"sngan{flag}"]
                                               + [flag] * bool(flag))
            check((tr.dp is not None) == bool(flag), "--data_parallel did not reach the trainer")
            runs["sngan" + flag] = run_state(tr), tr.dp
            ms["sngan" + flag] = 1e3 * sum(steps[1:]) / len(steps[1:])
        dp = runs["sngan--data_parallel"][1]
        check((dp.rank, dp.world, dp.backend) == (0, 1, "nccl" if dev.type == "cuda" else "gloo"),
              f"--data_parallel formed {dp}, not a world of one over NCCL")
        differ, worst = state_diff(runs["sngan"][0], runs["sngan--data_parallel"][0])
        check(not differ, f"SNGAN-32 --data_parallel differs from the plain run in {len(differ)} "
                          f"tensors (max abs {worst:.3e}), e.g. {differ[:4]}")
        sngan_bytes = dp.bytes_all_reduced
        pkl = [(out / name / "logits_netD_eval.pkl").read_bytes()
               for name in ("sngan", "sngan--data_parallel")]
        check(pkl[0] == pkl[1], "the logit pickles differ")
        print(f"16a SNGAN-32 phase 1 (ngf 256, ndf 128, batch {SNGAN_BS}, n_dis {SNGAN_NDIS}, "
              f"{DP_SNGAN_STEPS} steps, a sweep of {SNGAN_N} at step {DP_SNGAN_STEPS}): "
              f"--data_parallel (world 1, NCCL) equals the plain run bit for bit in "
              f"{len(runs['sngan'][0])} tensors and the logit pickle; ms per step (steps 2-"
              f"{DP_SNGAN_STEPS}, synchronised, host clock; cuDNN deterministic, fp32) "
              f"plain {ms['sngan']:.2f}, "
              f"--data_parallel {ms['sngan--data_parallel']:.2f}; "
              f"{sngan_bytes / DP_SNGAN_STEPS / 1e6:.3f} MB all-reduced per step (the sweep's "
              f"row and the logged metrics included) [{smi}]")
        del runs

        launches, fir = {}, {}

        def ffhq_run(name, flags):
            """cli.train_ffhq, DP_FFHQ_STEPS steps with a sweep at step 2:
            (run_state, group, [(synchronised ms, metrics)] by step)."""
            log = []
            train_step = StyleGAN2Trainer.train_step

            def step(self, s):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = train_step(self, s)
                torch.cuda.synchronize()
                log.append((1e3 * (time.perf_counter() - t0), {k: float(v) for k, v in m.items()}))
                return m
            _build.reset_launches()
            with mock.patch.object(StyleGAN2Trainer, "train_step", step):
                tr = train_ffhq.main(ffhq_args + [
                    "--exp_name", name, "--iter", str(DP_FFHQ_STEPS), "--logit_save_steps", "2",
                    "--save_logit_after", "0"] + flags)
            torch.cuda.synchronize()
            dp_run = "--data_parallel" in flags
            check((tr.dp is not None) == dp_run, "--data_parallel did not reach the trainer")
            if dp_run:
                launches[name], fir[name] = dict(_build.LAUNCHES), fir_launches(name)
            return run_state(tr), tr.dp, log

        def per_step_ms(log):  # steps 2..: no R1 or path step
            return sum(ms for ms, _ in log[1:]) / len(log[1:])

        # without ADA every kernel on the path sums in a fixed order: bit for bit
        plain = ffhq_run("ffhq", [])
        dp_run = ffhq_run("ffhq_dp", ["--data_parallel"])
        differ, worst = state_diff(plain[0], dp_run[0])
        check(not differ, f"StyleGAN2-{DP_FFHQ_SIZE} --data_parallel differs from the plain "
                          f"run in {len(differ)} tensors (max abs {worst:.3e}), e.g. {differ[:4]}")
        print(f"16a cli.train_ffhq {DP_FFHQ_SIZE} px (full width, batch 16, no ADA, "
              f"{DP_FFHQ_STEPS} steps, a sweep of {N_DATA} at step 2): --data_parallel (world 1, "
              f"NCCL) equals the plain run bit for bit in {len(plain[0])} tensors; ms per step "
              f"(steps 2-{DP_FFHQ_STEPS}, synchronised, host clock; cuDNN deterministic, fp32) "
              f"plain {per_step_ms(plain[2]):.2f}, --data_parallel {per_step_ms(dp_run[2]):.2f} "
              f"[{smi}]")
        # ADA at p = 0.3: the adjoint's clamped pass adds with atomics in a
        # run-dependent order, and Adam turns that round-off into steps of
        # lr, so no two runs agree bit for bit. The DP run is held to step
        # 0's values up to G's first update (D's loss and scores, the sign
        # sum, R1, G's loss) bit for bit, and differs only where a second
        # plain run differs too
        ada = ["--augment", "--augment_p", "0.3"]
        plain = ffhq_run("ffhq_ada", ada)
        dp_run = ffhq_run("ffhq_ada_dp", ada + ["--data_parallel"])
        again = ffhq_run("ffhq_ada_again", ada)
        differ, worst = state_diff(plain[0], dp_run[0])
        spread = state_diff(plain[0], again[0])
        first = ("d", "real_score", "fake_score", "sign_real", "r1", "g")
        check(all(plain[2][0][1][k] == dp_run[2][0][1][k] == again[2][0][1][k] for k in first),
              f"ADA p=0.3: step 0 differs before G's first update: plain {plain[2][0][1]}, "
              f"--data_parallel {dp_run[2][0][1]}, plain again {again[2][0][1]}")
        check(not differ or spread[0], f"ADA p=0.3: --data_parallel differs from a plain run "
                                       f"that repeats itself bit for bit, in {len(differ)} tensors")
        ffhq_ms = per_step_ms(plain[2]), per_step_ms(dp_run[2])
        dp = dp_run[1]
        print(f"16a cli.train_ffhq {DP_FFHQ_SIZE} px (full width, batch 16, ADA p=0.3, "
              f"{DP_FFHQ_STEPS} "
              f"steps, a sweep of {N_DATA} at step 2), --data_parallel (world 1, NCCL): step "
              f"0's {', '.join(first)} equal to the plain run's bit for bit; {len(differ)} of "
              f"{len(plain[0])} tensors differ from the plain run (max abs {worst:.3e}), as "
              f"{len(spread[0])} differ between two plain runs (max abs {spread[1]:.3e}); ms per "
              f"step (steps 2-{DP_FFHQ_STEPS}: no R1 or path step; synchronised, host clock; "
              f"cuDNN deterministic, fp32) plain {ffhq_ms[0]:.2f}, --data_parallel "
              f"{ffhq_ms[1]:.2f} ({100 * (ffhq_ms[1] / ffhq_ms[0] - 1):+.2f}%), a second plain "
              f"run {per_step_ms(again[2]):.2f}; {dp.bytes_all_reduced / DP_FFHQ_STEPS / 1e6:.3f} "
              f"MB all-reduced per step [{smi}]")
        del plain, dp_run, again, dp

    # adaptive ADA: a target below every r_t, so p rises at each update (every
    # 256 images), from the all-reduced sign sums
    tunes = []
    tune = StyleGAN2Trainer.tune_ada

    def recording_tune(self, metrics):
        tune(self, metrics)
        tunes.append((float(metrics["sign_real"]), self.batch_size * self.world, self.ada_aug_p))

    steps = 17
    _build.reset_launches()
    with mock.patch.object(StyleGAN2Trainer, "tune_ada", recording_tune):
        tr = train_ffhq.main(ffhq_args + [
            "--exp_name", "ffhq_adaptive", "--augment", "--augment_p", "0", "--ada_target", "-1",
            "--ada_length",
            "2000", "--iter", str(steps), "--logit_save_steps", "0", "--data_parallel"])
    torch.cuda.synchronize()
    launches["ffhq_adaptive"], fir["ffhq_adaptive"] = dict(_build.LAUNCHES), fir_launches(
        "ffhq_adaptive")
    replay = AdaptiveAugment(-1.0, 2000)
    want = [replay.tune(s, n) for s, n, _ in tunes]
    check(len(tunes) == steps and [p for *_, p in tunes] == want and tr.ada_aug_p == want[-1] > 0
          and tunes[15][2] > 0 == tunes[14][2] and replay.r_t_stat == tr.ada.r_t_stat,
          f"adaptive ADA's p {[p for *_, p in tunes]} against the replay {want}")
    print(f"16a cli.train_ffhq {DP_FFHQ_SIZE} px --data_parallel, adaptive ADA ({steps} steps, "
          f"batch 16, target -1, "
          f"length 2000): the all-reduced sign sums {[s for s, *_ in tunes]} over counts of "
          f"{tunes[0][1]}; r_t {tr.ada.r_t_stat:.4f}; p 0 -> {tr.ada_aug_p:.4f} at the update "
          f"after step 16, equal to the host replay; metrics "
          f"{finite_metrics(tr, ('d', 'g', 'r1', 'path'))}")
    del tr

    total = {k: sum(run[k] for run in launches.values()) for k in _build.LAUNCHES}
    fir_total = {i: sum(run[i] for run in fir.values()) for i in _build.FIR_INSTANCES}
    check(all(launches["ffhq_ada_dp"][k] > 0 for k in FLAG_KERNELS) and
          all(total[k] == 0 for k in WARP2), f"DP FFHQ launches {launches}")
    a1_a7 = ("fir4x4", "fir4x4_up2", "fir4x4_down2", "fir12y_up2", "fir12y_down2",
             "fir12x_up2", "fir12x_down2")
    check(all(fir["ffhq_ada_dp"][i] > 0 for i in a1_a7), f"DP FFHQ kernel A instances {fir}")
    print(f"16a launches on the DP FFHQ runs: {launches}; kernel A by instance {fir}")
    dist.destroy_process_group()  # the world of one; 16b's ranks form their own group
    return total, fir_total


def dp_rank_sngan(dp, dev, cifar, run_dir):
    """16b, on one rank: SNGAN-32 at full width, global batch SNGAN_BS, 4
    steps through LogTrainer, then one sharded eval sweep of the 50k and, on
    rank 0, the same sweep in one process. Returns what the parent compares."""
    import hashlib

    from diagan_tpu_torch.data.predefined import get_predefined_dataset
    from diagan_tpu_torch.models.registry import get_gan_model
    from diagan_tpu_torch.train import state as TS
    from diagan_tpu_torch.train.logit_recorder import LogitRecorder
    from diagan_tpu_torch.train.trainer import LogTrainer

    first = []
    reduce = TS.all_reduce_grads_

    def recording_reduce(module, group):  # D's first update: its grads before and after
        local = [p.grad.detach().clone() for p in module.parameters() if p.grad is not None]
        reduce(module, group)
        if not first:
            first.append((torch.cat([g.flatten() for g in local]).cpu(),
                          torch.cat([p.grad.flatten() for p in module.parameters()
                                     if p.grad is not None]).cpu()))

    steps = []
    bundle = get_gan_model("cifar10", model="sngan", loss_type="hinge", device=dev)
    ds = get_predefined_dataset("cifar10", root=str(cifar))
    with mock.patch.object(TS, "all_reduce_grads_", recording_reduce), timed_fused_steps(steps):
        tr = LogTrainer(output_path=run_dir / "sngan", bundle=bundle, dataset=ds, num_steps=4,
                        n_dis=SNGAN_NDIS, batch_size=SNGAN_BS, save_logits=False, seed=SEED,
                        device=dev, data_parallel=dp)
        tr.train()
    bytes_train = dp.bytes_all_reduced
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    row = tr.recorder.sweep(tr.d.module, tr.source)
    torch.cuda.synchronize()
    t_sweep = time.perf_counter() - t0
    out = {"hash": {k: hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest()
                    for k, v in run_state(tr).items() if k != "logits"},
           "grads": first[0], "row": row.cpu(), "steps_ms": [1e3 * s for s in steps],
           "bytes_per_step": bytes_train / 4, "sweep_s": t_sweep}
    if dp.rank == 0:
        out["single_row"] = LogitRecorder(len(ds), 2, device=dev).sweep(tr.d.module,
                                                                        tr.source).cpu()
    dp.barrier()
    return out


def dp_rank_stylegan2(dp, dev, ffhq, run_dir):
    """16b, on one rank: StyleGAN2-SIZE at full width through
    StyleGAN2Trainer, batch 4 per rank, 2 steps, adaptive ADA updating every
    8 images (one update a step). Returns hashes of its state, and each
    step's local and all-reduced sign sums and p."""
    import hashlib

    from diagan_tpu_torch.models.stylegan2 import StyleGAN2Discriminator, StyleGAN2Generator
    from diagan_tpu_torch.train.stylegan2_trainer import StyleGAN2Trainer

    torch.manual_seed(SEED + dp.rank)  # different inits: the broadcast makes them rank 0's
    g = StyleGAN2Generator(SIZE, STYLE_DIM, N_MLP, CH_MULT, device=dev)
    d = StyleGAN2Discriminator(SIZE, CH_MULT, device=dev)
    images = np.load(ffhq / f"ffhq_{SIZE}.npy", mmap_mode="r")
    tr = StyleGAN2Trainer(run_dir / "stylegan2", g, d, images, num_steps=2, batch_size=4,
                          augment_p=0, ada_length=2000, seed=SEED, device=dev, data_parallel=dp)
    tr.ada.update_every = 4 * dp.world
    signs, steps = [], []
    tune = tr.tune_ada

    def recording_tune(metrics):
        local = float(metrics["sign_real"])
        tune(metrics)
        signs.append((local, float(metrics["sign_real"]), tr.ada_aug_p))
    tr.tune_ada = recording_tune
    reduced = dp.bytes_all_reduced  # the SNGAN case's
    with timed(StyleGAN2Trainer, "train_step", steps):
        tr.train()
    out = {"hash": {k: hashlib.sha256(v.detach().cpu().numpy().tobytes()).hexdigest()
                    for k, v in run_state(tr).items() if k != "pl_mean"},
           "signs": signs, "steps_ms": [1e3 * s for _, s in steps],
           "bytes_per_step": (dp.bytes_all_reduced - reduced) / 2, "r_t": tr.ada.r_t_stat}
    dp.barrier()
    return out


def dp_worker(run_dir, rank):
    """One of 16b's ranks (chip_smoke.py --dp-worker DIR RANK): joins the
    gloo group through DIR/store, runs dp_rank_sngan and dp_rank_stylegan2
    on the card and writes their results to DIR/rank{RANK}.pt."""
    import torch.distributed as dist

    from diagan_tpu_torch.device import pin_fp32_precision
    from diagan_tpu_torch.parallel import init_data_parallel

    pin_fp32_precision()
    run_dir = Path(run_dir)
    work = run_dir.parent
    dist.init_process_group("gloo", init_method=f"file://{run_dir / 'store'}", rank=rank,
                            world_size=DP_WORLD)
    try:
        dp = init_data_parallel("cuda", backend="gloo")
        check((dp.rank, dp.world, dp.backend) == (rank, DP_WORLD, "gloo"), f"group {dp}")
        out = {"sngan": dp_rank_sngan(dp, dp.device, work / "sngan" / "cifar10", run_dir),
               "stylegan2": dp_rank_stylegan2(dp, dp.device, work / "train" / "data", run_dir)}
        torch.save(out, run_dir / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


def dp_world2_path(smi, work, timeout=400):
    """16b. Two ranks over gloo on the one card, two processes: SNGAN-32 at
    full width, global batch 64 (32 a rank), 4 steps, then a sharded eval
    sweep of the 50k: both ranks' weights, BatchNorm buffers and Adam state
    bit for bit, the sharded row equal to the one-process row bit for bit,
    and D's first all-reduced gradient equal to the mean of the two ranks'
    gradients computed apart (a + b rounds the same in either order, and
    halving is exact); StyleGAN2-SIZE at batch 4 a rank, 2 steps, adaptive
    ADA: the states and p equal on both ranks, the sign sum of each step the
    sum of the ranks'. Not a speed claim: gloo stages CUDA tensors through
    the host."""
    from diagan_tpu_torch.models.ada import AdaptiveAugment

    run_dir = work / "dp2"
    run_dir.mkdir()
    t0 = time.perf_counter()
    logs = [open(run_dir / f"rank{r}.log", "w") for r in range(DP_WORLD)]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dp-worker",
                               str(run_dir), str(r)], cwd=ROOT, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(DP_WORLD)]
    try:
        rcs = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    for r, rc in enumerate(rcs):
        if rc:
            print((run_dir / f"rank{r}.log").read_text()[-6000:])
        check(rc == 0, f"16b rank {r} exited {rc}")
    outs = [torch.load(run_dir / f"rank{r}.pt", weights_only=False) for r in range(DP_WORLD)]

    s = [o["sngan"] for o in outs]
    check(s[0]["hash"] == s[1]["hash"], "16b SNGAN: the ranks' states differ: " + str(
        [k for k in s[0]["hash"] if s[0]["hash"][k] != s[1]["hash"].get(k)][:6]))
    check(torch.equal(s[0]["row"], s[1]["row"]) and torch.equal(s[0]["row"], s[0]["single_row"]),
          f"16b the sharded sweep differs from the one-process sweep by "
          f"{max_err(s[0]['row'], s[0]['single_row']):.3e}")
    (l0, a0), (l1, a1) = s[0]["grads"], s[1]["grads"]
    check(torch.equal(a0, a1) and torch.equal(a0, (l0 + l1) / 2),
          f"16b D's first all-reduced gradient against the mean of the ranks': "
          f"{max_err(a0, (l0 + l1) / 2):.3e}")
    print(f"16b SNGAN-32 over gloo, 2 ranks on one card (global batch {SNGAN_BS}, "
          f"{SNGAN_BS // DP_WORLD} a rank, n_dis {SNGAN_NDIS}, 4 steps): {len(s[0]['hash'])} "
          f"tensors (weights, BatchNorm "
          f"buffers, Adam state, counts) bit for bit on both ranks; D's first all-reduced "
          f"gradient ({l0.numel()} values) equals the mean of the ranks' own bit for bit "
          f"(ranks' gradients differ by {max_err(l0, l1):.3e}); the sharded eval sweep of "
          f"{SNGAN_N} equals the one-process sweep bit for bit; ms per step (steps 2-4) "
          f"{[round(sum(o['steps_ms'][1:]) / 3, 2) for o in s]} by rank, sharded sweep "
          f"{[round(o['sweep_s'], 3) for o in s]} s by rank; "
          f"{s[0]['bytes_per_step'] / 1e6:.3f} MB all-reduced per step [{smi}]")

    g = [o["stylegan2"] for o in outs]
    check(g[0]["hash"] == g[1]["hash"], "16b StyleGAN2: the ranks' states differ: " + str(
        [k for k in g[0]["hash"] if g[0]["hash"][k] != g[1]["hash"].get(k)][:6]))
    replay = AdaptiveAugment(0.6, 2000, update_every=4 * DP_WORLD)
    for (l0, s0, p0), (l1, s1, p1) in zip(g[0]["signs"], g[1]["signs"]):
        check(s0 == s1 == l0 + l1 and p0 == p1 == replay.tune(s0, 4 * DP_WORLD),
              f"16b StyleGAN2 signs and p by rank {g[0]['signs']} {g[1]['signs']}")
    check(len(g[0]["signs"]) == 2 and g[0]["r_t"] == g[1]["r_t"] == replay.r_t_stat,
          "16b StyleGAN2 ADA's r_t")
    print(f"16b StyleGAN2-{SIZE} over gloo, 2 ranks on one card (batch 4 a rank, 2 steps, "
          f"adaptive ADA updating every 8 images): {len(g[0]['hash'])} tensors (G, D, G_ema, "
          f"both Adams, p, logit rows) bit for bit on both ranks; (local sign sums, their "
          f"all-reduced sum, p) by step: rank 0 {g[0]['signs']}, rank 1 {g[1]['signs']}; the "
          f"sum is the ranks' and p the host replay's on both; ms per step "
          f"{[[round(t, 2) for t in o['steps_ms']] for o in g]} by rank; "
          f"{g[0]['bytes_per_step'] / 1e6:.3f} MB all-reduced per step; the two processes "
          f"took {wall:.2f} s in all, start-up included [{smi}]")


# the toy protocol at the JAX script's settings (scripts/smoke_toy.py), and the
# JAX package's own hardware run of it, seed 1 (docs/VALIDATION.md:201-215)
TOY = {"num_steps": 8000, "num_data": 10000, "batch_size": 256, "seed": 1}
TOY_JAX = {"phase1": (24, 0.379), "phase2": (20, 0.678), "phase2+DRS": (20, 0.799)}


def fp32_errors(dev):
    """A 3x3 conv (16 x 128 x 64 x 64) and a 1024^2 matmul on the card, each
    against float64 of the same inputs: max abs err / max|float64 out|. IEEE
    fp32 reads ~1e-7-1e-6, TF32 (10-bit mantissa products) ~1e-3."""
    g = torch.Generator(dev).manual_seed(SEED + 17)
    x = torch.randn((16, 128, 64, 64), generator=g, device=dev)
    w = torch.randn((128, 128, 3, 3), generator=g, device=dev) / math.sqrt(128 * 9)
    a, b = (torch.randn((1024, 1024), generator=g, device=dev) for _ in range(2))

    def rel(got, want):
        return ((got.double() - want).abs().max() / want.abs().max()).item()
    conv = torch.nn.functional.conv2d
    return (rel(conv(x, w, padding=1), conv(x.double(), w.double(), padding=1)),
            rel(a @ b, a.double() @ b.double()))


def toy_protocol_path(dev, smi, work):
    """17. cli.smoke_toy, the 25-Gaussians two-phase protocol at the JAX
    script's settings (8000 phase-1 steps with 41 eval sweeps of the 10,000
    points over 4000-8000, ldrv weights, 4000 phase-2 steps with the twin D
    from phase 1's files, DRS at batch 256; the toy MLPs at their width of
    256, seed 1): each step's files, the weights finite with mean > 0, the
    three coverage pairs well formed, DRS accepting; no port kernel may
    launch. Quality is not gated: torch's draws are not the JAX package's,
    so the coverage lines are printed beside its hardware run's. The CLI is
    entered with TF32 switched on: after it returns, a conv and a matmul
    must agree with float64 within 1e-5 (TF32 reads ~1e-3), both errors
    printed beside the ones taken with TF32 on."""
    from diagan_tpu_torch.cli import smoke_toy
    from diagan_tpu_torch.eval.drs import DRS
    from diagan_tpu_torch.ops import _build
    from diagan_tpu_torch.train.logit_recorder import LogitRecorder
    from diagan_tpu_torch.train.steps import step_draws
    from diagan_tpu_torch.train.trainer import LogTrainer

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    tf32 = fp32_errors(dev)
    n1 = TOY["num_steps"]
    n2 = n1 + n1 // 2
    trains, scores, warms, draws, sweeps = [], [], [], [], []
    _build.reset_launches()
    t0 = time.perf_counter()
    with timed(LogTrainer, "train", trains), timed(smoke_toy, "load_phase1_scores", scores), \
            timed(DRS, "init_drs", warms), timed(DRS, "generate_images", draws), \
            timed(LogitRecorder, "sweep", sweeps):
        run = smoke_toy.main(["--device", dev.type, "--work_dir", str(work)]
                             + [f"--{k}={v}" for k, v in TOY.items()])
    wall = time.perf_counter() - t0
    pinned = fp32_errors(dev)
    check(not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32),
          "cli.smoke_toy left TF32 on")
    check(max(pinned) <= 1e-5, f"after a CLI main, conv / matmul against float64 {pinned}: "
                               f"not IEEE fp32 (tol 1e-5)")
    no_kernel_launched("cli.smoke_toy")

    out = work / "toy25"
    for path in [out / f"checkpoints/{n}/{n}_{n1}_steps.pth" for n in ("netG", "netD")] + \
            [out / f"phase2/checkpoints/{n}/{n}_{n2}_steps.pth"
             for n in ("netG", "netD", "netD_drs")]:
        check(path.is_file(), f"no {path.relative_to(work)}")
    check_logits(out / "logits_netD_eval.pkl", list(range(n1 // 2, n1 + 1, 100)),
                 TOY["num_data"])
    w = run["weights"]
    check(w.shape == (TOY["num_data"],) and bool(np.isfinite(w).all()) and w.mean() > 0,
          f"phase-2 weights: shape {w.shape}, mean {w.mean()}")
    cov = run["coverage"]
    check(list(cov) == list(TOY_JAX) and all(
        type(m) is int and 0 <= m <= 25 and 0.0 <= f <= 1.0 for m, f in cov.values()),
        f"coverage {cov}")
    tr1, tr2 = run["trainers"]
    drs = run["drs"]
    check((tr1.global_step, tr2.global_step) == (n1, n2) and drs.accepted > 0,
          f"steps {tr1.global_step}, {tr2.global_step}; DRS accepted {drs.accepted}")
    finite_metrics(tr2, ("errD", "errG"))

    (_, t1), (_, t2) = trains
    t_sweeps = sum(t for _, t in sweeps)
    t_scores, t_warm, t_draw = scores[0][1], warms[0][1], draws[0][1]
    print(f"cli.smoke_toy (25-Gaussians, {TOY}), wall {wall:.2f} s: phase 1 {t1:.2f} s "
          f"({n1} steps, {n1 / t1:.2f} steps/s; {len(sweeps)} sweeps of {TOY['num_data']} "
          f"points {t_sweeps:.2f} s, without them {n1 / (t1 - t_sweeps):.2f} steps/s); ldrv "
          f"weights {t_scores:.3f} s (mean {w.mean():.4f}, max {w.max():.4f}); phase 2 "
          f"{t2:.2f} s ({n2 - n1} steps with the twin D, {(n2 - n1) / t2:.2f} steps/s); DRS "
          f"warm-up 50 x 256 {t_warm:.3f} s, 5000 accepted of {drs.proposed} proposed "
          f"(acceptance {drs.accepted / drs.proposed:.4f}) in {t_draw:.3f} s [{smi}]")
    for name, (m, f) in cov.items():
        jm, jf = TOY_JAX[name]
        print(f"  {name}: {m}/25 modes, {f:.3f} high-quality (the JAX package's hardware run, "
              f"seed 1: {jm}/25, {jf:.3f})")
    print(f"precision after cli.smoke_toy returned: conv 16x128x64x64 3x3 rel err "
          f"{pinned[0]:.3e}, matmul 1024^2 {pinned[1]:.3e} against float64 (tol 1e-5); with "
          f"TF32 on before it: {tf32[0]:.3e}, {tf32[1]:.3e} [{smi}]")
    profile(lambda: tr2.fused_step(n2, step_draws(TOY["seed"], n2, dev)),
            "one toy phase-2 step (batch 256, twin D)", smi, ())


# --- 18. the headline benchmark ----------------------------------------------
# cli.bench's counts cut in depth (the CLI's: 50 + 200 SNGAN steps, a DRS
# quota of 50,000); its widths, batches and StyleGAN2 windows as they are
BENCH_CUTS = {"sngan_warm": 5, "sngan_timed": 25, "drs_quota": 5000}
ADA_FIR = ("fir12y_up2", "fir12x_up2", "fir12y_down2", "fir12x_down2")  # A4-A7
POLY_FIR = ("fir6x6", "fir6y")  # the polyphase resample's instances (opt-in)


def add_launches(kernels, run):
    """One path's launches (cli.bench.launches()) joined to the kernels
    line's rows: the bf16 rows take those on bf16 tensors, the others the
    rest."""
    bf16 = run["bf16"]
    for k in kernels:
        name = k["name"]
        if name in run["kernels"]:
            k["launches"] += run["kernels"][name] - bf16.get(name, 0)
        elif name.startswith("upfirdn2d/"):
            inst = name.split("/", 1)[1]
            k["launches"] += run["fir"].get(inst, 0) - bf16.get(f"upfirdn2d/{inst}", 0)
        elif name.startswith("upfirdn2d_bf16/"):
            k["launches"] += bf16.get("upfirdn2d/" + name.split("/", 1)[1], 0)
        elif name.endswith("_bf16"):
            k["launches"] += bf16.get(name[:-len("_bf16")], 0)


def bench_path(dev, smi, work, kernels):
    """18. cli.bench's headline function at full width with its counts cut
    (BENCH_CUTS): SNGAN-32 steps/s and MFU, DRS accepted/s, StyleGAN2-256
    bf16 at ADA p 0 and 0.05 over global steps 25-49, and both FLOP counts;
    its line printed on a line of its own. Checks: every number finite and >
    0, each MFU in (0, 100]; the FLOP counts within 10% of XLA's counts of
    the JAX programs (cli.bench's JAX_SNGAN_GFLOP, at most 10% above it;
    JAX_SG2_GFLOP, either side); the port's kernel launches of each part:
    none on SNGAN or DRS; at p = 0 kernel A's bf16 A1-A3 and the fused act's
    three kernels, no warp kernel and no ADA instance; at p = 0.05 also the
    interleaved warp pair and A4-A7; never the two-phase pair, the polyphase
    instances or the generic one. The launches join the kernels line."""
    from diagan_tpu_torch.cli import bench

    card = bench.card_info()
    check(f"{card['name']}, {card['power_limit']}" == smi, f"card {card} against {smi}")
    t0 = time.perf_counter()
    out, runs = bench.headline(dev, card, **BENCH_CUTS)
    wall = time.perf_counter() - t0
    print(f"cli.bench line (counts cut {BENCH_CUTS}): {json.dumps(out)}")
    for k, v in out.items():
        check(k in ("metric", "unit", "device", "precision") or (
            isinstance(v, float) and math.isfinite(v) and v > 0), f"bench {k}: {v}")
    check(0 < out["mfu_pct"] <= 100 and 0 < out["sg2_256_mfu_pct"] <= 100,
          f"MFU {out['mfu_pct']}, {out['sg2_256_mfu_pct']}")
    sngan_ratio = out["flops_per_step"] / bench.JAX_SNGAN_GFLOP
    sg2_ratio = out["sg2_256_gflop_per_step"] / bench.JAX_SG2_GFLOP
    check(1.0 <= sngan_ratio <= 1.1 and 0.9 <= sg2_ratio <= 1.1,
          f"FLOP counts against XLA's: SNGAN {sngan_ratio}, StyleGAN2 {sg2_ratio}")
    for part in ("sngan", "drs"):
        check(not any(runs[part].values()), f"bench {part} launched port kernels {runs[part]}")
    for p, warp in ((0.0, False), (bench.SG2_ADA_P, True)):
        run = runs[f"sg2 p={p}"]
        ks, fir, bf16 = run["kernels"], run["fir"], run["bf16"]
        check(all(ks.get(k, 0) > 0 for k in BF16_FLR + ("upfirdn2d", "upfirdn2d_backward")) and
              all(bf16.get(f"upfirdn2d/{i}", 0) > 0 for i in BF16_FIR) and
              all(bf16.get(k, 0) > 0 for k in BF16_FLR), f"bench sg2 p={p} launches {run}")
        check(all((ks.get(k, 0) > 0) == warp for k in WARP) and
              all((fir.get(i, 0) > 0) == warp for i in ADA_FIR), f"bench sg2 p={p} ADA {run}")
        check(not any(ks.get(k, 0) for k in WARP2) and
              not any(fir.get(i, 0) for i in POLY_FIR + ("generic",)),
              f"bench sg2 p={p} launched the polyphase or generic kernels: {run}")
        add_launches(kernels, run)
    print(f"cli.bench launches by part: {json.dumps(runs)}")
    print(f"cli.bench wall {wall:.2f} s [{smi}]")


def bench_profiles(dev, smi, work, steps):
    """18b. A profile of the bench's StyleGAN2-256 bf16 global steps `steps`
    (ADA p 0) on a fresh bench trainer after 3 steps, apart from the timed
    windows. The profiler's host cost lengthens the wall time it reports, so
    a host-bound loop's idle share reads high: its device busy time a step
    beside the timed window's wall is the truer one."""
    from diagan_tpu_torch.cli import bench

    tr = bench.sg2_trainer(dev, work / "bench_sg2")
    tr.ada_aug_p = 0.0
    for step in range(3):
        tr.train_step(step)
    profile(lambda: [tr.train_step(s) for s in steps],
            f"bench StyleGAN2-256 steps {steps.start}-{steps.stop - 1} (bf16, batch 16, ADA p "
            f"0; {[bench.step_kind(tr, s) for s in steps]})", smi,
            (*FIR_TAGS, "flr_", "implicit_convolve_sgemm", "nchwToNhwc", "nhwcToNchw"))
    del tr

SG3_BATCH = 64  # the proposal batch of the sg3t_256.drs cell


def ptx_body(ptx, dropped_param=None):
    """The instructions of a Triton kernel's PTX: its .entry body without
    debug lines (.loc, .file, comments, $L__tmp / $L__func labels), with the
    parameter numbered `dropped_param` left out of the numbering of those
    after it (a parameter the other build does not have)."""
    lines = ptx.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith(".visible .entry")
                 or ln.startswith(".entry"))
    start = next(i for i in range(start, len(lines)) if lines[i].strip() == "{")
    end = next(i for i in range(start, len(lines)) if lines[i].strip() == "}")

    def renumber(m):
        k = int(m.group(1))
        return f"_param_{k - 1 if dropped_param is not None and k > dropped_param else k}"

    out = []
    for ln in lines[start + 1:end]:
        t = ln.strip()
        if not t or t.startswith((".loc", ".file", "//")) or re.match(r"\$L__(tmp|func)", t):
            continue
        out.append(re.sub(r"_param_(\d+)", renumber, t))
    return out


def flr_fwd_ptx(module, dev, clamp_arg):
    """The PTX of `module`'s flr_fwd (an ops/fused_act.py) built with every
    flag off, from one launch on a small map."""
    x = torch.zeros((2, 4, 8, 8), device=dev)
    b = torch.zeros(4, device=dev)
    y = torch.empty_like(x)
    flr_fwd = module._kernels()[0]
    args = [x, b, y, x, x, x, x.numel(), 64, 4, 0.2, math.sqrt(2.0)]
    flags = {"STYLED": False}
    if clamp_arg:
        args.append(0.0)
        flags["CLAMP"] = False
    k = flr_fwd[(1,)](*args, **flags, BLOCK=1024, num_warps=4)
    torch.cuda.synchronize()
    return k.asm["ptx"]


def stylegan3_kernels(dev, smi, against=(), fir_against=None):
    """3e. StyleGAN3-T's kernels at the sg3t_256.drs cell's shapes (batch 64,
    full channels), layer by layer on the 256 px schedule: kernel A against
    upfirdn2d_plain on each layer's four passes (x and y up, x and y down:
    the fir12 instances at up 2, the fir24x_up4 / fir24y_up4 pair at up 4,
    the crops of L3, L5, L7, L10 and L13), each launching the instance
    fir_instance names and timed (eager, CUDA events) against its bytes
    bound; flr_fwd's CLAMP build (clamped_leaky_relu) on each activation,
    bit for bit against its plain version, once more on a forced input that
    the clamp binds; with ROOTs (--against), the CLAMP-off build's PTX against
    ROOT's flr_fwd, instruction for instruction, and ROOT's kernel A
    (`fir_against`: against_fir of each ROOT, built here when None) on every
    pass: the same bits, and timed in turns with this tree's (this, ROOT,
    ROOT, this), on the generic instance where ROOT has no up-4 pair. Then
    the StyleGAN3-T DRS path (stylegan3_drs_launches). Plain versions run in
    blocks of 8 images. Writes chiprun_out/stylegan3_kernels.json."""
    import importlib.util
    import inspect

    import torch.nn.functional as F

    from diagan_tpu_torch.models.stylegan3 import SynthesisLayer, synthesis_schedule
    from diagan_tpu_torch.ops import _build, fused_act, upfirdn2d, upfirdn2d_plain
    from diagan_tpu_torch.ops.upfirdn2d import fir_instance

    if fir_against is None:
        fir_against = [against_fir(root, f"-{i}") for i, root in enumerate(against)]
    for root in against:
        spec = importlib.util.spec_from_file_location(
            "against_fused_act", Path(root) / "diagan_tpu_torch" / "ops" / "fused_act.py")
        other = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(other)
        # a ROOT from before the CLAMP build has no `clamp` argument
        has_clamp = "clamp" in inspect.signature(other._kernels()[0].fn).parameters
        ours, theirs = flr_fwd_ptx(fused_act, dev, True), flr_fwd_ptx(other, dev, has_clamp)
        params = len(re.findall(r"\.param ", ours[:ours.index("{")]))
        # this tree's `clamp` follows `scale`, the eleventh parameter (0-based 11)
        a, b = ptx_body(ours, dropped_param=None if has_clamp else 11), ptx_body(theirs)
        check(a == b, f"flr_fwd with CLAMP off differs from {root}'s PTX "
                      f"({len(a)} against {len(b)} instructions)")
        print(f"flr_fwd, CLAMP and STYLED off: the PTX of {root} instruction for instruction "
              f"({len(a)} lines, parameters aside; {params} parameters here)")
    rng = torch.Generator(dev).manual_seed(SEED + 30)
    n, rows, worst = SG3_BATCH, [], 0.0
    t_start = time.perf_counter()
    for spec in synthesis_schedule()[1][:-1]:
        layer = SynthesisLayer(spec, device=dev)
        up, down, (px0, px1) = spec["up"], spec["down"], spec["padding"][:2]
        s0, c = spec["in_size"] + spec["conv_kernel"] - 1, spec["out_channels"]
        x = torch.randn((n, c, s0, s0), generator=rng, device=dev)
        fu, fd = layer.up_filter * up, layer.down_filter
        passes = [("up x", fu.reshape(1, -1), (up, 1), (1, 1), (px0, px1, 0, 0)),
                  ("up y", fu.reshape(-1, 1), (1, up), (1, 1), (0, 0, px0, px1)),
                  ("act", None, None, None, None),
                  ("down x", fd.reshape(1, -1), (1, 1), (down, 1), (0, 0, 0, 0)),
                  ("down y", fd.reshape(-1, 1), (1, 1), (1, down), (0, 0, 0, 0))]
        for what, taps, u, d, pad in passes:
            _build.reset_launches()
            if taps is None:
                def fn():
                    return fused_act.clamped_leaky_relu(x, 256.0)
                inst, plain = "clamped_leaky_relu", (
                    lambda t: fused_act.clamped_leaky_relu_plain(t, 256.0))
            else:
                taps = taps.contiguous()

                def fn():
                    return upfirdn2d(x, taps, u, d, pad)
                inst = fir_instance(*taps.shape, u, d, torch.float32, torch.contiguous_format)

                def plain(t):
                    return upfirdn2d_plain(t, taps, u, d, pad)
            with torch.no_grad():
                y = fn()
            torch.cuda.synchronize()
            launched = {k: v for counts in (_build.LAUNCHES, _build.FIR_INSTANCES)
                        for k, v in counts.items() if v}
            want_launch = ({inst: 1} if taps is None else {"upfirdn2d": 1, inst: 1})
            check(launched == want_launch, f"{spec['name']} {what}: launched {launched}")
            err = top = 0.0
            for i in range(0, n, 8):
                ref_y = plain(x[i:i + 8])
                if taps is None:
                    check(torch.equal(y[i:i + 8], ref_y),
                          f"{spec['name']} clamped_leaky_relu differs from plain")
                err = max(err, max_err(y[i:i + 8], ref_y))
                top = max(top, ref_y.abs().max().item())
                del ref_y
            check(err <= 1e-5 * top, f"{spec['name']} {what} ({inst}): err {err} > 1e-5 x {top}")
            worst = max(worst, err / top)
            yardstick = {}
            if inst in ("fir24x_up4", "fir24y_up4"):  # the library's call, plain on 8 images
                w = taps.expand(x.shape[1], 1, *taps.shape).contiguous()
                crop = (0, taps.shape[1] - 1 - pad[0]) if u[0] == 4 else (taps.shape[0] - 1 - pad[2], 0)

                def lib(t):
                    return F.conv_transpose2d(t, w, stride=(u[1], u[0]), padding=crop,
                                              groups=t.shape[1])
                with torch.no_grad():  # compared in blocks of 8 images: L10's y is 20.7 GB
                    lib_err = max(max_err(lib(x[i:i + 8]), y[i:i + 8]) for i in range(0, n, 8))
                    check(lib_err <= 1e-5 * top,
                          f"{spec['name']} {what}: the conv_transpose2d yardstick disagrees")
                    yardstick = {"library_ms": cuda_ms(lambda: lib(x), iters=2, warmup=1),
                                 "plain_ms_8_images": cuda_ms(lambda: plain(x[:8]), iters=1,
                                                              warmup=1)}
                del w
            others = {}
            if taps is not None:
                for o in fir_against:
                    check(torch.equal(o(x, taps, u, d, pad), y),
                          f"{spec['name']} {what}: {o.root}'s {o.took[inst]} gives other bits "
                          f"than {inst}")
                    others[o.root] = lambda o=o: o(x, taps, u, d, pad)
            with torch.no_grad():
                if others:  # in turns: this, the others, the others reversed, this
                    turns = {"a": fn, **others}
                    t = {k: [] for k in turns}
                    for k in [*turns, *reversed(turns)]:
                        t[k].append(cuda_ms(turns[k], iters=5, warmup=1))
                    ms = sum(t["a"]) / 2
                else:
                    ms = cuda_ms(fn, iters=5, warmup=1)
            kt = 1 if taps is None else -(-taps.shape[1] // u[0]) * -(-taps.shape[0] // u[1])
            b_ms, kind = bound(4 * (x.numel() + y.numel()), 0 if taps is None else
                               2 * y.numel() * kt)
            rows.append({"layer": spec["name"], "pass": what, "kernel": inst,
                         "shape": [list(x.shape), list(y.shape)], "pad": pad, "ms": ms,
                         "bound_ms": b_ms, "bound_by": kind, "roofline_pct": 100 * b_ms / ms,
                         "rel_err": err / top, **yardstick,
                         "against": {o.root: {"kernel": o.took[inst], "ms": sum(t[o.root]) / 2}
                                     for o in fir_against if o.root in others}})
            x = y
            del y
        del x, layer
        torch.cuda.empty_cache()
    # the clamp binding: L13's activation on an input scaled past +-256 / sqrt(2)
    u = torch.randn((8, 128, 522, 522), generator=rng, device=dev) * 1000
    with torch.no_grad():
        got = fused_act.clamped_leaky_relu(u, 256.0)
    want = fused_act.clamped_leaky_relu_plain(u, 256.0)
    check(torch.equal(got, want) and float(got.max()) == 256.0 and float(got.min()) == -256.0,
          "clamped_leaky_relu on a forced input differs from plain or does not clamp")
    del u, got, want
    for r in rows:
        other = "".join(f"; {root} {a['kernel']} {a['ms']:.4f} ms (the same bits)"
                        for root, a in r["against"].items())
        if "library_ms" in r:
            other += (f"; conv_transpose2d {r['library_ms']:.4f} ms, plain on 8 images "
                      f"{r['plain_ms_8_images']:.4f} ms")
        print(f"  {r['layer']:12s} {r['pass']:6s} {r['kernel']:18s} {r['shape'][0]} -> "
              f"{r['shape'][1][2:]}: {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), {r['roofline_pct']:.1f}%, rel err {r['rel_err']:.2e}{other}")
    by = {}
    for r in rows:
        k = by.setdefault(r["kernel"], [0.0, 0.0, 0, {}])
        k[0], k[1], k[2] = k[0] + r["ms"], k[1] + r["bound_ms"], k[2] + 1
        for root, a in r["against"].items():
            k[3][root] = k[3].get(root, 0.0) + a["ms"]
    for k, (ms, b_ms, cnt, other) in sorted(by.items()):
        vs = "".join(f"; {root} {t:.3f} ms" for root, t in other.items())
        print(f"stylegan3 at batch {n}: {k}: {cnt} passes, {ms:.3f} ms, bound {b_ms:.3f} ms, "
              f"{100 * b_ms / ms:.1f}%{vs} [{smi}]")
    total = sum(r["ms"] for r in rows)
    print(f"stylegan3 kernels: {len(rows)} passes of a batch of {n} match plain (fir rel err "
          f"<= {worst:.2e}, tol 1e-5; the clamped activation bit for bit, the clamp binding "
          f"on a forced input); {total:.2f} ms of kernels a batch, bound "
          f"{sum(r['bound_ms'] for r in rows):.2f} ms; {time.perf_counter() - t_start:.1f} s")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "stylegan3_kernels.json").write_text(json.dumps({"card": smi, "rows": rows}, indent=1))
    stylegan3_drs_launches(dev, smi)
    return rows


def stylegan3_drs_launches(dev, smi):
    """StyleGAN3-T's DRS path as sg3t_256.drs drives it (the registry's ffhq /
    stylegan3 bundle at 256 px, eval.evaluate's closures, DRS.generate_images;
    its initial weights, batch 16, 2 warm-up batches, 16 images): phase 4's
    check that kernel A's generic instance does not launch, the up-4 pair
    and the clamped activation launched, and in one G forward under a
    profiler session the program's counters: every 24-tap up-4 call
    (`fir_up4_calls`) ran on the pair (`fir_up4_family`)."""
    from diagan_tpu_torch.eval.drs import DRS
    from diagan_tpu_torch.eval.evaluate import make_disc_fn, make_gen_fn
    from diagan_tpu_torch.models.registry import get_gan_model
    from diagan_tpu_torch.ops import _build
    from diagan_tpu_torch.utils import trace

    torch.manual_seed(SEED + 31)
    bundle = get_gan_model("ffhq", model="stylegan3", drs=True, device=dev, size=256)
    gen_fn = make_gen_fn(bundle.gen, generator=torch.Generator(dev).manual_seed(SEED + 32))
    disc_fn = make_disc_fn(bundle.disc_drs)
    _build.reset_launches()
    t0 = time.perf_counter()
    drs = DRS(gen_fn, disc_fn, 512, generator=torch.Generator(dev).manual_seed(SEED + 33),
              batch_size=16, warmup_batches=2, device=dev)
    images = drs.generate_images(16)
    torch.cuda.synchronize()
    t_drs = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    fir = fir_launches("StyleGAN3-T DRS")
    check(images.shape == (16, 256, 256, 3) and bool(np.isfinite(images).all()),
          f"StyleGAN3-T DRS gave {images.shape}, or values that are not finite")
    check(fir["fir24x_up4"] > 0 and fir["fir24y_up4"] > 0 and launches["clamped_leaky_relu"] > 0,
          f"StyleGAN3-T DRS launched {launches}, kernel A {fir}")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        gen_fn(torch.randn((4, 512), device=dev))
        torch.cuda.synchronize()
    counters = trace.counters()
    check(counters.get("fir_up4_calls") == counters.get("fir_up4_family") == 8,
          f"one StyleGAN3-T G forward counted {counters}")
    print(f"StyleGAN3-T DRS: 16 accepted of {drs.proposed} proposed in {t_drs:.2f} s "
          f"(batch 16, warm-up included); one G forward counted fir_up4_calls "
          f"{counters['fir_up4_calls']}, fir_up4_family {counters['fir_up4_family']} [{smi}]")
    del bundle, drs, gen_fn, disc_fn
    torch.cuda.empty_cache()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after phase 3d (build, check and time the kernels, "
                             "check the polyphase resample)")
    parser.add_argument("--against", metavar="ROOT", action="append",
                        help="also time kernel A and the four warp kernels of the checkout at "
                             "ROOT (e.g. the parent commit's tree) in turns with this one, and "
                             "check that kernel A's fp32 and bf16 instances and both gathers "
                             "give its bits; kernel A takes several ROOTs (the warp kernels the "
                             "first)")
    parser.add_argument("--dp-worker", nargs=2, metavar=("DIR", "RANK"),
                        help="run one of phase 16b's two ranks (the script starts them)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a card",
              file=sys.stderr)
        return 2
    if args.dp_worker:
        return dp_worker(args.dp_worker[0], int(args.dp_worker[1]))
    from diagan_tpu_torch.cli import generate
    from diagan_tpu_torch.device import pin_fp32_precision
    from diagan_tpu_torch.eval.drs import DRS
    from diagan_tpu_torch.eval.evaluate import (
        make_disc_fn,
        make_gen_fn,
        read_stylegan2_ckpt,
        save_stylegan2_ckpt,
    )
    from diagan_tpu_torch.models.stylegan2 import (
        NoiseInjection,
        StyleGAN2Discriminator,
        StyleGAN2Generator,
        _channels,
    )
    from diagan_tpu_torch.ops import (
        _build,
        fused_leaky_relu,
        fused_leaky_relu_backward,
        fused_leaky_relu_plain,
        make_resample_kernel,
        upfirdn2d,
        upfirdn2d_plain,
    )

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    pin_fp32_precision()  # the CLIs' precision, for the whole script
    print(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    dev = torch.device("cuda")
    gen_rng = torch.Generator(dev).manual_seed(SEED)

    # 2. build
    phase("2. build")
    t0 = time.perf_counter()
    logs = _build.build_all()
    t_nvcc = time.perf_counter() - t0
    for name, log in logs.items():
        for line in ptxas_report(log) or ["up to date"]:
            print(f"nvcc {name}: {line}")
    t0 = time.perf_counter()
    fused_leaky_relu(torch.zeros(1, 1, device=dev), torch.zeros(1, device=dev))
    fused_leaky_relu_backward(torch.zeros(1, 1, device=dev), torch.zeros(1, 1, device=dev))
    torch.cuda.synchronize()
    t_triton = time.perf_counter() - t0
    print(f"build: nvcc {t_nvcc:.2f} s, triton first launches (forward, backward) "
          f"{t_triton:.2f} s")

    # 3. kernels against their plain versions: kernel A on every case of
    # fir_cases, by instance (the training path's backward and double
    # backward included), then fused bias-LeakyReLU
    phase("3. kernels against their plain versions")
    ch = _channels(SIZE, CH_MULT)
    k4 = torch.tensor(make_resample_kernel([1, 3, 3, 1]), device=dev)
    fir_errs, err_a, err_fir_bwd = check_fir(dev, gen_rng, fir_cases(dev, ch, k4))

    flr_shapes = [(16, STYLE_DIM), (16, ch[4])]
    flr_shapes += [(16, ch[r], r, r) for r in [2**j for j in range(2, int(math.log2(SIZE)) + 1)]]
    err_b = 0.0
    for shape in flr_shapes:
        x32 = torch.randn(shape, generator=gen_rng, device=dev)
        b32 = torch.randn(shape[1], generator=gen_rng, device=dev)
        for x, b in ((x32, b32), (x32.bfloat16(), b32.bfloat16())):
            got = fused_leaky_relu(x, b)
            torch.cuda.synchronize()
            want = fused_leaky_relu_plain(x, b)
            diff = (got.float() - want.float()).abs()
            if x.dtype == torch.float32:
                err_b = max(err_b, diff.max().item())
                check(diff.max().item() <= 1e-6 * max(1.0, want.abs().max().item()),
                      f"fused_leaky_relu {shape} fp32 err {diff.max().item()}")
            else:
                check(bool((diff <= bf16_ulp(want)).all()),
                      f"fused_leaky_relu {shape} bf16 differs by more than 1 ulp")
    print(f"fused_leaky_relu: {len(flr_shapes)} shapes x (fp32, bf16) match plain; "
          f"max abs err fp32 {err_b:.3e} (tol 1e-6 x max(1, max|out|); bf16 1 ulp)")
    check_styled_act(dev, gen_rng, ch)

    # 3b. the training path's kernels against their plain versions
    phase("3b. the training kernels against their plain versions")
    rng_b = torch.Generator(dev).manual_seed(SEED + 10)
    errs = {"flr_bwd": check_act_backward(dev, rng_b, ch), "fir_bwd": err_fir_bwd}
    errs["gather"], errs["scatter"] = check_warp(dev, rng_b)
    check_scatter_launches(dev)
    check_atomics()
    # 3c. the polyphase ADA kernels, and the resample they serve
    phase("3c. the polyphase kernels")
    errs["gather2"], errs["scatter2"] = check_warp2(dev, rng_b)
    check_polyphase_resample(dev, rng_b)
    # 3d. kernel A's instances against cuDNN, and the two-phase warp pair
    # beside the interleaved gather and grid_sample
    phase("3d. kernel A's instances against cuDNN; the warp pairs")
    fir_against = [against_fir(root, f"-{i}") for i, root in enumerate(args.against or [])]
    fir_kernels = time_fir_instances(dev, rng_b, ch, k4, smi, fir_against)
    time_fir_generic(dev, rng_b, ch, k4, smi, fir_against)
    if fir_against:  # phase 14d's bf16 rows, here beside the other checkout's
        time_bf16_kernels(dev, rng_b, ch, k4, smi, {}, fir_against)
    for inst, k in fir_kernels.items():
        k["max_abs_err"] = fir_errs[inst]
    against = against_warp(args.against[0]) if args.against else None
    warp_kernels = time_warp(dev, rng_b, smi, errs, against)
    warp_kernels += time_warp2(dev, rng_b, smi, errs, against)
    # 3e. StyleGAN3-T's kernel A passes and clamped activation at its cell's shapes
    phase("3e. StyleGAN3-T's kernels at batch 64")
    stylegan3_kernels(dev, smi, args.against or [], fir_against)
    if args.kernels_only:
        print(smi)
        return 0

    # 4. the serving slice at full width
    phase("4. serving")
    work = ROOT / "diagan_tpu_torch" / "build" / "chip_smoke"
    samples = ROOT / "chiprun_out" / "chip_smoke_samples"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    torch.manual_seed(SEED)
    g = StyleGAN2Generator(SIZE, STYLE_DIM, N_MLP, CH_MULT, device=dev)
    d = StyleGAN2Discriminator(SIZE, CH_MULT, device=dev)
    drs_d = StyleGAN2Discriminator(SIZE, CH_MULT, device=dev)
    with torch.no_grad():
        for m in g.modules():  # trained models have non-zero noise weights
            if isinstance(m, NoiseInjection):
                m.weight.fill_(0.1)
    ckpt = save_stylegan2_ckpt(work / "ckpt.pt", g, d, drs_d)
    n_params = sum(p.numel() for p in g.parameters()), sum(p.numel() for p in d.parameters())
    print(f"StyleGAN2-{SIZE}: G {n_params[0]} params, D {n_params[1]} params")

    _build.reset_launches()
    t0 = time.perf_counter()
    imgs = generate.main(["--size", str(SIZE), "--sample", "16", "--pics", "2",
                          "--truncation", "0.7", "--truncation_mean", "4096",
                          "--ckpt", str(ckpt), "--out_dir", str(samples),
                          "--seed", str(SEED)])
    t_gen = time.perf_counter() - t0
    launches_gen = dict(_build.LAUNCHES)
    fir_gen = fir_launches("cli.generate")
    check(imgs.shape == (32, SIZE, SIZE, 3), f"generate shape {imgs.shape}")
    check(bool(np.isfinite(imgs).all()), "generate produced non-finite values")
    check(all(launches_gen[k] > 0 for k in FORWARD_KERNELS), f"generate launches {launches_gen}")
    check(len(list(samples.glob("*.png"))) == 2, "generate wrote no grids")
    print(f"cli.generate: 2 grids of 16, {t_gen:.2f} s, launches {launches_gen}")

    g2 = StyleGAN2Generator(SIZE, STYLE_DIM, N_MLP, CH_MULT, device=dev)
    d2 = StyleGAN2Discriminator(SIZE, CH_MULT, device=dev)
    read_stylegan2_ckpt(ckpt, g2, d2, use_drs=True)
    gen_fn = make_gen_fn(g2, generator=torch.Generator(dev).manual_seed(SEED + 1))
    disc_fn = make_disc_fn(d2)
    _build.reset_launches()
    t0 = time.perf_counter()
    drs = DRS(gen_fn, disc_fn, STYLE_DIM, generator=torch.Generator(dev).manual_seed(SEED + 2),
              batch_size=32, warmup_batches=4, device=dev)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    accepted = drs.generate_images(128)
    t_drs = time.perf_counter() - t0
    launches_drs = dict(_build.LAUNCHES)
    fir_drs = fir_launches("DRS")
    check(accepted.shape == (128, SIZE, SIZE, 3), f"DRS shape {accepted.shape}")
    check(bool(np.isfinite(accepted).all()), "DRS produced non-finite values")
    check(all(launches_drs[k] > 0 for k in FORWARD_KERNELS), f"DRS launches {launches_drs}")
    acc_rate = drs.accepted / drs.proposed
    check(0.0 < acc_rate < 1.0, f"DRS acceptance {acc_rate}")
    print(f"DRS: warm-up 4 x 32 in {t_warm:.2f} s; 128 accepted of {drs.proposed} proposed "
          f"(acceptance {acc_rate:.4f}) in {t_drs:.2f} s = {128 / t_drs:.2f} accepted/s "
          f"[{smi}]; launches {launches_drs}")

    # the same forwards on the card and on the CPU
    rng = np.random.default_rng(SEED)
    z = rng.standard_normal((2, STYLE_DIM)).astype(np.float32)
    noises = [rng.standard_normal(s).astype(np.float32) for s in g.synthesis.noise_shapes(2)]
    x = np.tanh(rng.standard_normal((4, SIZE, SIZE, 3))).astype(np.float32)
    g_cpu = StyleGAN2Generator(SIZE, STYLE_DIM, N_MLP, CH_MULT, device="cpu")
    g_cpu.load_state_dict({k: v.cpu() for k, v in g.state_dict().items()})
    d_cpu = StyleGAN2Discriminator(SIZE, CH_MULT, device="cpu")
    d_cpu.load_state_dict({k: v.cpu() for k, v in d.state_dict().items()})
    with torch.no_grad():
        _build.reset_launches()
        out_card = g(torch.from_numpy(z).to(dev), [torch.from_numpy(t).to(dev) for t in noises])
        torch.cuda.synchronize()
        per_g = dict(_build.LAUNCHES)
        _build.reset_launches()
        logit_card, _ = d(torch.from_numpy(x).to(dev))
        torch.cuda.synchronize()
        per_d = dict(_build.LAUNCHES)
        out_cpu = g_cpu(torch.from_numpy(z), [torch.from_numpy(t) for t in noises])
        logit_cpu, _ = d_cpu(torch.from_numpy(x))
    g_err = (out_card.cpu() - out_cpu).abs().max().item()
    g_scale = out_cpu.abs().max().item()
    d_err = (logit_card.cpu() - logit_cpu).abs().max().item()
    d_scale = logit_cpu.abs().max().item()
    print(f"card vs CPU, fp32, TF32 off: G batch 2 max abs err {g_err:.3e} "
          f"(max|out| {g_scale:.3e}); D batch 4 logits max abs err {d_err:.3e} "
          f"(max|logit| {d_scale:.3e}); tolerance 1e-3 x max(1, max|out|)")
    check(g_err <= 1e-3 * max(1.0, g_scale), f"G card vs CPU err {g_err}")
    check(d_err <= 1e-3 * max(1.0, d_scale), f"D card vs CPU err {d_err}")
    print(f"launches per forward at {SIZE} px: G {per_g}, D {per_d}")
    check_styled_images(dev, smi)

    # 5. timings at the real shapes
    phase("5. serving timings")
    kernels = []
    xa = torch.randn((16, ch[SIZE], SIZE + 1, SIZE + 1), generator=gen_rng, device=dev)
    taps = k4 * 4
    ya = upfirdn2d(xa, taps, pad=(1, 1))
    w_dw = torch.flip(taps, (0, 1)).expand(xa.shape[1], 1, 4, 4).contiguous()
    lib = torch.nn.functional.conv2d(xa, w_dw, padding=1, groups=xa.shape[1])
    check((lib - ya).abs().max().item() <= 1e-5 * ya.abs().max().item(),
          "depthwise conv2d yardstick disagrees with upfirdn2d")
    b_a, by_a = bound((xa.numel() + ya.numel()) * 4, ya.numel() * 16 * 2)
    kernels.append({
        "name": "upfirdn2d", "route": "cuda", "source": "diagan_tpu_torch/csrc/upfirdn2d.cu",
        "replaces": "diagan_tpu/ops/fir_pallas.py:44,131,226",
        "launches": launches_gen["upfirdn2d"] + launches_drs["upfirdn2d"],
        "max_abs_err": err_a,
        "ms": cuda_ms(lambda: upfirdn2d(xa, taps, pad=(1, 1))),
        "plain_ms": cuda_ms(lambda: upfirdn2d_plain(xa, taps, pad=(1, 1)), iters=3),
        "bound_ms": b_a, "bound_by": by_a,
        "library_ms": cuda_ms(lambda: torch.nn.functional.conv2d(
            xa, w_dw, padding=1, groups=xa.shape[1])),
        "shape": f"{tuple(xa.shape)} fp32 pad (1,1) 4x4 taps (G upsample blur at {SIZE} px)",
    })
    xb = torch.randn((16, ch[SIZE], SIZE, SIZE), generator=gen_rng, device=dev)
    bb = torch.randn(ch[SIZE], generator=gen_rng, device=dev)
    b_b, by_b = bound(2 * xb.numel() * 4 + bb.numel() * 4, xb.numel() * 3)
    kernels.append({
        "name": "fused_leaky_relu", "route": "triton",
        "source": "diagan_tpu_torch/ops/fused_act.py",
        "replaces": "diagan_tpu/ops/fused_act.py:41",
        "launches": launches_gen["fused_leaky_relu"] + launches_drs["fused_leaky_relu"],
        "max_abs_err": err_b,
        "ms": cuda_ms(lambda: fused_leaky_relu(xb, bb)),
        "plain_ms": cuda_ms(lambda: fused_leaky_relu_plain(xb, bb)),
        "bound_ms": b_b, "bound_by": by_b,
        # no single PyTorch call adds a per-channel bias, applies LeakyReLU
        # and scales
        "library_ms": None,
        "shape": f"{tuple(xb.shape)} fp32 (styled conv at {SIZE} px; the plain build, which D "
                 f"and the mapping net launch)",
    })
    for k in kernels:
        print(f"{k['name']} at {k['shape']}: {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
              f"library {k['library_ms']}, bound {k['bound_ms']:.4f} ms ({k['bound_by']}) "
              f"[{smi}]")
    kernels.append(time_styled_act(dev, gen_rng, ch))
    kernels[-1]["launches"] = launches_gen["styled_leaky_relu"] + launches_drs["styled_leaky_relu"]

    z32 = torch.randn((32, STYLE_DIM), generator=gen_rng, device=dev)
    g_ms = cuda_ms(lambda: gen_fn(z32), iters=3, warmup=1)
    print(f"G StyleGAN2-{SIZE} batch 32 fp32: {g_ms:.2f} ms = {32e3 / g_ms:.2f} images/s "
          f"[{smi}]")
    print(f"DRS batch 32: {128 / t_drs:.2f} accepted samples/s, acceptance {acc_rate:.4f} "
          f"[{smi}]")
    profile(lambda: disc_fn(gen_fn(z32)), f"one proposal batch ({z32.shape[0]} images, G + D)",
            smi, (*FIR_TAGS, "flr_fwd"))

    # 6. the training path at full width, through its CLIs
    phase("6. training paths")
    tr1, launches_train, fir_train = train_path(dev, smi, work / "train")
    # 6b. one training step's gradients, card against CPU
    phase("6b. gradients, card against CPU")
    grads_card_vs_cpu(dev, work / "grads")

    # 7. timings of the training path
    phase("7. training timings")
    total = {k: launches_gen[k] + launches_drs[k] + sum(run[k] for run in launches_train.values())
             for k in launches_gen}
    for k in kernels:
        k["launches"] = total[k["name"]]
    kernels += time_new_kernels(dev, rng_b, ch, k4, smi, total, errs)
    for k in warp_kernels:
        k["launches"] = total[k["name"]]
    kernels += warp_kernels
    fir_total = {inst: fir_gen[inst] + fir_drs[inst] + sum(run[inst] for run in fir_train.values())
                 for inst in fir_gen}
    for inst, k in fir_kernels.items():
        k["launches"] = fir_total[inst]
    kernels += list(fir_kernels.values())
    time_polyphase(dev, rng_b, smi)
    phase("7b. training steps")
    time_training(tr1, smi)
    print(f"launches on the main paths: serving {launches_gen} + {launches_drs}; "
          f"training {launches_train}")
    print(f"kernel A launches by instance on the main paths: serving {fir_gen} + {fir_drs}; "
          f"training {fir_train}; in all {fir_total}")

    # 8. the SNGAN-32 Dia-GAN path, which has no port kernel
    phase("8. the SNGAN-32 path")
    (work / "sngan").mkdir()
    sngan_path(dev, smi, work / "sngan")
    phase("8b. one SNGAN step, card against CPU")
    sngan_step_card_vs_cpu(dev, smi)

    # 9. evaluation: FID/IS/KID/PR through the eval entry points
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # what earlier phases still hold
    phase("9a. Inception, card against CPU")
    inception_card_vs_cpu(dev, smi)
    phase(f"9b/9c. evaluation: SNGAN-32 at {EVAL_N // 1000}k counts, StyleGAN2-256 with DRS")
    eval_launches, eval_fir = eval_path(dev, smi, work)
    for k in kernels:
        if k["name"] in eval_launches:
            k["launches"] += eval_launches[k["name"]]
        elif k["name"].startswith("upfirdn2d/"):
            k["launches"] += eval_fir[k["name"].split("/", 1)[1]]
    phase("9d. evaluation timings")
    time_inception(dev, smi)
    peak = torch.cuda.max_memory_allocated()
    print(f"peak device memory of phase 9 {(peak - held) / 2**30:.2f} GiB above the "
          f"{held / 2**30:.2f} GiB that earlier phases still held [{smi}]")

    # 10. the CelebA-64 path and its attribute study, which have no port kernel
    phase("10. the CelebA-64 path and the attribute study")
    (work / "celeba").mkdir()
    celeba_path(dev, smi, work / "celeba")
    phase("10b. one SNGAN-64 step and the attribute classifier, card against CPU")
    sngan_step_card_vs_cpu(dev, smi, size=64)
    attr_classifier_card_vs_cpu(dev, smi)

    # 11. the MNIST families and the toy, which have no port kernel
    phase("11. the Colored-MNIST and MNIST-FMNIST path and the 25-Gaussians toy")
    (work / "mnist").mkdir()
    mnist_path(dev, smi, work / "mnist")
    phase("11b. one MNIST DCGAN step, card against CPU")
    dcgan_step_card_vs_cpu(dev, smi)

    # 12. the CAE protocol and Inclusive GAN on phase 11's runs, no port kernel
    phase("12. the CAE reconstruction-error protocol and Inclusive GAN")
    cae_inclusive_path(dev, smi, work / "mnist")
    phase("12b. the CAE and the Inclusive hook, card against CPU")
    cae_inclusive_card_vs_cpu(dev, smi)

    # 13. SSGAN, InfoMax-GAN, --simultaneous_g and --bf16 on the earlier
    # phases' data, no port kernel
    phase("13. SSGAN and InfoMax-GAN through the Dia-GAN path; --simultaneous_g, --bf16")
    ssgan_infomax_path(dev, smi, work)
    phase("13b. SSGAN, InfoMax, the step fusions and bf16, card against CPU")
    ssgan_infomax_card_vs_cpu(dev, smi)

    # 14. the FFHQ trainer's flags and the checkpoint readers, on phase 6's data
    phase("14a. the FFHQ trainer's flags (--bf16 --remat --stream_data --no_fuse --max_chunk), "
          "the reference-format checkpoint")
    tr_flags, flag_runs = flags_path(dev, smi, work)
    for k in kernels:  # phase 14's fp32 launches join the fp32 rows
        name = k["name"]
        if name in _build.LAUNCHES:
            k["launches"] += sum(r[0][name] - r[2].get(name, 0) for r in flag_runs.values())
        elif name.startswith("upfirdn2d/"):
            inst = name.split("/", 1)[1]
            k["launches"] += sum(r[1][inst] - r[2].get(name, 0) for r in flag_runs.values())
    phase("14b. stream mode and remat against the plain run; steps/s and peak memory")
    flags_against_plain(dev, smi, work, tr_flags)
    del tr_flags
    phase("14c. one bf16 training step, card against CPU")
    bf16_train_step_card_vs_cpu(dev, smi, work / "bf16_grads")
    phase("14d. the bf16 kernels at the bf16 step's shapes")
    kernels += time_bf16_kernels(dev, rng_b, ch, k4, smi, flag_runs)

    # 15. a reference run carried into the port; the modules with no caller
    phase("15a. a reference-format phase-1 run resumed through cli.train_mimicry_phase2")
    carried_run_path(dev, smi, work)
    phase("15b. ModulatedConv(downsample=True) at StyleGAN2-256 widths")
    down_launches, down_fir = downsample_conv_path(dev, smi)
    for k in kernels:  # phase 15b's launches join the fp32 rows
        name = k["name"]
        if name in down_launches:
            k["launches"] += down_launches[name]
        elif name.startswith("upfirdn2d/"):
            k["launches"] += down_fir[name.split("/", 1)[1]]
    phase("15c. cli.validate_weights; LPIPS card against CPU")
    fid = weights_gate_path(dev, smi, work / "weights")
    phase("15d. the by-index loaders on phase 10's CelebA")
    index_loader_path(dev, smi, work, fid)

    # 16. data parallelism over torch.distributed
    phase("16a. --data_parallel at world 1 over NCCL, through the CLIs, against the plain run")
    dp_launches, dp_fir = dp_world1_path(dev, smi, work)
    for k in kernels:  # the DP FFHQ runs' launches join the fp32 rows
        name = k["name"]
        if name in dp_launches:
            k["launches"] += dp_launches[name]
        elif name.startswith("upfirdn2d/"):
            k["launches"] += dp_fir[name.split("/", 1)[1]]
    phase("16b. two ranks over gloo on the one card")
    dp_world2_path(smi, work)

    # 17. the 25-Gaussians two-phase protocol, no port kernel; the CLIs' precision
    phase("17. cli.smoke_toy: the 25-Gaussians protocol at full depth; fp32 after a CLI")
    toy_protocol_path(dev, smi, work / "toy")

    # 18. the headline benchmark, cli.bench's functions at full width
    phase("18. cli.bench: SNGAN-32 steps/s and MFU, DRS, StyleGAN2-256 bf16 at ADA p 0 and 0.05")
    bench_path(dev, smi, work, kernels)
    phase("18b. a profile of bench StyleGAN2-256 steps 29-32 (3 plain, R1 + path length)")
    bench_profiles(dev, smi, work, range(29, 33))

    shutil.rmtree(work, ignore_errors=True)
    phase("done")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
