#!/usr/bin/env python3
"""Drive the PyTorch port (diagan_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--kernels-only]

Phases, in order; any failure raises and the script exits non-zero:
  1. card name and power limit (nvidia-smi); TF32 off for convs and matmuls;
  2. build the CUDA kernels from csrc/ (nvcc, sm_90a, one process per source,
     all started together) and compile the Triton ones;
  3. kernel A (upfirdn2d) against its plain-torch version on the card, on
     every main-path shape (G and D blurs and the ToRGB skip at batch 16 and
     the serving batch of 32, ADA's passes of both forms at each pad bucket),
     each instance's edge shapes (odd widths, 8-9 px planes, pads of both
     parities) and the odd configurations of the CPU tests: fp32, bf16 and
     channels-last, each call launching the instance fir_instance names,
     then the backward and double backward; fused bias-LeakyReLU at the real
     shapes in fp32 and bf16;
  3b. the training kernels against their plain versions: the fused-act
     backward (dx, db, double backward) at every activation shape, fp32 and
     bf16; ADA's warp gather and its adjoint at each bucket's S2, six
     geometries and one batch of ADA draws;
  3c. the polyphase ADA kernels against their plain versions: the two-phase
     warp gather and its adjoint at each bucket's S2, the same geometries and
     draws; then the whole polyphase resample at 256 px, batch 16, against
     the interleaved one at the same reflect pad, values and image gradient;
  3d. each kernel A instance at its largest main-path shape against one
     cuDNN depthwise call and its bytes bound (device time of CUDA-graph
     replays, in turns), every ADA pass of both forms likewise; the
     two-phase warp pair, and its gather in turns with the interleaved
     gather and grid_sample (--kernels-only stops here);
  4. the serving slice at full width (StyleGAN2-256, channel_multiplier 2,
     style_dim 512, n_mlp 8, random weights from a seed): save a checkpoint,
     run cli.generate, draw DRS samples, with the launch counts (per kernel,
     and kernel A's per instance: the generic one must not launch) zeroed
     before and read after each path; then one G and one D forward on the card and
     on the CPU, with the same weights and noises;
  5. timings at the real shapes: kernel, plain version, one PyTorch library
     call for the same function, and the bytes/ops bound; G images/s, DRS
     accepted samples/s, and a torch.profiler breakdown of one DRS proposal
     batch (device time by kernel, idle share);
  6. the training path at full width on 512 synthetic images: cli.train_ffhq
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
     trainer's pad buckets, and a profile of one polyphase ADA-live step.
Each phase prints its start, in seconds since the script started.
The last lines are the kernels' JSON, the nvidia-smi line and
{"ok": true, "device": {...}}. Without a card it exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
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
    launch (Python, the wrapper, the CUDA launch call) is left out."""
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
    print(f"profile of {label}: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms (union of "
          f"kernel intervals; kernel times sum to {total:.2f} ms), idle share "
          f"{1 - busy / wall_ms:.4f} [{smi}]")
    for name, ms, count in rows[:12]:
        print(f"  {ms:9.3f} ms {100 * ms / total:6.2f}%  x{count:<4d} {name[:90]}")
    for tag in tags:
        ms = sum(r[1] for r in rows if tag in r[0])
        print(f"  {tag}: {ms:.3f} ms, {100 * ms / total:.2f}% of summed kernel time")

FORWARD_KERNELS = ("upfirdn2d", "fused_leaky_relu")  # what sampling launches
# kernel A's device kernels in a profile: all of them, then by kernel
FIR_TAGS = ("fir_", "fir_kernel", "fir_xdown2_kernel", "fir_generic_kernel")
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
    not symmetric); then the odd configurations of the port's CPU tests,
    which the generic instance takes where they are not a family."""
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


def check_fir(dev, rng, cases):
    """Kernel A against its plain version on each case: the forward in fp32,
    bf16 and channels-last, each call launching exactly the instance that
    fir_instance names (the generic one for channels-last); then in fp32 the
    backward and the double backward against autograd through the plain
    version; a case that is not `full` only in fp32, forward. Returns
    {instance: max fp32 abs err} and the largest forward and backward
    errors."""
    from diagan_tpu_torch.ops import _build, upfirdn2d, upfirdn2d_plain
    from diagan_tpu_torch.ops.upfirdn2d import _backward_args, fir_instance, layout

    errs, err_fwd, err_bwd = {}, 0.0, 0.0

    def note(inst, e):
        errs[inst] = max(errs.get(inst, 0.0), e)

    for shape, taps, up, down, pad, full in cases:
        x32 = torch.randn(shape, generator=rng, device=dev)
        layouts = (x32, x32.bfloat16(), x32.contiguous(memory_format=torch.channels_last))
        for x in layouts if full else layouts[:1]:
            inst = fir_instance(*taps.shape, up, down, x.dtype, layout(x))
            _build.reset_launches()
            got = upfirdn2d(x, taps, up, down, pad)
            torch.cuda.synchronize()
            launched = {k: v for k, v in _build.FIR_INSTANCES.items() if v}
            check(launched == {inst: 1}, f"upfirdn2d {shape} {x.dtype} launched {launched}, "
                                         f"not {inst}")
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
    print(f"upfirdn2d: {len(cases)} cases (every main-path shape, each instance's edge shapes, "
          f"the odd configurations) x (fp32, bf16, channels-last) match plain, each launching "
          f"the instance fir_instance names; backward and double backward in fp32 match "
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


def check_warp(dev, rng):
    """The warp gather and its adjoint against the plain versions at each
    ADA bucket's S2 and win: six geometries and one batch of ADA draws."""
    from diagan_tpu_torch.ops import (
        affine_gather,
        affine_gather_plain,
        affine_scatter,
        affine_scatter_plain,
    )

    win = ada_win()
    err_g = err_s = 0.0
    exact = True
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
            # atomics add in a run-dependent order; clamped coordinates pile
            # hundreds of terms onto the edge pixels
            atol = 2e-4 if name == "clipped" else 2e-5
            diff = (dx2 - want_dx2).abs()
            check(bool((diff <= atol + 1e-4 * want_dx2.abs()).all()),
                  f"affine scatter {name} s2={s2}: err {diff.max().item()}")
            err_g, err_s = max(err_g, e), max(err_s, diff.max().item())
        del x2, g
    print(f"affine warp: S2 {[ada_s2(P) for P in ada_pads()]}, win {win}, "
          f"{len(WARP_CASES)} geometries + ADA draws at p=1: gather max abs err {err_g:.3e} "
          f"({'bit-exact' if exact else 'not bit-exact'}; tol 1e-6 x max|out|), adjoint "
          f"{err_s:.3e} (tol 2e-5, clipped 2e-4, + 1e-4 x |want|)")
    return err_g, err_s


def check_warp2(dev, rng):
    """The two-phase warp gather and its adjoint against the plain versions
    at each ADA bucket's S2 and win, on the geometries of check_warp."""
    from diagan_tpu_torch.ops import (
        affine_gather2_plain,
        affine_gather_2phase,
        affine_scatter2,
        affine_scatter2_plain,
    )

    win = ada_win()
    err_g = err_s = 0.0
    exact = True
    for P in ada_pads():
        s2 = ada_s2(P)
        v0, v1 = (torch.randn((16, 3, s2 // 2, s2), generator=rng, device=dev) for _ in range(2))
        g = torch.randn((4, 16, 3, win // 2, win // 2), generator=rng, device=dev)
        for name, coef in warp_coefs(P, dev).items():
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
            # as check_warp: atomics in a run-dependent order
            atol = 2e-4 if name == "clipped" else 2e-5
            for got, w in zip(dv, want_dv):
                diff = (got - w).abs()
                check(bool((diff <= atol + 1e-4 * w.abs()).all()),
                      f"affine scatter2 {name} s2={s2}: err {diff.max().item()}")
                err_s = max(err_s, diff.max().item())
            err_g = max(err_g, e)
            del out, dv, want, want_dv
        del v0, v1, g
    print(f"two-phase affine warp: S2 {[ada_s2(P) for P in ada_pads()]}, win {win}, "
          f"{len(WARP_CASES)} geometries + ADA draws at p=1: gather2 max abs err {err_g:.3e} "
          f"({'bit-exact' if exact else 'not bit-exact'}; tol 1e-6 x max|out|), adjoint "
          f"{err_s:.3e} (tol 2e-5, clipped 2e-4, + 1e-4 x |want|)")
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
    from diagan_tpu_torch.data.synthetic import synthetic_natural
    from diagan_tpu_torch.eval.drs import DRS
    from diagan_tpu_torch.eval.evaluate import make_disc_fn, make_gen_fn, read_stylegan2_ckpt
    from diagan_tpu_torch.models.stylegan2 import StyleGAN2Discriminator, StyleGAN2Generator
    from diagan_tpu_torch.ops import _build

    data = work / "data"
    data.mkdir(parents=True)
    t0 = time.perf_counter()
    np.save(data / f"ffhq_{SIZE}.npy", synthetic_natural(N_DATA, SIZE, seed=7)[0])
    print(f"dataset: {N_DATA} synthetic {SIZE} px images in {time.perf_counter() - t0:.2f} s")
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

    def finite(tr, keys):
        m = {k: float(v) for k, v in tr.metrics.items()}
        check(all(math.isfinite(v) for v in m.values()), f"non-finite metrics {m}")
        check(set(keys) <= set(m), f"metrics {sorted(m)}")
        return "; ".join(f"{k} {v:.4f}" for k, v in m.items())

    interleaved = tuple(k for k in _build.LAUNCHES if k not in WARP2)
    torch.cuda.reset_peak_memory_stats()
    tr1 = drive("train_ffhq (8 steps)", lambda: train_ffhq.main(
        common + ["--exp_name", "p1", "--iter", "8", "--logit_save_steps", "2",
                  "--save_logit_after", "0"]), interleaved, WARP2)
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 1 metrics: {finite(tr1, ('d', 'g', 'r1', 'path'))}; peak device memory "
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
    print(f"phase 2 metrics (steps 8-11: no R1 step): {finite(tr2, ('d', 'g', 'path'))}")

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
            tuple(k for k in _build.LAUNCHES if k not in WARP), WARP)
    check((work / "p1_poly" / "checkpoint" / "000004.pt").is_file(),
          "the polyphase run wrote no checkpoint")
    print(f"polyphase phase 1 metrics: {finite(trp, ('d', 'g', 'r1', 'path'))}")
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
        affine_gather,
        affine_gather_plain,
        affine_scatter,
        affine_scatter_plain,
        fused_leaky_relu_backward,
        fused_leaky_relu_backward_plain,
        upfirdn2d,
        upfirdn2d_plain,
    )
    from diagan_tpu_torch.ops.warp import _taps as warp_taps

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

    # the warp pair at the largest bucket, on one batch of ADA draws at p = 1
    win = ada_win()
    P = ada_pads()[-1]
    s2 = 2 * (SIZE + 2 * P)
    coef = ada_coef(P, SEED + 1).to(dev)
    x2 = torch.randn((16, 3, s2, s2), generator=rng, device=dev)
    gw = torch.randn((16, 3, win, win), generator=rng, device=dev)
    index, _ = warp_taps(coef, win, s2)
    touched = sum(torch.unique(torch.stack([i[k] for i in index])).numel() for k in range(16))
    idx = torch.arange(win, dtype=torch.float32, device=dev)
    ii, jj = idx[:, None], idx[None, :]
    c = coef[:, :, None, None]
    qy, qx = c[:, 0] * ii + c[:, 1] * jj + c[:, 2], c[:, 3] * ii + c[:, 4] * jj + c[:, 5]
    grid = torch.stack([2 * qx / (s2 - 1) - 1, 2 * qy / (s2 - 1) - 1], -1)

    def lib_gather(x):
        return F.grid_sample(x, grid, mode="bilinear", padding_mode="border", align_corners=True)

    # grid_sample takes normalised coordinates, which round the source point
    # by about 1e-4 pixel: agreement to 1e-3 x max|x2|
    check(max_err(lib_gather(x2), affine_gather(x2, coef, win)) <= 1e-3 * x2.abs().max().item(),
          "grid_sample yardstick disagrees with the warp gather")
    xr = x2.clone().requires_grad_(True)
    out_lib = lib_gather(xr)
    dx2 = affine_scatter(gw, coef, s2)
    check(max_err(torch.autograd.grad(out_lib, xr, gw, retain_graph=True)[0], dx2)
          <= 1e-3 * dx2.abs().max().item(), "grid_sample backward disagrees with the adjoint")
    out_bytes, coef_bytes = gw.numel() * 4, coef.numel() * 4
    pix_ops = 16 * win * win * 12  # coordinates and weights, once per pixel
    b, by = bound(touched * 3 * 4 + out_bytes + coef_bytes, pix_ops + gw.numel() * 9)
    kernels.append({
        "name": "affine_warp_gather", "route": "cuda", "source": "diagan_tpu_torch/csrc/affine_warp.cu",
        "replaces": "diagan_tpu/ops/warp_pallas.py:239",
        "launches": launches["affine_warp_gather"], "max_abs_err": errs["gather"],
        "ms": cuda_ms(lambda: affine_gather(x2, coef, win)),
        "plain_ms": cuda_ms(lambda: affine_gather_plain(x2, coef, win)),
        "bound_ms": b, "bound_by": by, "library_ms": cuda_ms(lambda: lib_gather(x2)),
        "shape": f"{tuple(x2.shape)} -> {tuple(gw.shape)} fp32, ADA draws at p=1 "
                 f"({touched} source pixels touched)",
    })
    b, by = bound(out_bytes + x2.numel() * 4 + coef_bytes, pix_ops + gw.numel() * 8)
    kernels.append({
        "name": "affine_warp_scatter", "route": "cuda", "source": "diagan_tpu_torch/csrc/affine_warp.cu",
        "replaces": "diagan_tpu/ops/warp_pallas.py:397",
        "launches": launches["affine_warp_scatter"], "max_abs_err": errs["scatter"],
        "ms": cuda_ms(lambda: affine_scatter(gw, coef, s2)),
        "plain_ms": cuda_ms(lambda: affine_scatter_plain(gw, coef, s2)),
        "bound_ms": b, "bound_by": by,
        "library_ms": cuda_ms(lambda: torch.autograd.grad(out_lib, xr, gw, retain_graph=True)),
        "shape": f"{tuple(gw.shape)} -> {tuple(x2.shape)} fp32, ADA draws at p=1",
    })
    for k in kernels:
        print(f"{k['name']} at {k['shape']}: {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
              f"library {k['library_ms']}, bound {k['bound_ms']:.4f} ms ({k['bound_by']}) "
              f"[{smi}]")
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


def time_fir_instances(dev, rng, ch, k4, smi):
    """Kernel A on every ADA pass of both forms at the largest pad and on the
    SIZE px blurs (the G upsample blur and its backward, the ToRGB skip and
    its backward), each against one cuDNN depthwise call and its bytes
    bound. Both are timed as device time (graph_ms) in turns, kernel A,
    cuDNN, cuDNN, kernel A, and kernel A also eagerly (cuda_ms: the host's
    launch cost included). Then each instance at its largest such shape,
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
    largest, sums = {}, {}
    for form, name, shape, taps, up, down, pad, lib in passes:
        xp = torch.randn(shape, generator=rng, device=dev)
        y = upfirdn2d(xp, taps, up, down, pad)
        check(max_err(lib(xp), y) <= 1e-5 * y.abs().max().item(),
              f"depthwise yardstick disagrees with the {form} {name}")
        inst = fir_instance(*taps.shape, up, down, xp.dtype, torch.contiguous_format)
        a1, l1, l2, a2 = (graph_ms(f) for f in (lambda: upfirdn2d(xp, taps, up, down, pad),
                                                lambda: lib(xp), lambda: lib(xp),
                                                lambda: upfirdn2d(xp, taps, up, down, pad)))
        t_a, t_lib = (a1 + a2) / 2, (l1 + l2) / 2
        t_eager = cuda_ms(lambda: upfirdn2d(xp, taps, up, down, pad))
        nbytes = (xp.numel() + y.numel()) * 4
        real_taps = taps.numel() // (math.prod(up) if isinstance(up, tuple) else up**2)
        b_p, by = bound(nbytes, y.numel() * real_taps * 2)
        if form != "blur":
            sums.setdefault(form, [0.0, 0.0, 0.0])
            sums[form] = [u + v for u, v in zip(sums[form], (t_a, t_lib, b_p))]
        print(f"kernel A {inst}, {form} {name} {tuple(xp.shape)} -> {tuple(y.shape)}: "
              f"{a1:.4f} / {a2:.4f} ms, cuDNN depthwise {l1:.4f} / {l2:.4f} ms (device time, "
              f"two turns), bound {b_p:.4f} ms ({by}), {b_p / t_a:.2f} of the bound; kernel A "
              f"eager {t_eager:.4f} ms [{smi}]")
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
    return {inst: entry for inst, (_, entry) in largest.items()}


def time_warp2(dev, rng, smi, errs):
    """The two-phase warp pair at the largest bucket (kernel, plain, library,
    bound; the kernels-line entries, without launches), and the two-phase
    gather in turns with the interleaved gather on the same draws and
    grid_sample."""
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

    kernels = []
    win = ada_win()
    h2, P = win // 2, ada_pads()[-1]
    s2 = ada_s2(P)
    coef = ada_coef(P, SEED + 1).to(dev)
    v0, v1 = (torch.randn((16, 3, s2 // 2, s2), generator=rng, device=dev) for _ in range(2))
    gq = torch.randn((4, 16, 3, h2, h2), generator=rng, device=dev)
    index, _ = warp_taps(coef, win, s2)
    touched = sum(torch.unique(torch.stack([i[k] for i in index])).numel() for k in range(16))
    # the library yardstick reads the interleaved buffer (built here, not
    # timed) on a grid whose rows are the four quarter grids one after another
    x2 = torch.stack([v0, v1], 3).reshape(16, 3, s2, s2)
    idx = torch.arange(h2, dtype=torch.float32, device=dev)
    c = coef[:, :, None, None]
    quarters = []
    for a, b in PARITIES:
        ii, jj = 2 * idx[:, None] + a, 2 * idx[None, :] + b
        qy, qx = c[:, 0] * ii + c[:, 1] * jj + c[:, 2], c[:, 3] * ii + c[:, 4] * jj + c[:, 5]
        quarters.append(torch.stack([2 * qx / (s2 - 1) - 1, 2 * qy / (s2 - 1) - 1], -1))
    grid = torch.cat(quarters, 1)  # (16, 4 * h2, h2, 2)

    def lib_gather(x):
        return F.grid_sample(x, grid, mode="bilinear", padding_mode="border", align_corners=True)

    def parity_major(y):  # (16, 3, 4 * h2, h2) -> (4, 16, 3, h2, h2)
        return y.reshape(16, 3, 4, h2, h2).permute(2, 0, 1, 3, 4)

    out = torch.stack(affine_gather_2phase(v0, v1, coef, win, s2))
    check(max_err(parity_major(lib_gather(x2)), out) <= 1e-3 * x2.abs().max().item(),
          "grid_sample yardstick disagrees with the two-phase gather")
    xr = x2.clone().requires_grad_(True)
    out_lib = lib_gather(xr)
    g_lib = gq.permute(1, 2, 0, 3, 4).reshape(16, 3, 4 * h2, h2)
    dv0, dv1 = affine_scatter2(gq, coef, s2)
    dx2 = torch.stack([dv0, dv1], 3).reshape(16, 3, s2, s2)
    check(max_err(torch.autograd.grad(out_lib, xr, g_lib, retain_graph=True)[0], dx2)
          <= 1e-3 * dx2.abs().max().item(), "grid_sample backward disagrees with the adjoint2")
    del dv0, dv1, dx2
    out_bytes, coef_bytes = gq.numel() * 4, coef.numel() * 4
    pix_ops = 16 * win * win * 12  # coordinates and weights, once per pixel
    b, by = bound(touched * 3 * 4 + out_bytes + coef_bytes, pix_ops + gq.numel() * 9)
    shape = f"2 x {tuple(v0.shape)} -> 4 x {tuple(gq.shape[1:])} fp32, ADA draws at p=1"
    kernels.append({
        "name": "affine_warp2_gather", "route": "cuda",
        "source": "diagan_tpu_torch/csrc/affine_warp.cu",
        "replaces": "diagan_tpu/ops/ada_phase.py:213", "max_abs_err": errs["gather2"],
        "ms": cuda_ms(lambda: affine_gather_2phase(v0, v1, coef, win, s2)),
        "plain_ms": cuda_ms(lambda: affine_gather2_plain(v0, v1, coef, win)),
        "bound_ms": b, "bound_by": by, "library_ms": cuda_ms(lambda: lib_gather(x2)),
        "shape": f"{shape} ({touched} source pixels touched); library: grid_sample on the "
                 f"interleaved buffer, its interleave not timed",
    })
    b, by = bound(out_bytes + 2 * v0.numel() * 4 + coef_bytes, pix_ops + gq.numel() * 8)
    kernels.append({
        "name": "affine_warp2_scatter", "route": "cuda",
        "source": "diagan_tpu_torch/csrc/affine_warp.cu",
        "replaces": "diagan_tpu/ops/ada_phase.py:327", "max_abs_err": errs["scatter2"],
        "ms": cuda_ms(lambda: affine_scatter2(gq, coef, s2)),
        "plain_ms": cuda_ms(lambda: affine_scatter2_plain(gq, coef, s2)),
        "bound_ms": b, "bound_by": by,
        "library_ms": cuda_ms(lambda: torch.autograd.grad(out_lib, xr, g_lib, retain_graph=True)),
        "shape": f"4 x {tuple(gq.shape[1:])} -> 2 x {tuple(v0.shape)} fp32, ADA draws at p=1; "
                 f"library: grid_sample backward onto the interleaved buffer",
    })
    for k in kernels:
        print(f"{k['name']} at {k['shape']}: {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
              f"library {k['library_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms ({k['bound_by']}) "
              f"[{smi}]")
    # the two gathers do the same work on the same draws: #8 from the two
    # y-phase planes, #6 from the interleaved buffer
    turns = {"two-phase gather (#8)": lambda: affine_gather_2phase(v0, v1, coef, win, s2),
             "interleaved gather (#6)": lambda: affine_gather(x2, coef, win),
             "grid_sample": lambda: lib_gather(x2)}
    ms = {}
    for name in [*turns, *reversed(turns)]:
        ms.setdefault(name, []).append(cuda_ms(turns[name]))
    print("gathers at the largest bucket, in turns: " + "; ".join(
        f"{name} {t1:.4f} / {t2:.4f} ms" for name, (t1, t2) in ms.items()) + f" [{smi}]")
    del v0, v1, gq, x2, xr, out_lib, g_lib, out, index
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
    def step_ms(step, reps=3):
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
            "gather2_kernel", "scatter2_kernel")
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


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after phase 3d (build, check and time the kernels, "
                             "check the polyphase resample)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a card",
              file=sys.stderr)
        return 2
    from diagan_tpu_torch.cli import generate
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
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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

    # 3b. the training path's kernels against their plain versions
    phase("3b. the training kernels against their plain versions")
    rng_b = torch.Generator(dev).manual_seed(SEED + 10)
    errs = {"flr_bwd": check_act_backward(dev, rng_b, ch), "fir_bwd": err_fir_bwd}
    errs["gather"], errs["scatter"] = check_warp(dev, rng_b)
    # 3c. the polyphase ADA kernels, and the resample they serve
    phase("3c. the polyphase kernels")
    errs["gather2"], errs["scatter2"] = check_warp2(dev, rng_b)
    check_polyphase_resample(dev, rng_b)
    # 3d. kernel A's instances against cuDNN, and the two-phase warp pair
    # beside the interleaved gather and grid_sample
    phase("3d. kernel A's instances against cuDNN; the two-phase warp")
    fir_kernels = time_fir_instances(dev, rng_b, ch, k4, smi)
    for inst, k in fir_kernels.items():
        k["max_abs_err"] = fir_errs[inst]
    warp2_kernels = time_warp2(dev, rng_b, smi, errs)
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
        "shape": f"{tuple(xb.shape)} fp32 (styled conv at {SIZE} px)",
    })
    for k in kernels:
        print(f"{k['name']} at {k['shape']}: {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
              f"library {k['library_ms']}, bound {k['bound_ms']:.4f} ms ({k['bound_by']}) "
              f"[{smi}]")

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
    for k in warp2_kernels:
        k["launches"] = total[k["name"]]
    kernels += warp2_kernels
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
