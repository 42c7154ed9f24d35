#!/usr/bin/env python3
"""Drive the PyTorch port (diagan_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. card name and power limit (nvidia-smi); TF32 off for convs and matmuls;
  2. build the CUDA kernels from csrc/ (nvcc, sm_90a) and compile the Triton one;
  3. each kernel against its plain-torch version on the card: upfirdn2d on
     the tests/test_ops.py configs, an asymmetric rank-2 and a 1-D (1, k)
     kernel, and every StyleGAN2-256 shape at batch 16, in fp32 and bf16;
     fused bias-LeakyReLU at the real shapes in fp32 and bf16;
  4. the serving slice at full width (StyleGAN2-256, channel_multiplier 2,
     style_dim 512, n_mlp 8, random weights from a seed): save a checkpoint,
     run cli.generate, draw DRS samples, with the launch counts zeroed before
     and read after each path; then one G and one D forward on the card and
     on the CPU, with the same weights and noises;
  5. timings at the real shapes: kernel, plain version, one PyTorch library
     call for the same function, and the bytes/ops bound; G images/s, DRS
     accepted samples/s, and a torch.profiler breakdown of one DRS proposal
     batch (device time by kernel, idle share).
The last lines are the kernels' JSON, the nvidia-smi line and
{"ok": true, "device": {...}}. Without a card it exits 2 and prints no result.
"""
from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
SIZE, STYLE_DIM, N_MLP, CH_MULT = 256, 512, 8, 2
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores


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


def bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_ulp(v):
    a = v.float().abs().clamp_min(2.0**-126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def profile_proposal(gen_fn, disc_fn, z, smi):
    """Device time by kernel over one DRS proposal batch (G then D), from
    torch.profiler; the idle share is 1 - device busy time / wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        disc_fn(gen_fn(z))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device kernels only: the CPU-side ops that launched them report the
    # same time again
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    if busy == 0:
        print("profile: the profiler recorded no device time (not measured)")
        return
    print(f"profile of one proposal batch ({z.shape[0]} images, G + D): wall {wall_ms:.2f} ms, "
          f"device busy {busy:.2f} ms, idle share {1 - busy / wall_ms:.4f} [{smi}]")
    for name, ms, count in rows[:10]:
        print(f"  {ms:9.3f} ms {100 * ms / busy:6.2f}%  x{count:<4d} {name[:90]}")
    for tag in ("upfirdn2d_kernel", "flr_fwd"):
        ms = sum(r[1] for r in rows if tag in r[0])
        print(f"  {tag}: {ms:.3f} ms, {100 * ms / busy:.2f}% of device time")


def main():
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
    t0 = time.perf_counter()
    logs = _build.build_all()
    t_nvcc = time.perf_counter() - t0
    for name, log in logs.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"nvcc {name}: {'; '.join(regs) or 'up to date'}")
    t0 = time.perf_counter()
    fused_leaky_relu(torch.zeros(1, 1, device=dev), torch.zeros(1, device=dev))
    torch.cuda.synchronize()
    t_triton = time.perf_counter() - t0
    print(f"build: nvcc {t_nvcc:.2f} s, triton first launch {t_triton:.2f} s")

    # 3. kernels against their plain versions
    ch = _channels(SIZE, CH_MULT)
    k4 = torch.tensor(make_resample_kernel([1, 3, 3, 1]), device=dev)
    asym = torch.randn(3, 4, generator=gen_rng, device=dev)
    row5 = torch.randn(1, 5, generator=gen_rng, device=dev)
    small = (2, 3, 12, 9)
    cases = [(small, torch.tensor(make_resample_kernel(k), device=dev), up, down, pad)
             for up, down, pad, k in [
                 (1, 1, (1, 1), [1, 3, 3, 1]), (1, 1, (1, 1), [1, 2, 1]),
                 (1, 1, (2, 1), [1, 3, 3, 1]), (2, 1, (2, 1), [1, 3, 3, 1]),
                 (1, 2, (1, 1), [1, 3, 3, 1]), (2, 1, (1, 0), [1, 2, 1]),
                 (1, 2, (0, 0), [1, 1]), (1, 1, (-1, 2), [1, 3, 3, 1]),
                 (3, 2, (2, 2), [1, 3, 3, 1])]]
    cases += [(small, asym, 1, 1, (1, 2, 0, 1)), (small, asym, 2, 2, (2, 1)),
              (small, row5, (2, 1), 1, (2, 1, 0, 0))]
    res = 8
    while res <= SIZE:
        cases.append(((16, ch[res], res + 1, res + 1), k4 * 4, 1, 1, (1, 1)))  # G up blur
        cases.append(((16, 3, res // 2, res // 2), k4 * 4, 2, 1, (2, 1)))  # ToRGB skip
        res *= 2
    res = SIZE
    while res > 4:
        cases.append(((16, ch[res], res, res), k4, 1, 1, (2, 2)))  # D conv blur
        cases.append(((16, ch[res], res, res), k4, 1, 1, (1, 1)))  # D skip blur
        res //= 2
    err_a = 0.0
    for shape, taps, up, down, pad in cases:
        x32 = torch.randn(shape, generator=gen_rng, device=dev)
        for x in (x32, x32.bfloat16(), x32.contiguous(memory_format=torch.channels_last)):
            got = upfirdn2d(x, taps, up, down, pad)
            torch.cuda.synchronize()
            want = upfirdn2d_plain(x, taps, up, down, pad)
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"upfirdn2d {shape} shape/dtype")
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            tol = (1e-2 if x.dtype == torch.bfloat16 else 1e-5) * scale
            check(err <= tol, f"upfirdn2d {shape} up={up} down={down} pad={pad} "
                              f"{x.dtype}: err {err} > {tol}")
            if x.dtype == torch.float32:
                err_a = max(err_a, err)
    print(f"upfirdn2d: {len(cases)} shapes x (fp32, bf16, channels-last) match plain; "
          f"max abs err fp32 {err_a:.3e} (tol 1e-5 x max|out|; bf16 1e-2 x max|out|)")

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

    # 4. the serving slice at full width
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
    check(imgs.shape == (32, SIZE, SIZE, 3), f"generate shape {imgs.shape}")
    check(bool(np.isfinite(imgs).all()), "generate produced non-finite values")
    check(all(v > 0 for v in launches_gen.values()), f"generate launches {launches_gen}")
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
    check(accepted.shape == (128, SIZE, SIZE, 3), f"DRS shape {accepted.shape}")
    check(bool(np.isfinite(accepted).all()), "DRS produced non-finite values")
    check(all(v > 0 for v in launches_drs.values()), f"DRS launches {launches_drs}")
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
    xs = torch.randn((16, 3, SIZE // 2, SIZE // 2), generator=gen_rng, device=dev)
    ys = upfirdn2d(xs, taps, up=2, pad=(2, 1))
    b_s, by_s = bound((xs.numel() + ys.numel()) * 4, ys.numel() * 4 * 2)
    print(f"upfirdn2d ToRGB skip {tuple(xs.shape)} up=2: "
          f"{cuda_ms(lambda: upfirdn2d(xs, taps, up=2, pad=(2, 1))):.4f} ms, plain "
          f"{cuda_ms(lambda: upfirdn2d_plain(xs, taps, up=2, pad=(2, 1)), iters=3):.4f} ms, "
          f"bound {b_s:.4f} ms ({by_s}) [{smi}]")

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
    profile_proposal(gen_fn, disc_fn, z32, smi)

    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
