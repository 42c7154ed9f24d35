"""A benchmark run on the CPU at a size a test can hold: the harness's look
for a card is skipped, the driver runs with the configuration narrowed (its
widths through the `width_scale` test knob, its data and batches cut). The
cell's files are read by name."""
import time
import types

import torch

from benchmark.harness import core

TINY = {
    "sg2_256.p2_train": dict(size=32, width_scale=1 / 32, num_images=64, style_dim=32, batch=4,
                             n_mlp=2),
    "sg2_256.drs": dict(size=32, width_scale=1 / 32, style_dim=32, n_mlp=2, drs_batch=16,
                        drs_warmup_batches=2),
}


def run_cell(cell, tmp_path, monkeypatch, seconds=0.5, seed=2 ** 31 + 7, controls=""):
    """(correct, checks, ctx) of one run of `cell` on the CPU at its tiny size."""
    workload = core.load_json(core.BENCH_DIR / "workloads" / f"{cell}.json")
    config = core.load_json(core.BENCH_DIR / "configs" / f"{workload['config']}.json")
    config = dict(config, **TINY[cell])
    if cell == "sg2_256.drs":
        workload = dict(workload, params=dict(workload["params"], request=20))
    args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=0, controls=controls)
    ctx = core.Context(args, workload, config, time.perf_counter())
    ctx.scratch = str(tmp_path)
    driver = core.load_module(core.BENCH_DIR / "traffic" / f"{workload['driver']}.py")
    driver.run(ctx, torch.device("cpu"))
    correct, checks = core.verdict(ctx.checks)
    return correct, {n: v for n, v, _ in checks}, ctx
