"""The benchmark's run: find the cell's files by name, check the card, set the
cache directories inside the checkout, hand the cell to its traffic driver,
then print the readings and the result's line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything of one cell is found by name: `BENCHMARK.json` (the cell's
end-to-end and per-layer metrics), `benchmark/workloads/<cell>.json` (its
configuration, traffic driver and parameters), `benchmark/configs/
<config>.json` (the configuration as it is run), `benchmark/traffic/
<driver>.py` (the driver of that kind of traffic) and `benchmark/metrics/
<metric>.py` (one reader per per-layer metric).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "diagan_tpu")
CACHE_DIR = BENCH_DIR / ".cache"


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name=None):
    """A Python file as a module, whatever characters its name holds."""
    spec = importlib.util.spec_from_file_location(name or f"_bench_{Path(path).stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(name, bench_dir=BENCH_DIR, spec=None):
    """(workload, config, end-to-end specs, per-layer specs) of cell `name`."""
    spec = spec if spec is not None else load_json(bench_dir.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    workload = load_json(bench_dir / "workloads" / f"{name}.json")
    config = load_json(bench_dir / "configs" / f"{workload['config']}.json")

    def here(m):
        return name in m.get("workloads", cells)

    e2e = [m for m in spec["end_to_end"] if here(m)]
    per_layer = [m for m in spec["per_layer"] if here(m)]
    return workload, config, e2e, per_layer


def loaded_forbidden(modules=None):
    """Top-level names of loaded modules that are the JAX stack or the JAX
    package, compared whole (`diagan_tpu_torch` is not `diagan_tpu`)."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def fix_caches():
    """Kernel caches at fixed paths inside the checkout: Triton's here, the
    program's nvcc and g++ builds in its own build directory."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")


class Context:
    """What a driver is given, and what it hands back for the readers."""

    def __init__(self, args, workload, config, t0):
        self.seed, self.seconds, self.trace = args.seed, args.seconds, bool(args.trace)
        self.workload, self.config, self.t0 = workload, config, t0
        self.params = workload["params"]
        self.facts = {}  # what the per-layer readers read
        self.e2e = {}  # end-to-end values by metric name
        self.checks = []  # (name, value, limit) compared for `correct`
        self.attempted = self.failed = 0
        self.setup_s = None
        self.controls = [c for c in getattr(args, "controls", "").split(",") if c]
        self.scratch = None  # a temporary directory the program may write to

    def mark(self, what):
        """Log the time since the process started, at a point of set-up."""
        log(f"set-up, {what}: {time.perf_counter() - self.t0:.2f} s")

    def start_window(self):
        """Called by the driver right before its first timed step."""
        self.setup_s = time.perf_counter() - self.t0


def sync(device):
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


def peak_bytes(device):
    """The card's peak of allocated memory since the last reset (0 elsewhere)."""
    import torch
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def verdict(checks):
    """(correct, the checks with a number that is not finite as None): every
    number at or under its limit, and at least one number."""
    checks = [(n, v if math.isfinite(v) else None, lim) for n, v, lim in checks]
    return bool(checks) and all(v is not None and v <= lim for _, v, lim in checks), checks


def card_info():
    import subprocess

    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return torch.cuda.get_device_name(0), (smi.stdout.strip().splitlines() or ["?"])[0]


def main(argv=None, t0=None):
    t0 = time.perf_counter() if t0 is None else t0
    p = argparse.ArgumentParser(description="One run of one benchmark cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--controls", default="", help="for setting the limits only: also compute "
                   "the numbers of the control and the faults put in the program's place")
    args = p.parse_args(argv)
    fix_caches()
    workload, config, e2e, per_layer = find_cell(args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
        log(f"no card: cuda available {torch.cuda.is_available()}, "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} of "
            f"{workload['chips']} cards")
        return 2
    name, smi = card_info()
    log(f"card: {smi} (count {torch.cuda.device_count()})")
    torch.backends.cudnn.allow_tf32 = False  # the configurations' IEEE fp32
    torch.backends.cuda.matmul.allow_tf32 = False

    ctx = Context(args, workload, config, t0)
    driver = load_module(BENCH_DIR / "traffic" / f"{workload['driver']}.py")
    with tempfile.TemporaryDirectory(prefix="bench_") as scratch:
        ctx.scratch = scratch
        driver.run(ctx, torch.device("cuda"))

    metrics = {}
    if ctx.trace:
        for m in per_layer:
            reader = load_module(BENCH_DIR / "metrics" / f"{m['name']}.py")
            value = reader.read(ctx.facts)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        ctx.e2e["setup_s"] = ctx.setup_s
        for m in e2e:
            metrics[m["name"]] = {"value": ctx.e2e[m["name"]], "unit": m["unit"]}
    for k, v in metrics.items():
        log(f"metric {k}: {v['value']!r} {v['unit']}")

    bad = loaded_forbidden()
    if bad:
        log(f"refused: the run loaded {bad}")
        return 3
    device = {"platform": "gpu", "kind": name, "count": workload["chips"],
              "memory_peak_bytes": ctx.facts["memory_peak_bytes"]}
    if ctx.trace:
        device["busy_s"], device["window_s"] = ctx.facts["busy_s"], ctx.facts["window_s"]
    correct, checks = verdict(ctx.checks)
    line = {"correct": correct, "attempted": ctx.attempted, "failed": ctx.failed,
            "metrics": metrics, "device": device}
    if ctx.trace and "breakdown" in ctx.facts:
        line["breakdown"] = ctx.facts["breakdown"]
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    for n, v, lim in checks:
        log(f"check {n}: {v!r} limit {lim!r} {'ok' if v is not None and v <= lim else 'FAIL'}")
    print(json.dumps(line), flush=True)
    return 0
