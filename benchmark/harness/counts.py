"""The work of a window, counted from the configuration's shapes through the
benchmark's plain reference on the meta device (never from what the program
dispatches), and the shares of the card's peaks that the readers report.

  FLOPs  FlopCounterMode over the reference's step (matrix products and
         convolutions, x 2 a multiply-add), per step kind, times the
         window's steps of that kind;
  calls  every FIR, bias-act and warp call of the reference (ops.CALLS),
         with the bytes it must move (each input read once, each output
         written once) and its FLOPs; ADA's calls one by one from the draws
         the window's augment calls were given (their pad and warp depend
         on them).
"""
from __future__ import annotations

import json
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
PEAKS = json.loads((HERE / "peaks.json").read_text())
FAMILIES = HERE.parent / "metrics" / "ops_kernels"


def _memo(facts, key, fn):
    memo = facts.setdefault("memo", {})
    if key not in memo:
        memo[key] = fn()
    return memo[key]


def sg2_step_counts(facts, kind):
    from benchmark.reference.sg2_train import count_step
    return _memo(facts, ("sg2", kind), lambda: count_step(facts["cfg"], kind, facts["batch"]))


def sg2_flops(facts):
    return sum(sg2_step_counts(facts, k)[0] for k in facts["kinds"])


def sg2_calls(facts):
    from benchmark.reference.sg2_train import count_augment
    from benchmark.reference.stylegan2 import choose_pad, warp_touched
    cfg = facts["cfg"]
    calls = [c for k in facts["kinds"] for c in sg2_step_counts(facts, k)[1]]
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    for (G, C), backward in facts["aug_calls"]:
        P = choose_pad(G, cfg["size"], cfg["ada_pad_frac"])[1]
        calls += _memo(facts, ("aug", P, backward, G.shape[0]),
                       lambda: count_augment(cfg, G, C, backward, 0))
        touched = warp_touched(G, cfg["size"], cfg["ada_pad_frac"], dev)
        calls.append(("gather", touched * 3 * 4, 0))
    return calls


def drs_counts(facts):
    from benchmark.reference.sg2_train import count_forward
    flops, calls = _memo(facts, "drs", lambda: count_forward(facts["cfg"], facts["batch"]))
    return flops * facts["batches"], calls * facts["batches"]


def mfu_pct(facts, flops):
    return 100.0 * flops / facts["window_s"] / PEAKS["fp32_flops_per_s"]


def idle_pct(facts):
    return 100.0 * (1.0 - facts["busy_s"] / facts["window_s"])


def families():
    return [json.loads(p.read_text()) for p in sorted(FAMILIES.glob("*.json"))]


def ops_roofline_pct(facts, calls):
    """The least time of the calls whose kernels ran, over the device time of
    those kernels; None when none of them ran."""
    least = device = 0.0
    for fam in families():
        t = facts["trace"].device_time(fam["kernels"])
        if t <= 0:
            continue
        device += t
        least += sum(max(b / PEAKS["hbm_bytes_per_s"], f / PEAKS["fp32_flops_per_s"])
                     for op, b, f in calls if op in fam["ops"])
    return 100.0 * least / device if device > 0 else None

