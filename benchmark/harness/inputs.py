"""What the benchmark makes from the seed and hands to both the program and
the reference: images, the phase-2 scores and the weights.

  images   uint8 (N, H, W, 3), drawn on the card in slabs and copied into
           one host array (the program then holds it on the card or streams
           it, as its trainer decides);
  scores   the Dia-GAN LDR score ldr_conf_<t>_ratio_<r> of a seeded
           synthetic logit history: clip_max_ratio(clip_min(mean + t * std,
           1e-2), r) over the snapshots (score/score.py's arithmetic);
  weights  one state_dict per network, from one normal and one uniform draw
           on the card, each leaf a slice scaled by its rule.
"""
from __future__ import annotations

import re

import numpy as np
import torch

SLAB = 1 << 30


def generator(seed, stream, device):
    """A torch.Generator on `device` for stream `stream` of `seed`."""
    return torch.Generator(device).manual_seed((int(seed) * 1000003 + int(stream)) % (1 << 63))


def images(n, size, seed, device):
    """n seeded uint8 (size, size, 3) images, drawn on `device` in slabs, as
    one host numpy array."""
    g = generator(seed, 1, device)
    per = max(1, SLAB // (size * size * 3))
    out = np.empty((n, size, size, 3), np.uint8)
    for lo in range(0, n, per):
        hi = min(n, lo + per)
        slab = torch.randint(0, 256, (hi - lo, size, size, 3), dtype=torch.uint8, generator=g,
                             device=device)
        torch.from_numpy(out[lo:hi]).copy_(slab)
    return out


def ldr_scores(n, seed, t=1.0, ratio=50, snapshots=10, floor=1e-2):
    """ldr_conf_{t}_ratio_{ratio} of a seeded logit history (snapshots, n):
    per-example means N(0, 1) and spreads |N(0, 0.5)|."""
    rng = np.random.default_rng([int(seed), 7])
    mean, spread = rng.normal(0, 1, n), np.abs(rng.normal(0, 0.5, n))
    hist = mean + spread * rng.normal(0, 1, (snapshots, n))
    score = hist.mean(0) + t * hist.std(0, ddof=1)
    score = np.clip(score, floor, None)
    return np.clip(score, None, score.min() * ratio)


def _fans(shape):
    rf = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    return shape[1] * rf, shape[0] * rf


def seeded_state(template, rules, seed, device):
    """{name: tensor} for every entry of template.state_dict() (a module on
    any device, the meta device too). rules: (regex, kind, a, b), the first
    that matches a name wins: ("normal", mean, std), ("xavier", gain) a
    Xavier-uniform weight, ("const", value)."""
    shapes = {k: (tuple(v.shape), v.dtype) for k, v in template.state_dict().items()}
    plan = {}
    for name in shapes:
        for rx, *rule in rules:
            if re.search(rx, name):
                plan[name] = rule
                break
        else:
            raise KeyError(f"no rule for {name}")
    size = {"normal": 0, "xavier": 0}
    for name, (shape, _) in shapes.items():
        if plan[name][0] in size:
            size[plan[name][0]] += int(np.prod(shape))
    g = generator(seed, 2, device)
    flat = {"normal": torch.randn(size["normal"], generator=g, device=device),
            "xavier": torch.rand(size["xavier"], generator=g, device=device) * 2 - 1}
    at = {"normal": 0, "xavier": 0}
    out = {}
    for name, (shape, dtype) in shapes.items():
        kind, *args = plan[name]
        if kind == "const":
            out[name] = torch.full(shape, args[0], dtype=dtype, device=device)
            continue
        n = int(np.prod(shape))
        v = flat[kind][at[kind]:at[kind] + n].view(shape)
        at[kind] += n
        if kind == "normal":
            out[name] = v * args[1] + args[0]
        else:
            fan_in, fan_out = _fans(shape)
            out[name] = v * (args[0] * (6.0 / (fan_in + fan_out)) ** 0.5)
    return out


STYLEGAN2_RULES = [
    (r"^mapping\.layers\.\d+\.weight$", "normal", 0.0, 100.0),  # N(0, 1 / lr_mlp)
    (r"noise\.weight$", "normal", 0.0, 0.1),
    (r"modulation\.bias$", "normal", 1.0, 0.1),
    (r"bias$", "normal", 0.0, 0.1),
    (r"(weight|input)$", "normal", 0.0, 1.0),
]
