"""Discriminator Rejection Sampling over StyleGAN2's G_ema and the twin D, as
an evaluation draws its samples: `DRS.generate_images` in a closed loop of
one client, requests of `request` accepted uint8 images back to back.

Set-up: the seeded weights, the sampler (its warm-up batches set the running
max of the logits), one request of a single image through the accept path.
Window: requests until `--seconds` have passed on the host clock. Metric:
accepted images delivered over the window's time.

The benchmark's closures hand G the latents the sampler drew and per-layer
noises drawn from a generator of the benchmark's, seeded per batch, and
keep each batch's latents and logits (references, no copies) and the
sampler's accepted count before it. After the window, a sample of the
window's batches drawn from the seed is computed again by the reference:
the logits, and every served image of those batches against the
reference's images of the batch, in proposal order. The accepted counts of
all batches are held against the acceptance probabilities that the
reference's arithmetic gives for the program's logits (following the
program's running max, which it checks on the sampled batches).
"""
from __future__ import annotations

import collections
import gc
import math
import time

import numpy as np
import torch

from benchmark.harness import inputs
from benchmark.harness.core import log, peak_bytes, sync
from benchmark.harness.trace import span, traced
from benchmark.reference import drs as ref_drs
from benchmark.reference import sg2_train as ref
from benchmark.reference.stylegan2 import noise_shapes


def seeded(cfg, prm, seed, device):
    """G_ema's and the twin D's weights. The D's logit layer is drawn at
    std `logit_weight_std`: logits spread so far apart that every accept
    probability is 0 or 1, each batch accepts its top fifth (above the 80th
    percentile's gamma), and every seed asks for the same number of
    proposals a request."""
    meta = ref.models(cfg, torch.device("meta"))
    d_rules = [(r"^out_linear\.weight$", "normal", 0.0, prm["logit_weight_std"])]
    return {"g": inputs.seeded_state(meta[0], inputs.STYLEGAN2_RULES, seed * 8, device),
            "drs": inputs.seeded_state(meta[2], d_rules + inputs.STYLEGAN2_RULES, seed * 8 + 2,
                                       device)}


def noises(cfg, seed, b, n, device):
    g = inputs.generator(seed, 100 + b, device)
    return [torch.randn(s, generator=g, device=device) for s in noise_shapes(cfg["size"], n)]


def run(ctx, device):
    from diagan_tpu_torch.eval.drs import DRS
    from diagan_tpu_torch.models.stylegan2 import StyleGAN2Discriminator, StyleGAN2Generator
    cfg, R = ctx.config, ctx.params["request"]
    kw = dict(size=cfg["size"], channel_multiplier=cfg["channel_multiplier"],
              width_scale=cfg.get("width_scale", 1.0), device=device)
    gen = StyleGAN2Generator(style_dim=cfg["style_dim"], n_mlp=cfg["n_mlp"], **kw)
    disc = StyleGAN2Discriminator(**kw)
    state = seeded(cfg, ctx.params, ctx.seed, device)
    gen.load_state_dict(state["g"])
    disc.load_state_dict(state["drs"])
    gen.eval()
    disc.eval()
    zs, lds, acc = [], [], []
    box = {}

    def gen_fn(z):
        zs.append(z)
        return gen(z, noises=noises(cfg, ctx.seed, len(zs) - 1, z.shape[0], device))

    def disc_fn(x):
        acc.append(box["drs"].accepted if "drs" in box else 0)
        lds.append(disc(x)[0])
        return lds[-1]

    box["drs"] = sampler = DRS(gen_fn, disc_fn, cfg["style_dim"],
                               generator=inputs.generator(ctx.seed, 3, device),
                               batch_size=cfg["drs_batch"], percentile=cfg["drs_percentile"],
                               warmup_batches=cfg["drs_warmup_batches"], device=device)
    n_warm = len(zs)
    ctx.mark("models and the sampler's warm-up")
    sampler.generate_images(1, return_uint8=True)
    sync(device)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    requests = []
    p0, a0 = sampler.proposed, sampler.accepted
    first = len(zs)
    with traced(ctx.trace) as trace:
        ctx.start_window()  # after the profiler has started, in a traced run
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx.seconds:
            b0 = len(zs)
            with span("drs_request"):
                out = sampler.generate_images(R, return_uint8=True)
            requests.append((b0, len(zs), out))
        sync(device)
        window = time.perf_counter() - t0
    proposed, accepted = sampler.proposed - p0, sampler.accepted - a0
    acc.append(sampler.accepted)
    ctx.e2e[ctx.workload["metric"]] = R * len(requests) / window
    ctx.attempted = len(requests)
    ctx.failed = sum(len(o) != R for _, _, o in requests)
    ctx.facts.update(window_s=window, batches=len(zs) - first, cfg=cfg, batch=cfg["drs_batch"],
                     proposed=proposed, accepted=accepted, memory_peak_bytes=peak_bytes(device))
    if ctx.trace:
        ctx.facts.update(trace=trace, busy_s=trace.busy_s(), breakdown={
            "device_ops": trace.device_ops(), "idle_gaps": trace.idle_gaps()})
    log(f"window: {len(requests)} requests of {R}, {len(zs) - first} batches, acceptance "
        f"{accepted / max(proposed, 1):.4f}, in {window:.4f} s")
    per_batch = collections.Counter(acc[b + 1] - acc[b] for b in range(first, len(zs)))
    log(f"batches a request {[b1 - b0 for b0, b1, _ in requests]}; accepted a batch "
        f"{dict(sorted(per_batch.items()))}")
    log(f"memory peak: {ctx.facts['memory_peak_bytes']} bytes")
    del gen, disc, sampler, box
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    check(ctx, device, zs, lds, acc, n_warm, first, requests)


def reference_batch(cfg, models, seed, b, z, device):
    """The reference's (images NHWC, logits) of proposal batch b."""
    g, d = models
    with torch.no_grad():
        imgs = g.sample([z.to(device)], g.n_latent, noises(cfg, seed, b, z.shape[0], device))
        return imgs, d(imgs)


def match(served, ref_codes):
    """Served uint8 images of one batch against the reference codes of all
    its images: (the widest excess of a served code outside [code - 1,
    code] of its match, in codes; how often the matches leave proposal
    order)."""
    worst, last, disorder = 0.0, -1, 0
    for img in served:
        o = torch.from_numpy(img).to(ref_codes.device).double()
        ex = torch.maximum(o - ref_codes, ref_codes - o - 1).clamp(min=0)
        ex = ex.flatten(1).max(1).values
        j = int(ex.argmin())
        worst = max(worst, float(ex[j]))
        disorder += j <= last
        last = j
    return worst, disorder


def accept_z(cfg, lds, acc, n_warm, all_accepted=False):
    """|accepted - expected| / its standard deviation over every proposal
    batch, the expectation from the reference's arithmetic on the program's
    logits and running max (all_accepted: the fault that accepts all)."""
    m = -1e5
    for ld in lds[:n_warm]:
        m = max(m, float(ld.max()))
    mean = var = 0.0
    for b in range(n_warm, len(lds)):
        p, m = ref_drs.accept_prob(lds[b].double(), m, cfg["drs_percentile"])
        k = len(p) if all_accepted else acc[b + 1] - acc[b]
        mean += float(p.sum()) - k
        var += float((p * (1 - p)).sum())
    # one unit of variance more: near-certain decisions leave almost none
    return abs(mean) / math.sqrt(var + 1.0)


def check(ctx, device, zs, lds, acc, n_warm, first, requests):
    from benchmark.reference.precision import lowered
    cfg, prm = ctx.config, ctx.params
    t0 = time.perf_counter()
    z_acc = accept_z(cfg, lds, acc, n_warm)
    rng = np.random.default_rng([int(ctx.seed), 11])
    window = list(range(first, len(zs)))
    picks = sorted(int(b) for b in rng.choice(window, size=min(prm["sampled_batches"],
                                                               len(window)), replace=False))
    state = seeded(cfg, ctx.params, ctx.seed, device)
    g, _, d = ref.models(cfg, device)
    g.load_state_dict(state["g"])
    d.load_state_dict(state["drs"])
    controls = {c: [0.0, 0.0] for c in ctx.controls if c in ("tf32", "altered")}
    logit_gap = image_gap = 0.0
    disorder = 0
    for b in picks:
        imgs, logits = reference_batch(cfg, (g, d), ctx.seed, b, zs[b], device)
        codes = ref_drs.codes(imgs)
        logit_gap = max(logit_gap, _logit_gap(lds[b], logits))
        b0, b1, out = next(r for r in requests if r[0] <= b < r[1])
        off = acc[b] - acc[b0]
        served = out[off:off + min(acc[b + 1] - acc[b], len(out) - off)]
        if len(served):
            gap, dis = match(served, codes)
            image_gap, disorder = max(image_gap, gap), disorder + dis
        if "tf32" in controls:  # the reference one precision below, served whole
            with lowered("tf32", device.type):
                ci, cl = reference_batch(cfg, (g, d), ctx.seed, b, zs[b], device)
            c = controls["tf32"]
            c[0] = max(c[0], _logit_gap(cl, logits))
            c[1] = max(c[1], match(ref_drs.to_uint8(ci), codes)[0])
        if "altered" in controls and len(served):  # a served code altered where it is made
            alt = served.copy()
            alt[:, 0, 0, 0] = np.where(alt[:, 0, 0, 0] < 255, alt[:, 0, 0, 0] + 1, 0)
            controls["altered"][1] = max(controls["altered"][1], match(alt, codes)[0])
    log(f"reference: {len(picks)} batches {picks} computed again in "
        f"{time.perf_counter() - t0:.2f} s; accepted counts' z {z_acc:.4f} over "
        f"{len(lds) - n_warm} batches")
    read = ctx.facts.setdefault("controls", {})
    for c, (lg, ig) in controls.items():
        read[c] = {"logit_gap": lg, "image_gap": ig}
        log(f"control {c}: logit_gap {lg!r} image_gap {ig!r}")
    if "accept_all" in ctx.controls:
        read["accept_all"] = {"accept_z": accept_z(cfg, lds, acc, n_warm, True)}
        log(f"control accept_all: accept_z {read['accept_all']['accept_z']!r}")
    lim = ctx.workload["limits"]
    ctx.checks += [("logit_gap", logit_gap, lim["logit_gap"]),
                   ("image_gap", image_gap, lim["image_gap"]),
                   ("accept_z", z_acc, lim["accept_z"]),
                   ("disorder", float(disorder), 0.0)]


def _logit_gap(prog, ref_logits):
    """The widest |program - reference| of a batch's logits over the larger
    of 1 and their RMS (the logits' scale; one near zero is no scale)."""
    r = ref_logits.double()
    return float((prog.double() - r).abs().max() / max(1.0, float(r.pow(2).mean().sqrt())))
