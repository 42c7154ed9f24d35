"""Discriminator Rejection Sampling over StyleGAN3-T's G and the twin D, as an
evaluation draws its samples through the program's normal path: the
registry's `ffhq` / `stylegan3` bundle, eval.evaluate's closures and
`DRS.generate_images`, in a closed loop of one client, requests of `request`
accepted uint8 images back to back.

Set-up: the seeded weights (each layer's magnitude_ema from the reference's
calibration batch), the sampler (its warm-up batches set the running max of
the logits), one request of a single image through the accept path.
Window: requests until `--seconds` have passed on the host clock. Metric:
accepted images delivered over the window's time.

The closures keep each batch's latents and logits (references, no copies)
and the sampler's accepted count before it. After the window, a sample of
the window's batches drawn from the seed is computed again by the
reference (G in blocks, the twin D on the whole batch, as its minibatch
statistics group the batch): the logits, and every served image of those
batches against the reference's images of the batch, in proposal order.
The accepted counts of all batches are held against the acceptance
probabilities that the reference's arithmetic gives for the program's
logits. The comparison's pieces are traffic/drs.py's.

Controls (`--controls`, for setting the limits): "tf32" the reference one
precision below; "l10_filter" the program's G built with L10's up filter
designed at layer 8's cutoff in place of layer 9's; "altered" and
"accept_all" as in traffic/drs.py.
"""
from __future__ import annotations

import collections
import gc
import time
from unittest import mock

import numpy as np
import torch

from benchmark.harness import inputs
from benchmark.harness.core import log, peak_bytes, sync
from benchmark.harness.trace import span, traced
from benchmark.reference import drs as ref_drs
from benchmark.reference import stylegan3 as ref
from benchmark.traffic.drs import _logit_gap, accept_z, match

G_RULES = [
    (r"^mapping\.fc\d+\.weight$", "normal", 0.0, 100.0),  # N(0, 1 / lr)
    (r"^mapping\.fc\d+\.bias$", "normal", 0.0, 0.1),
    (r"^synthesis\.input\.affine\.weight$", "normal", 0.0, 0.1),
    (r"\.affine\.weight$", "normal", 0.0, 1.0),
    (r"\.affine\.bias$", "normal", 1.0, 0.1),
    (r"\.bias$", "normal", 0.0, 0.1),
    (r"\.weight$", "normal", 0.0, 1.0),
    (r"(w_avg|transform|freqs|phases|magnitude_ema|_filter)$", "const", 0.0),  # below
]


def load(module, state):
    """Load `state` into `module`; the module keeps the filters it designed."""
    missing, unexpected = module.load_state_dict(state, strict=False)
    if unexpected or any(not k.endswith("_filter") for k in missing):
        raise KeyError(f"state and module differ: missing {missing}, unexpected {unexpected}")


def seeded(cfg, prm, seed, device):
    """G's and the twin D's weights, without G's magnitude_ema (ones; see
    `calibrated`) and without its filters. The D's logit layer is drawn at
    std `logit_weight_std`, as in traffic/drs.py."""
    g_meta, d_meta = ref.models(cfg, torch.device("meta"))
    g = inputs.seeded_state(g_meta, G_RULES, seed * 8, device)
    for k in [k for k in g if k.endswith("_filter")]:
        del g[k]
    for k in [k for k in g if k.endswith("magnitude_ema")]:
        g[k] = torch.ones((), device=device)
    g["synthesis.input.affine.bias"] = torch.tensor([1.0, 0.0, 0.0, 0.0], device=device)
    g["synthesis.input.transform"] = torch.eye(3, device=device)
    draw = inputs.generator(seed, 4, device)
    f = torch.randn(g["synthesis.input.freqs"].shape, generator=draw, device=device)
    r = f.square().sum(1, keepdim=True).sqrt()
    g["synthesis.input.freqs"] = f / (r * r.square().exp().pow(0.25)) * ref.schedule(cfg)[1][
        "bandwidth"]
    g["synthesis.input.phases"] = torch.rand(f.shape[0], generator=draw, device=device) - 0.5
    d_rules = [(r"^out_linear\.weight$", "normal", 0.0, prm["logit_weight_std"])]
    return {"g": g, "drs": inputs.seeded_state(d_meta, d_rules + inputs.STYLEGAN2_RULES,
                                               seed * 8 + 2, device)}


def calibrated(cfg, prm, seed, device):
    """(the seeded state with each layer's magnitude_ema the mean square of
    its input over a seeded batch of `calibration_batch`, the reference's G
    and twin D loaded with it)."""
    state = seeded(cfg, prm, seed, device)
    g, d = ref.models(cfg, device)
    load(g, state["g"])
    d.load_state_dict(state["drs"])
    z = torch.randn((prm["calibration_batch"], cfg["z_dim"]),
                    generator=inputs.generator(seed, 5, device), device=device)
    for name, ms in ref.calibrate(g, z).items():
        state["g"][f"synthesis.{name}.magnitude_ema"] = ms.clone()
    g.eval()
    d.eval()
    return state, (g, d)


def l10_filter_fault(module):
    """A schedule whose layer 10 designs its up filter at layer 8's cutoff
    (the program's synthesis_schedule, patched in `module`)."""
    schedule = module.synthesis_schedule

    def faulty(*args, **kwargs):
        inp, layers = schedule(*args, **kwargs)
        layers[10] = dict(layers[10], in_cutoff=layers[9]["in_cutoff"])
        return inp, layers

    return mock.patch.object(module, "synthesis_schedule", faulty)


def program(cfg, state, device):
    """(G, twin D) of the registry's ffhq / stylegan3 bundle, loaded."""
    from diagan_tpu_torch.models.registry import get_gan_model
    bundle = get_gan_model("ffhq", model="stylegan3", drs=True, device=device,
                           size=cfg["img_resolution"])
    load(bundle.gen, state["g"])
    bundle.disc_drs.load_state_dict(state["drs"])
    return bundle.gen, bundle.disc_drs


def run(ctx, device):
    from diagan_tpu_torch.eval.drs import DRS
    from diagan_tpu_torch.eval.evaluate import make_disc_fn, make_gen_fn
    from diagan_tpu_torch.models import stylegan3  # noqa: F401 (a program without it stops here)
    cfg, prm, R = ctx.config, ctx.params, ctx.params["request"]
    state, reference = calibrated(cfg, prm, ctx.seed, device)
    gen, disc = program(cfg, state, device)
    gen_closure, disc_closure = make_gen_fn(gen), make_disc_fn(disc)
    zs, lds, acc = [], [], []
    box = {}

    def gen_fn(z):
        zs.append(z)
        return gen_closure(z)

    def disc_fn(x):
        acc.append(box["drs"].accepted if "drs" in box else 0)
        lds.append(disc_closure(x))
        return lds[-1]

    box["drs"] = sampler = DRS(gen_fn, disc_fn, cfg["z_dim"],
                               generator=inputs.generator(ctx.seed, 3, device),
                               batch_size=cfg["drs_batch"], percentile=cfg["drs_percentile"],
                               warmup_batches=cfg["drs_warmup_batches"], device=device)
    n_warm = len(zs)
    ctx.mark("models, calibration and the sampler's warm-up")
    sampler.generate_images(1, return_uint8=True)
    sync(device)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    requests = []
    first = len(zs)
    p0, a0 = sampler.proposed, sampler.accepted
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
    del gen, disc, sampler, box, gen_closure, disc_closure
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    check(ctx, device, state, reference, zs, lds, acc, n_warm, first, requests)


def reference_batch(models, z, block):
    """The reference's (images NHWC, logits) of one proposal batch: G in
    blocks of `block` latents, D on the whole batch."""
    g, d = models
    with torch.no_grad():
        imgs = torch.cat([g(z[i:i + block]) for i in range(0, z.shape[0], block)])
        return imgs, d(imgs)


def check(ctx, device, state, reference, zs, lds, acc, n_warm, first, requests):
    from benchmark.reference.precision import lowered
    cfg, prm = ctx.config, ctx.params
    t0 = time.perf_counter()
    z_acc = accept_z(cfg, lds, acc, n_warm)
    rng = np.random.default_rng([int(ctx.seed), 11])
    window = list(range(first, len(zs)))
    picks = sorted(int(b) for b in rng.choice(window, size=min(prm["sampled_batches"],
                                                               len(window)), replace=False))
    block = prm["reference_block"]
    controls = {c: [0.0, 0.0] for c in ctx.controls if c in ("tf32", "altered", "l10_filter")}
    faulty = None
    if "l10_filter" in controls:
        from diagan_tpu_torch.models import stylegan3
        with l10_filter_fault(stylegan3):
            faulty = program(cfg, state, device)[0].eval()
    logit_gap = image_gap = 0.0
    disorder = 0
    for b in picks:
        imgs, logits = reference_batch(reference, zs[b], block)
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
                ci, cl = reference_batch(reference, zs[b], block)
            c = controls["tf32"]
            c[0] = max(c[0], _logit_gap(cl, logits))
            c[1] = max(c[1], match(ref_drs.to_uint8(ci), codes)[0])
        if faulty is not None:  # the program's G with L10's wrong filter, served whole
            with torch.no_grad():
                fi = torch.cat([faulty(zs[b][i:i + block])
                                for i in range(0, zs[b].shape[0], block)])
                fl = reference[1](fi)
            c = controls["l10_filter"]
            c[0] = max(c[0], _logit_gap(fl, logits))
            c[1] = max(c[1], match(ref_drs.to_uint8(fi), codes)[0])
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
