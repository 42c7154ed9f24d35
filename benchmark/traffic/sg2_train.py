"""StyleGAN2 Dia-GAN phase-2 training with live ADA, as
`cli.train_ffhq_phase2 --augment` runs it: `StyleGAN2Trainer.train_step`
with the twin DRS discriminator, weighted reals from the phase-2 scores,
then `tune_ada`, one step after another.

Set-up: the seeded images (the trainer streams them from the host when they
exceed its on-card budget, as for FFHQ), the scores, the seeded weights,
the trainer with ADA's p at the configuration's resume point; then one
whole period of `d_reg_every` steps from global step `start_step` (a
multiple of the period), whose first `follow_steps` are recorded for the
reference; the dataset rows of every real batch of the period are
recorded for the draw numbers. Window: whole periods, ending at the first
period boundary after `--seconds`, so every run holds the published mix of
R1, path-length and plain steps. Metric: real images shown to the main D
(batch a step) over the window's time.

After the window: peak memory, the port's launch counters, the program
freed, then the reference follows the recorded steps (compare.py), and the
warm period's rows are held against the scores (`draw_gaps`).
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark.harness import compare, inputs
from benchmark.harness.core import log, peak_bytes, sync
from benchmark.harness.trace import span, traced
from benchmark.reference import sg2_train as ref

STEP_METHODS = ("d_step", "r1_step", "g_step", "path_step")


def _host(t):
    return t.detach().cpu()


class RowIndex:
    """Which dataset rows a real batch holds: by the first eight bytes of each
    image, then checked whole."""

    def __init__(self, images):
        keys = np.ascontiguousarray(images.reshape(len(images), -1)[:, :8]).view(np.uint64)
        self.images, self.rows = images, {int(k): i for i, k in enumerate(keys.ravel())}
        self.mismatched = 0

    def __call__(self, real):
        codes = ((real.detach() + 1) * 127.5).round().clamp(0, 255).to(torch.uint8).cpu().numpy()
        keys = np.ascontiguousarray(codes.reshape(len(codes), -1)[:, :8]).view(np.uint64).ravel()
        rows = np.array([self.rows.get(int(k), -1) for k in keys])
        ok = (rows >= 0) & np.array([r >= 0 and np.array_equal(codes[i], self.images[r])
                                     for i, r in enumerate(rows)])
        self.mismatched += int((~ok).sum())
        return np.where(ok, rows, 0)


def record_calls(tr, calls, rows_of=None):
    """Wrap the trainer's step methods (their draws are their arguments) so
    each call appends what it was given and what it returned. rows_of=None
    records only the augment draws (the traced window)."""
    orig = {k: getattr(tr, k) for k in STEP_METHODS}

    def net(disc):
        return "drs" if disc is tr.drs_disc else "d"

    def fake(fd):
        return (_host(fd.z1), _host(fd.z2), int(fd.cutoff), [_host(n) for n in fd.noises])

    def d_step(disc, optim, real, fd, ar, af):
        out = orig["d_step"](disc, optim, real, fd, ar, af)
        c = {"kind": "d", "net": net(disc), "augs": [(ar, False), (af, False)]}
        if rows_of is not None:
            c.update(rows=rows_of(real), fake=fake(fd), aug_real=ar, aug_fake=af,
                     loss=float(out["d"]), sign=float(out["sign_real"]))
        calls.append(c)
        return out

    def r1_step(disc, optim, real, aug):
        out = orig["r1_step"](disc, optim, real, aug)
        c = {"kind": "r1", "net": net(disc), "augs": [(aug, False)]}
        if rows_of is not None:
            c.update(rows=rows_of(real), aug=aug, loss=float(out["r1"]))
        calls.append(c)
        return out

    def g_step(fd, aug):
        out = orig["g_step"](fd, aug)
        c = {"kind": "g", "augs": [(aug, True)]}
        if rows_of is not None:
            c.update(fake=fake(fd), aug=aug, loss=float(out["g"]))
        calls.append(c)
        return out

    def path_step(z, noises, path_noise):
        out = orig["path_step"](z, noises, path_noise)
        c = {"kind": "path", "augs": []}
        if rows_of is not None:
            c.update(z=_host(z), noises=[_host(n) for n in noises], path_noise=_host(path_noise),
                     loss=float(out["path"]))
        calls.append(c)
        return out

    for k, fn in zip(STEP_METHODS, (d_step, r1_step, g_step, path_step)):
        setattr(tr, k, fn)
    return lambda: [delattr(tr, k) for k in STEP_METHODS]


def build(ctx, device, imgs, scores):
    """The port's trainer with the seeded weights."""
    from diagan_tpu_torch.models.stylegan2 import StyleGAN2Discriminator, StyleGAN2Generator
    from diagan_tpu_torch.train.stylegan2_trainer import StyleGAN2Trainer
    cfg = ctx.config
    meta = ref.models(cfg, torch.device("meta"))
    state = {k: inputs.seeded_state(m, inputs.STYLEGAN2_RULES, ctx.seed * 8 + i, device)
             for i, (k, m) in enumerate(zip(("g", "d", "drs"), meta))}
    kw = dict(size=cfg["size"], channel_multiplier=cfg["channel_multiplier"],
              width_scale=cfg.get("width_scale", 1.0), device=device)
    gen = StyleGAN2Generator(style_dim=cfg["style_dim"], n_mlp=cfg["n_mlp"], **kw)
    disc, drs = StyleGAN2Discriminator(**kw), StyleGAN2Discriminator(**kw)
    for m, k in ((gen, "g"), (disc, "d"), (drs, "drs")):
        m.load_state_dict(state[k])
    tr = StyleGAN2Trainer(
        ctx.scratch, gen, disc, imgs, num_steps=10 ** 9, drs_disc=drs, sample_weights=scores,
        batch_size=cfg["batch"], lr=cfg["lr"], r1_weight=cfg["r1"],
        path_regularize=cfg["path_regularize"], d_reg_every=cfg["d_reg_every"],
        g_reg_every=cfg["g_reg_every"], path_batch_shrink=cfg["path_batch_shrink"],
        mixing=cfg["mixing"], augment_p=0.0, ada_target=cfg["ada_target"],
        ada_length=cfg["ada_length"], ada_pad_frac=cfg["ada_pad_frac"], seed=ctx.seed,
        device=device)
    tr.ada_aug_p = tr.ada.ada_aug_p = float(cfg["ada_p_start"])
    return tr


def run(ctx, device):
    cfg, prm = ctx.config, ctx.params
    period, batch = cfg["d_reg_every"], cfg["batch"]
    start, n_follow = prm["start_step"], prm["follow_steps"]
    if start % period:
        raise ValueError(f"start_step {start} is not a multiple of the period {period}")
    imgs = inputs.images(cfg["num_images"], cfg["size"], ctx.seed, device)
    scores = inputs.ldr_scores(cfg["num_images"], ctx.seed, **cfg["score"])
    rows_of = RowIndex(imgs)
    ctx.mark("images, scores and row index")
    tr = build(ctx, device, imgs, scores)
    ctx.mark("trainer")
    log(f"set-up: {cfg['num_images']} images, stream {tr.stream}")

    calls, steps, first = [], [], {}
    remove = record_calls(tr, calls, rows_of)
    hooks = [compare.record_first_step(o, m, first, k) for k, o, m in (
        ("g", tr.g_optim, tr.gen), ("d", tr.d_optim, tr.disc), ("drs", tr.drs_optim, tr.drs_disc))]
    for t in range(start, start + period):  # the warm period, a whole one
        n0 = len(calls)
        with span("train_step"):
            m = tr.train_step(t)
        with span("tune_ada"):
            tr.tune_ada(m)
        if t - start < n_follow:
            steps.append({"t": t, "calls": calls[n0:]})
            if t - start == n_follow - 1:
                for h in hooks:
                    h.remove()
                after = {k: {n: p.detach().to("cpu", copy=True) for n, p in mod.named_parameters()}
                         for k, mod in (("g", tr.gen), ("d", tr.disc), ("drs", tr.drs_disc),
                                        ("g_ema", tr.g_ema))}
    remove()
    drawn = drawn_rows(calls)
    sync(device)
    ctx.mark("the warm period")

    from diagan_tpu_torch.ops import _build
    _build.reset_launches()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    window_calls = []
    if ctx.trace:
        remove = record_calls(tr, window_calls)
    t, done = start + period, 0
    with traced(ctx.trace) as trace:
        ctx.start_window()  # after the profiler has started, in a traced run
        t0 = time.perf_counter()
        while True:
            for _ in range(period):
                with span("train_step"):
                    m = tr.train_step(t)
                with span("tune_ada"):
                    tr.tune_ada(m)
                t, done = t + 1, done + 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        sync(device)
        window = time.perf_counter() - t0
    if ctx.trace:
        remove()
    kinds = [ref.step_kind(s, cfg) for s in range(start + period, t)]
    ctx.e2e[ctx.workload["metric"]] = batch * done / window
    ctx.attempted = done
    ctx.facts.update(window_s=window, kinds=kinds, cfg=cfg, batch=batch,
                     memory_peak_bytes=peak_bytes(device), aug_calls=[
                         a for c in window_calls for a in c["augs"] if a[0] is not None])
    if ctx.trace:
        ctx.facts.update(trace=trace, busy_s=trace.busy_s(), breakdown={
            "device_ops": trace.device_ops(), "idle_gaps": trace.idle_gaps()})
    log(f"window: {done} steps ({kinds.count('r1+path')} R1 + path, {kinds.count('path')} path, "
        f"{kinds.count('plain')} plain) in {window:.4f} s; ADA p {tr.ada_aug_p:.6f}")
    log(f"launches: {_build.LAUNCHES}; kernel A by instance {_build.FIR_INSTANCES}")
    log(f"memory peak: {ctx.facts['memory_peak_bytes']} bytes")
    if "swapped_draws" in ctx.controls:  # the fault: weighted and uniform draws swapped
        draw_real, fault_calls = tr.draw_real, []
        tr.draw_real = lambda weighted: draw_real(not weighted)
        remove = record_calls(tr, fault_calls, RowIndex(imgs))
        for s in range(t, t + period):
            tr.train_step(s)
        remove()
        read = dict(zip(DRAW_NUMBERS, draw_gaps(scores, drawn_rows(fault_calls))))
        ctx.facts.setdefault("controls", {})["swapped_draws"] = read
        log(f"control swapped_draws: {read}")

    del tr, m
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    check(ctx, device, imgs, scores, steps, first, after, rows_of, drawn)


def drawn_rows(calls):
    """{net: the dataset rows of every real batch that net was given}."""
    out = {"d": [], "drs": []}
    for c in calls:
        if "rows" in c:
            out[c["net"]].extend(int(r) for r in c["rows"])
    return out


DRAW_NUMBERS = ("weighted_draw_gap", "uniform_draw_gap")


def draw_gaps(scores, drawn):
    """(weighted, uniform): how far the mean of weight x N over the main D's
    rows lies from mean(w^2), its expectation under draws weighted by the
    scores, and over the twin D's rows from 1, its expectation under uniform
    draws (w: the scores over their mean), each as a share of the distance
    between the two expectations. A sampler that draws the main D's rows
    uniformly reads about 1 in the first, one that weights the twin's rows
    about 1 in the second."""
    w = scores / scores.mean()
    e_w = float(np.mean(w * w))
    return (abs(float(np.mean(w[drawn["d"]])) - e_w) / (e_w - 1.0),
            abs(float(np.mean(w[drawn["drs"]])) - 1.0) / (e_w - 1.0))


def follow(cfg, state, steps, imgs, device, precision="fp32", fault=None):
    """The reference over the recorded steps: (losses, first gradients,
    parameters after). precision / fault: the control and the faults put in
    the program's place (reference/precision.py, Follower's `fault`)."""
    from benchmark.reference.precision import lowered
    with lowered(precision, device.type):
        f = ref.Follower(cfg, state, cfg["ada_p_start"], device, fault)

        def rows_to_real(rows):
            return torch.from_numpy(imgs[rows]).to(device).float() / 127.5 - 1.0

        def dev(x):
            if isinstance(x, (list, tuple)):
                return type(x)(dev(v) for v in x)
            return x.to(device) if isinstance(x, torch.Tensor) else x

        losses = []
        for s in steps:
            sign = 0.0
            for c in s["calls"]:
                c = {k: (dev(v) if k in ("fake", "z", "noises", "path_noise") else v)
                     for k, v in c.items()}
                loss, sg = ref.run_call(f, c, rows_to_real)
                if c["kind"] == "d" and c["net"] == "d":
                    sign = sg
                losses.append((f"{c['kind']}.{c.get('net', 'g')}@{s['t']}", loss))
            f.ada.tune(sign, cfg["batch"])
        grads = f.first
        params = {k: {n: p.detach().cpu() for n, p in m.named_parameters()}
                  for k, m in f.nets_by_name().items()}
    return losses, grads, params


def numbers(state0, losses_p, first_p, params_p, losses_r, grads_r, params_r):
    """(loss gap, grad gap, change gap, first-loss gap), each with its worst
    loss or leaf; losses_p: floats in call order, first_p: {net: {leaf:
    norm}}. The first-loss gap is the widest of the first D updates' losses
    (main and twin D, from the seeded weights, before any update)."""
    pairs = [(n, p, r) for (n, r), p in zip(losses_r, losses_p)]
    loss = compare.loss_gap(pairs)
    first_loss = compare.loss_gap(pairs[:2])
    g_ref = {k: compare.leaf_norms(v) for k, v in grads_r.items()}
    keep = {k: compare.kept_leaves(v) for k, v in g_ref.items()}
    keep["g_ema"] = keep["g"]
    grad = max((compare.norm_gap(first_p.get(k, {}), g_ref[k], keep[k]) + (k,) for k in g_ref
                if k in compare.GRAD_NETS), key=lambda x: x[0])
    s0 = {"g": state0["g"], "d": state0["d"], "drs": state0["drs"], "g_ema": state0["g"]}

    def changes(params):
        return {k: compare.leaf_norms({n: params[k][n] - s0[k][n].cpu() for n in params[k]})
                for k in params}

    ch_p, ch_r = changes(params_p), changes(params_r)
    change = max((compare.norm_gap(ch_p[k], ch_r[k], keep[k]) + (k,) for k in ch_r),
                 key=lambda x: x[0])
    return loss, grad, change, first_loss


def check(ctx, device, imgs, scores, steps, first, params_prog, rows_of, drawn):
    cfg = ctx.config
    meta = ref.models(cfg, torch.device("meta"))
    state = {k: inputs.seeded_state(m, inputs.STYLEGAN2_RULES, ctx.seed * 8 + i, device)
             for i, (k, m) in enumerate(zip(("g", "d", "drs"), meta))}
    t0 = time.perf_counter()
    losses, grads, params = follow(cfg, state, steps, imgs, device)
    prog_losses = [c["loss"] for s in steps for c in s["calls"]]
    loss, grad, change, first_loss = numbers(state, prog_losses, first, params_prog, losses,
                                             grads, params)
    log("losses, program / reference: " + ", ".join(
        f"{n} {p:.7g}/{r:.7g}" for (n, r), p in zip(losses, prog_losses)))
    log(f"reference: {len(steps)} steps followed in {time.perf_counter() - t0:.2f} s")
    g_ref = {k: compare.leaf_norms(v) for k, v in grads.items()}
    keep = {k: compare.kept_leaves(v) for k, v in g_ref.items()}
    log(f"first gradients by net: {compare.detail(first, g_ref, keep)}")
    log(f"worst loss {loss[1]}, worst first-gradient leaf {grad[2]}.{grad[1]}, "
        f"worst change leaf {change[2]}.{change[1]}")
    for control in ctx.controls:  # the control and the faults in the program's place
        if control == "swapped_draws":  # read before the program was freed
            continue
        kw = {"precision": control} if control == "tf32" else {"fault": control}
        lp, gp, pp = follow(cfg, state, steps, imgs, device, **kw)
        c = numbers(state, [v for _, v in lp], {k: compare.leaf_norms(v) for k, v in gp.items()},
                    pp, losses, grads, params)
        log(f"control {control}, first gradients by net: "
            f"{compare.detail({k: compare.leaf_norms(v) for k, v in gp.items()}, g_ref, keep)}")
        ctx.facts.setdefault("controls", {})[control] = {
            "loss_gap": c[0][0], "grad_gap": c[1][0], "change_gap": c[2][0],
            "first_loss_gap": c[3][0]}
        log(f"control {control}: loss_gap {c[0][0]!r} ({c[0][1]}) grad_gap {c[1][0]!r} "
            f"({c[1][2]}.{c[1][1]}) change_gap {c[2][0]!r} ({c[2][2]}.{c[2][1]}) "
            f"first_loss_gap {c[3][0]!r} ({c[3][1]})")
    w = scores / scores.mean()
    log("draws: mean weight x N of the main D's {} rows {:.4f}, the twin's {} rows {:.4f}; "
        "weighted {:.4f}, uniform 1".format(len(drawn["d"]), np.mean(w[drawn["d"]]),
                                            len(drawn["drs"]), np.mean(w[drawn["drs"]]),
                                            np.mean(w * w)))
    weighted, uniform = draw_gaps(scores, drawn)
    lim = ctx.workload["limits"]
    ctx.checks += [("loss_gap", loss[0], lim["loss_gap"]),
                   ("first_loss_gap", first_loss[0], lim["first_loss_gap"]),
                   ("grad_gap", grad[0], lim["grad_gap"]),
                   ("change_gap", change[0], lim["change_gap"]),
                   ("weighted_draw_gap", weighted, lim["weighted_draw_gap"]),
                   ("uniform_draw_gap", uniform, lim["uniform_draw_gap"]),
                   ("rows_mismatched", float(rows_of.mismatched), 0.0)]
