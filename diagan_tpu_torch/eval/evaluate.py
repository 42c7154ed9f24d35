"""Sampling closures, the plain sampler, the eval loader, the port's StyleGAN2
checkpoint and evaluate_checkpoint.

Counterparts of make_gen_fn / make_disc_fn / Sampler / load_eval_models /
read_stylegan2_ckpt / evaluate_checkpoint in diagan_tpu/eval/evaluate.py.
The JAX make_gen_fn draws the StyleGAN2 noise from one fixed key; here the
noise comes from an explicit torch.Generator on the generator's device. The
SNGAN generator draws no noise.

load_eval_models reads the mimicry layout a LogTrainer run writes
(checkpoints/{netG,netD,netD_drs}/{name}_{step}_steps.pth), or for a
StyleGAN2 or StyleGAN3 bundle the checkpoint/{step:06d}.pt layout of the
StyleGAN2 trainer.

evaluate_checkpoint keeps the JAX package's files byte for byte where they
are deterministic: the metric JSON, the real statistics cache and the fake
cache (see its docstring). Its fakes come from a torch.Generator seeded with
the run's seed, so they differ from the JAX package's (Philox, not
threefry); a run that finds the fake cache reuses it.

The port's checkpoint is one torch.save'd dict of state_dicts,
{"g_ema", "d", "drs_d"}; the trainer's checkpoints are a superset of it.
DRS reads drs_d and falls back to d, as the JAX reader does.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from diagan_tpu_torch.device import resolve_device
from diagan_tpu_torch.eval import metrics as M
from diagan_tpu_torch.eval.drs import DRS
from diagan_tpu_torch.eval.drs import minmax_uint8 as _minmax_uint8
from diagan_tpu_torch.eval.drs import to_uint8
from diagan_tpu_torch.eval.inception import InceptionFeaturizer
from diagan_tpu_torch.models.stylegan2 import StyleGAN2Generator
from diagan_tpu_torch.train.checkpoint import load_weights, read_stylegan2_file


def _module_device(module):
    return next(module.parameters()).device


def make_gen_fn(gen, generator=None):
    """Eval-mode z -> NHWC images closure over `gen`. For StyleGAN2,
    `generator` draws the per-layer noise (default: seed 0 on gen's device);
    StyleGAN3 and the SNGAN-style generators take no noise."""
    gen.eval()
    noise = isinstance(gen, StyleGAN2Generator)
    if noise and generator is None:
        generator = torch.Generator(_module_device(gen)).manual_seed(0)

    @torch.no_grad()
    def gen_fn(z):
        return gen(z, generator=generator) if noise else gen(z)

    return gen_fn


def make_disc_fn(disc):
    """Eval-mode NHWC images -> (N,) logits closure over `disc`."""
    disc.eval()

    @torch.no_grad()
    def disc_fn(x):
        return disc(x)[0]

    return disc_fn


class Sampler:
    """Plain batched G sampler (the non-DRS path)."""

    def __init__(self, gen_fn, nz, generator=None, batch_size=256, device="cuda"):
        self.device = resolve_device(device)
        self.gen_fn = gen_fn
        self.nz = nz
        self.batch_size = batch_size
        self.generator = (generator if generator is not None
                          else torch.Generator(self.device).manual_seed(0))

    @torch.no_grad()
    def generate_images(self, num_images, return_uint8=False, minmax_uint8=False):
        out = []
        n = 0
        while n < num_images:
            z = torch.randn((self.batch_size, self.nz), generator=self.generator,
                            device=self.device)
            imgs = self.gen_fn(z)
            if minmax_uint8:
                imgs = _minmax_uint8(imgs)
            elif return_uint8:
                imgs = to_uint8(imgs)
            out.append(imgs.cpu().numpy())
            n += len(out[-1])
        return np.concatenate(out)[:num_images]


def load_eval_models(bundle, log_dir, evaluate_step, use_drs=False, use_original_netD=False,
                     netD_ckpt_dir=None):
    """Load G (and the DRS discriminator) of a run at a step into the
    bundle's modules, in eval mode. Returns (gen, disc or None).

    SNGAN runs (and the MNIST DCGAN's, the toy's): netG, and with use_drs
    netD_drs, or netD with use_original_netD (a phase-1 model's own D under
    DRS, reference eval_gan_drs.py:28), from log_dir/checkpoints or
    netD_ckpt_dir, each the port's, the JAX package's or the reference's
    file (train/checkpoint.py load_weights: weights and buffers only, as the
    JAX package's params_only restore).
    StyleGAN2 and StyleGAN3 runs: g_ema, and with use_drs drs_d (falling
    back to d), from log_dir/checkpoint/{step:06d}.pt."""
    log_dir = Path(log_dir)
    if bundle.model in ("stylegan", "stylegan3"):
        path = log_dir / "checkpoint" / f"{evaluate_step:06d}.pt"
        if not path.is_file():
            raise FileNotFoundError(f"missing {path}")
        disc = bundle.disc_drs if bundle.disc_drs is not None else bundle.disc
        gen, disc = read_stylegan2_ckpt(path, bundle.gen, disc, use_drs=use_drs)
        gen.eval()
        if not use_drs:
            return gen, None
        disc.eval()
        return gen, disc
    g_path = log_dir / "checkpoints" / "netG" / f"netG_{evaluate_step}_steps.pth"
    if not g_path.is_file():
        raise FileNotFoundError(f"missing {g_path}")
    load_weights(bundle.gen, g_path)
    bundle.gen.eval()
    if not use_drs:
        return bundle.gen, None
    name = "netD" if use_original_netD else "netD_drs"
    d_dir = Path(netD_ckpt_dir) if netD_ckpt_dir else log_dir / "checkpoints"
    d_path = d_dir / name / f"{name}_{evaluate_step}_steps.pth"
    if not d_path.is_file():
        raise FileNotFoundError(f"missing {d_path}")
    disc = bundle.disc_drs if bundle.disc_drs is not None else bundle.disc
    load_weights(disc, d_path)
    disc.eval()
    return bundle.gen, disc


def save_stylegan2_ckpt(path, g_ema, d=None, drs_d=None):
    """Write the port's monolithic checkpoint {"g_ema", "d", "drs_d"}."""
    mods = {"g_ema": g_ema, "d": d, "drs_d": drs_d}
    torch.save({k: m.state_dict() for k, m in mods.items() if m is not None}, path)
    return Path(path)


def read_stylegan2_ckpt(path, gen, disc=None, use_drs=False):
    """Load g_ema (else g) into `gen` and, with use_drs, drs_d (else d) into
    `disc`, in place, on the modules' devices. `path` is the port's
    checkpoint (this module's or the trainer's), the JAX package's msgpack
    one or the reference's `{iter:06d}.pt` (train/checkpoint.py
    read_stylegan2_file). Returns (gen, disc)."""
    raw = read_stylegan2_file(path)
    gen.load_state_dict(raw["g_ema"] if "g_ema" in raw else raw["g"])
    if use_drs:
        if disc is None:
            raise ValueError("use_drs needs the discriminator module")
        disc.load_state_dict(raw["drs_d"] if "drs_d" in raw else raw["d"])
    return gen, disc


def evaluate_checkpoint(
    metric,
    bundle,
    log_dir,
    evaluate_step,
    real_images=None,
    stats_file=None,
    num_real_samples=50000,
    num_fake_samples=50000,
    num_runs=1,
    start_seed=0,
    use_drs=False,
    use_original_netD=False,
    featurizer=None,
    batch_size=256,
    real_subset_index=None,
    name=None,
    overwrite=False,
    cache_fakes=True,
    device="cuda",
):
    """Compute `metric` ('fid' | 'inception_score' | 'kid' | 'pr') of one
    checkpoint step for seeds start_seed .. start_seed + num_runs - 1, and
    write or extend its JSON. The bundle's modules live on `device`.

    Files, as the JAX package writes them:
      - {log_dir}/evaluate/step-{step}/{metric}[_{name}]{suffix}.json, suffix
        _{nr}k_{nf}k (_{nf}k for inception_score), holding {"metric",
        "scores": {str(seed): score}, "inception_weights", "use_drs"} with
        indent 2, rewritten after every seed; a rerun skips the seeds already
        there unless `overwrite`;
      - the real statistics of plain FID, cached as
        {log_dir}/metrics/fid/statistics/fid_stats_{dataset}_{nr}k_run_{start_seed}.npz;
      - each seed's fakes, min-max uint8 on the device before the copy, cached
        as .../step-{step}/images/fid_gen_images_{nf}k_{seed}[_drs].npy and
        reused by any metric of the same count.
    The real subset: real_subset_index first, then
    np.random.default_rng(start_seed).choice(n, num_real_samples,
    replace=False) where more are left."""
    device = resolve_device(device)
    log_dir = Path(log_dir)
    gen, disc = load_eval_models(bundle, log_dir, evaluate_step, use_drs, use_original_netD)
    featurizer = featurizer or InceptionFeaturizer(device=device)

    out_dir = log_dir / "evaluate" / f"step-{evaluate_step}"
    out_dir.mkdir(parents=True, exist_ok=True)
    nr = num_real_samples // 1000
    nf = num_fake_samples // 1000
    suffix = {"fid": f"_{nr}k_{nf}k", "kid": f"_{nr}k_{nf}k",
              "inception_score": f"_{nf}k", "pr": f"_{nr}k_{nf}k"}[metric]
    stem = f"{metric}_{name}" if name else metric
    out_file = out_dir / f"{stem}{suffix}.json"
    results = (json.loads(out_file.read_text()) if out_file.is_file() and not overwrite
               else {"metric": metric, "scores": {}})
    results["inception_weights"] = featurizer.weights_kind
    results["use_drs"] = use_drs

    def subset(images):
        if len(images) > num_real_samples:
            rng = np.random.default_rng(start_seed)
            images = images[rng.choice(len(images), num_real_samples, replace=False)]
        return images

    # the real side once, for every seed; plain FID caches (mu, sigma) in the
    # reference's statistics layout (fid_score.py:43-74)
    real_feats = None
    if metric == "fid" and stats_file is None and real_subset_index is None:
        cache = (log_dir / "metrics" / "fid" / "statistics"
                 / f"fid_stats_{bundle.dataset}_{nr}k_run_{start_seed}.npz")
        if cache.is_file():
            stats_file = cache
        elif real_images is not None:
            mu, sigma = M.activation_statistics(featurizer.features(subset(real_images)))
            M.save_stats(cache, mu, sigma)
            stats_file = cache
    if metric in ("fid", "kid", "pr") and stats_file is None:
        if real_images is None:
            raise ValueError("need real_images or stats_file")
        sel = real_images
        if real_subset_index is not None:
            sel = real_images[np.asarray(real_subset_index)]
        real_feats = featurizer.features(subset(sel))

    for run in range(num_runs):
        seed = start_seed + run
        if str(seed) in results["scores"] and not overwrite:
            continue
        fake_cache = (out_dir / "images"
                      / f"fid_gen_images_{nf}k_{seed}{'_drs' if use_drs else ''}.npy")
        if cache_fakes and fake_cache.is_file():
            fakes_u8 = np.load(fake_cache)
        else:
            generator = torch.Generator(device).manual_seed(seed)
            if use_drs:
                sampler = DRS(make_gen_fn(gen), make_disc_fn(disc), bundle.nz,
                              generator=generator, batch_size=batch_size, device=device)
            else:
                sampler = Sampler(make_gen_fn(gen), bundle.nz, generator=generator,
                                  batch_size=batch_size, device=device)
            fakes_u8 = sampler.generate_images(num_fake_samples, minmax_uint8=True)
            if cache_fakes:
                fake_cache.parent.mkdir(parents=True, exist_ok=True)
                np.save(fake_cache, fakes_u8)
        feats, logits = featurizer.features_and_logits(fakes_u8)

        if metric == "fid":
            score = M.fid_from_features(real_feats, feats, stats_file=stats_file)
        elif metric == "kid":
            score = M.kid_from_features(real_feats, feats)[0]
        elif metric == "inception_score":
            score = M.inception_score_from_logits(logits)[0]
        elif metric == "pr":
            score = M.compute_pr(torch.from_numpy(real_feats).to(device),
                                 torch.from_numpy(feats).to(device), nearest_k=3)
        else:
            raise ValueError(metric)
        results["scores"][str(seed)] = score
        out_file.write_text(json.dumps(results, indent=2))
        print(f"INFO: {metric} (step {evaluate_step}, seed {seed}) = {score}")

    return results
