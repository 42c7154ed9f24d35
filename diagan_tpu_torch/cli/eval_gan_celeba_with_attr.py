"""CelebA attribute-sliced partial recall and FID of a checkpoint.

    python -m diagan_tpu_torch.cli.eval_gan_celeba_with_attr -r ./dataset/celeba \\
        --exp_name celeba_p2 --netG_ckpt_step 75000 --attr Bald --metric all

The argparse surface of the JAX package's eval_gan_celeba_with_attr.py, plus
--device. The reals split by the attribute's column of ds.attrs; each subset
capped at --num_real_samples by np.random.default_rng(seed).choice. The
fakes (--num_fake_samples, plain or by DRS at batch 256) go through
normalize_images (per-image min-max to uint8), the reals as uint8. Partial
recall at k = 3 of the fakes against each subset ->
evaluate/step-{step}/partial_recall_{drs_}{attr}.json; with --metric fid or
all, the attribute-sliced FID: one fake statistic against each subset's,
the real statistics cached as the reference's npz
(metrics/fid/statistics/fid_stats_{model}_{dataset}_{attr}{_cap{n}}_run_{seed}.npz,
_cap{n} when a subset was capped) -> fid_{drs_}{attr}.json. Both JSONs carry
the Inception's "inception_weights" ("random" without a weights file).
--gpu and --netG_train_mode are accepted and ignored.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from diagan_tpu_torch.cli.count_attr_celeba import make_sampler
from diagan_tpu_torch.data.predefined import get_predefined_dataset
from diagan_tpu_torch.data.sources import CELEBA_ATTR_NAMES
from diagan_tpu_torch.device import resolve_device
from diagan_tpu_torch.eval import metrics as M
from diagan_tpu_torch.eval.inception import InceptionFeaturizer
from diagan_tpu_torch.models.registry import get_gan_model
from diagan_tpu_torch.utils import set_seed


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", "-d", default="celeba", type=str)
    parser.add_argument("--root", "-r", default="./dataset/celeba", type=str)
    parser.add_argument("--attr", default="Bald", type=str)
    parser.add_argument("--work_dir", default="./exp_results", type=str)
    parser.add_argument("--exp_name", default="mimicry_pretrained-seed1", type=str)
    parser.add_argument("--model", default="sngan", type=str)
    parser.add_argument("--loss_type", default="hinge", type=str)
    parser.add_argument("--gpu", default="0", type=str)
    parser.add_argument("--batch_size", default=128, type=int)
    parser.add_argument("--seed", default=1, type=int)
    parser.add_argument("--netG_ckpt_step", type=int)
    parser.add_argument("--netG_train_mode", action="store_true")
    parser.add_argument("--num_real_samples", default=10000, type=int)
    parser.add_argument("--num_fake_samples", default=10000, type=int)
    parser.add_argument("--metric", default="partial_recall",
                        choices=["partial_recall", "fid", "all"])
    parser.add_argument("--device", default="cuda", type=str)
    return parser


def _attr_fid(args, ds, featurizer, fake_feats, attr_idx, not_attr_idx, save_path, num_real,
              use_drs):
    """Attr-sliced FID: one fake statistic, two Frechet distances (against
    the attr-positive and attr-negative reals); the real statistics cached
    under a name keyed by the cap when a subset was capped."""
    stats_dir = save_path / "metrics" / "fid" / "statistics"
    stats_dir.mkdir(parents=True, exist_ok=True)
    capped = num_real < max(len(attr_idx), len(not_attr_idx))
    cap_tag = f"_cap{num_real}" if capped else ""
    stats_file = stats_dir / (
        f"fid_stats_{args.model}_{args.dataset}_{args.attr}{cap_tag}_run_{args.seed}.npz")
    if stats_file.is_file():
        print("INFO: Loading existing statistics for real images...")
        with np.load(stats_file) as f:
            stats = {k: f[k][:] for k in ("attr_mu", "attr_sigma", "not_attr_mu",
                                          "not_attr_sigma")}
    else:
        rng = np.random.default_rng(args.seed)
        stats = {}
        for name, idx in (("attr", attr_idx), ("not_attr", not_attr_idx)):
            sel = idx if len(idx) <= num_real else rng.choice(idx, num_real, False)
            mu, sigma = M.activation_statistics(featurizer.features(ds.images[sel]))
            stats[f"{name}_mu"], stats[f"{name}_sigma"] = mu, sigma
        np.savez(stats_file, **stats)

    mu_fake, sigma_fake = M.activation_statistics(fake_feats)
    out = {}
    for name in ("attr", "not_attr"):
        out[name] = float(M.frechet_distance(stats[f"{name}_mu"], stats[f"{name}_sigma"],
                                             mu_fake, sigma_fake))
        print(f"INFO: FID with {'' if name == 'attr' else 'not '}attribute: {out[name]}")

    out_dir = save_path / "evaluate" / f"step-{args.netG_ckpt_step}"
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = "drs_" if use_drs else ""
    out["inception_weights"] = featurizer.weights_kind
    (out_dir / f"fid_{tag}{args.attr}.json").write_text(json.dumps(out, indent=2))
    return out


def run(args, use_drs=False, use_original_netD=False, num_fake=None, num_real=None):
    """Evaluate; returns {"attr", "not_attr", "inception_weights"} (partial
    recall) and/or {"fid": ...}."""
    device = resolve_device(getattr(args, "device", "cuda"))
    if num_fake is None:
        num_fake = getattr(args, "num_fake_samples", 10000)
    if num_real is None:
        num_real = getattr(args, "num_real_samples", 10000)
    save_path = Path(f"{args.work_dir}/{args.exp_name}")
    set_seed(args.seed)
    if not args.netG_ckpt_step:
        raise ValueError("--netG_ckpt_step is required")

    ds = get_predefined_dataset(args.dataset, args.root)
    attrs = getattr(ds, "attrs", None)
    if attrs is None or np.abs(attrs).sum() == 0:
        raise FileNotFoundError("CelebA attribute annotations (list_attr_celeba.txt) not found")
    col = CELEBA_ATTR_NAMES.index(args.attr)
    attr_idx = np.where(attrs[:, col] == 1)[0]
    not_attr_idx = np.where(attrs[:, col] != 1)[0]
    print(f"attr {args.attr}: {len(attr_idx)} with / {len(not_attr_idx)} without")

    bundle = get_gan_model(dataset_name=args.dataset, model=args.model,
                           loss_type=args.loss_type, drs=use_drs, device=device)
    sampler = make_sampler(bundle, save_path, args.netG_ckpt_step, use_drs, use_original_netD,
                           device)
    featurizer = InceptionFeaturizer(batch_size=args.batch_size, device=device)
    fakes = sampler.generate_images(num_fake)
    fake_feats = featurizer.features(M.normalize_images(fakes))
    metric = getattr(args, "metric", "partial_recall")

    out = {}
    if metric in ("partial_recall", "all"):
        rng = np.random.default_rng(args.seed)
        for name, idx in (("attr", attr_idx), ("not_attr", not_attr_idx)):
            sel = idx if len(idx) <= num_real else rng.choice(idx, num_real, False)
            feats = featurizer.features(ds.images[sel])
            out[name] = M.compute_partial_recall(feats, fake_feats, nearest_k=3)
            print(f"INFO ({'with' if name == 'attr' else 'without'} attr): "
                  f"partial_recall (step {args.netG_ckpt_step}): {out[name]}")
        out_dir = save_path / "evaluate" / f"step-{args.netG_ckpt_step}"
        out_dir.mkdir(parents=True, exist_ok=True)
        tag = "drs_" if use_drs else ""
        out["inception_weights"] = featurizer.weights_kind
        (out_dir / f"partial_recall_{tag}{args.attr}.json").write_text(json.dumps(out, indent=2))

    if metric in ("fid", "all"):
        out["fid"] = _attr_fid(args, ds, featurizer, fake_feats, attr_idx, not_attr_idx,
                               save_path, num_real, use_drs)
    return out


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
