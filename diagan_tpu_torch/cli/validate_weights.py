"""Weights-readiness gate (the port of scripts/validate_weights.py): run it
when real pretrained weight files are at hand.

    python -m diagan_tpu_torch.cli.validate_weights --inception pt_inception-2015-12-05-6726825d.pth
    python -m diagan_tpu_torch.cli.validate_weights --lpips_vgg vgg16.pth --lpips_lin lin.pth

Stages, each printed PASS or FAIL:

  inception: converter   eval/inception.py load_torch_weights maps the file
                         (torchvision's or pytorch-fid's InceptionV3) by
                         definition order;
             strict load every key of the file but AuxLogits names a tensor
                         of the port's InceptionV3 with its shape, and every
                         port tensor is in the file (num_batches_tracked may
                         be absent); the strict load equals the converter's
                         result; on the card, pool3 of 4 random images there
                         against the CPU's within 1e-3 of its largest value
                         (TF32 off);
             smoke FID   through eval.inception.InceptionFeaturizer:
                         FID(a, a) ~ 0, FID(a, b) finite and positive;
  lpips:                 eval/lpips.py loads the VGG16 (and head) files;
                         d(x, x) = 0 < d(x, y), finite.

The JAX script's parity stage runs a torch oracle that lives in the JAX
package's tests (test_inception_parity.py TorchFIDInception, in a file that
imports jax); the port's network is itself the torch InceptionV3 under the
file's own key names, so its parity stage is the strict load above, plus the
card-vs-CPU check when it runs on the card. It runs on the card unless
--device cpu is passed. All stages green: export
DIAGAN_TPU_INCEPTION_WEIGHTS=<path>, and every cli.eval_gan* metric is
comparable to the reference's published protocol. Exits 0 when every stage
passed, else 1.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from diagan_tpu_torch.device import resolve_device
from diagan_tpu_torch.eval import inception
from diagan_tpu_torch.eval.inception import InceptionFeaturizer, InceptionV3, load_torch_weights
from diagan_tpu_torch.eval.lpips import LPIPS
from diagan_tpu_torch.eval.metrics import activation_statistics, frechet_distance


def check(results, name, fn):
    try:
        detail = fn()
        results.append((name, True))
        print(f"PASS  {name}" + (f"  ({detail})" if detail else ""))
    except Exception as e:  # a stage's failure is its result
        results.append((name, False))
        print(f"FAIL  {name}  {type(e).__name__}: {e}")


def _file_state_dict(path):
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v for k, v in sd.items() if "AuxLogits" not in k}


def strict_inception(path):
    """The port's InceptionV3 (CPU) loaded from the file by key name: raises
    naming the keys that are missing, unexpected or of another shape."""
    model = InceptionV3(device="cpu")
    own = model.state_dict()
    sd = _file_state_dict(path)
    for key, t in own.items():
        if key.endswith("num_batches_tracked"):
            sd.setdefault(key, t)
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    shapes = sorted(k for k in set(own) & set(sd) if tuple(own[k].shape) != tuple(sd[k].shape))
    if missing or unexpected or shapes:
        raise ValueError(f"missing {missing[:4]}, unexpected {unexpected[:4]}, "
                         f"shape mismatch {shapes[:4]}")
    model.load_state_dict(sd)
    return model.eval()


def validate_inception(path, device, results):
    state = {}

    def _convert():
        state["model"] = load_torch_weights(InceptionV3(device="cpu"), path)
        n = sum(t.numel() for t in state["model"].state_dict().values())
        return f"{n / 1e6:.1f}M values mapped"

    check(results, "inception: torch state_dict -> port converter", _convert)
    if "model" not in state:
        return

    def _strict():
        model = strict_inception(path)
        got = model.state_dict()
        for key, t in state["model"].state_dict().items():
            if not key.endswith("num_batches_tracked") and not torch.equal(got[key], t):
                raise ValueError(f"the converter put another tensor at {key}")
        if device.type != "cuda":
            return "every key consumed"
        size = inception.INCEPTION_SIZE
        x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (4, 3, size, size))
                             .astype(np.float32))
        with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            want = model(x)[0]
            got = model.to(device)(x.to(device))[0].cpu()
        rel = float((got - want).abs().max() / (want.abs().max() + 1e-12))
        if rel > 1e-3:
            raise ValueError(f"pool3 card vs CPU rel err {rel:.2e} > 1e-3")
        return f"every key consumed; pool3 card vs CPU rel err {rel:.2e}"

    check(results, "inception: strict load (parity)", _strict)

    def _smoke_fid():
        feat = InceptionFeaturizer(weights_path=path, batch_size=32, device=device)
        rng = np.random.default_rng(1)
        a = rng.integers(0, 255, (64, 32, 32, 3), dtype=np.uint8)
        b = rng.integers(0, 255, (64, 32, 32, 3), dtype=np.uint8)
        fa, fb = feat.features(a), feat.features(b)
        if not (np.isfinite(fa).all() and np.isfinite(fb).all()):
            raise ValueError("non-finite inception features")
        d_self = frechet_distance(*activation_statistics(fa), *activation_statistics(fa))
        d_ab = frechet_distance(*activation_statistics(fa), *activation_statistics(fb))
        if not (abs(d_self) < 1e-3 and np.isfinite(d_ab) and d_ab > 0):
            raise ValueError(f"fid(a,a)={d_self:.2e}, fid(a,b)={d_ab:.4g}")
        return f"fid(a,a)={d_self:.1e}, fid(a,b)={d_ab:.4g}"

    check(results, "inception: smoke FID through the featurizer", _smoke_fid)


def validate_lpips(vgg_path, lin_path, device, results):
    def _run():
        lp = LPIPS(weights_path=vgg_path, lin_path=lin_path, device=device)
        rng = np.random.default_rng(2)
        x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
        y = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
        d_same = float(np.mean(lp(x, x)))
        d_diff = float(np.mean(lp(x, y)))
        if not (d_same < 1e-6 and d_diff > d_same and np.isfinite(d_diff)):
            raise ValueError(f"d(x,x)={d_same:.2e}, d(x,y)={d_diff:.4f}")
        return f"d(x,x)={d_same:.1e} < d(x,y)={d_diff:.4f}"

    check(results, "lpips: converter + distance sanity", _run)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--inception", type=str, help="pt_inception-2015-12-05 .pth path")
    p.add_argument("--lpips_vgg", type=str, help="LPIPS VGG16 weights .pth")
    p.add_argument("--lpips_lin", type=str, help="LPIPS linear-head weights .pth")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None):
    """Run the stages; returns the exit code (0 when all passed)."""
    p = build_parser()
    args = p.parse_args(argv)
    if not (args.inception or args.lpips_vgg):
        p.error("pass --inception and/or --lpips_vgg [--lpips_lin]")
    device = resolve_device(args.device)
    results = []
    if args.inception:
        validate_inception(args.inception, device, results)
    if args.lpips_vgg:
        validate_lpips(args.lpips_vgg, args.lpips_lin, device, results)
    ok = all(passed for _, passed in results)
    print()
    if ok and args.inception:
        print("ALL PASS: export "
              f"DIAGAN_TPU_INCEPTION_WEIGHTS={args.inception} and rerun the cli.eval_gan* "
              "entry points: every FID/IS/KID becomes comparable to the reference's "
              "published protocol.")
    elif ok:
        print("ALL PASS")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
