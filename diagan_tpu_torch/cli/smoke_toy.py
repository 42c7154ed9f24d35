"""The 25-Gaussians toy's two-phase protocol (counterpart of
scripts/smoke_toy.py), the paper's toy demonstration.

Phase 1 trains the toy MLP GAN through LogTrainer, recording D's logits over
its second half; phase 2 resamples the data by those logits' scores
(--resample_score) and trains on, resumed from phase 1's files, with the twin
DRS discriminator; then DRS draws from phase 2 through the twin D. Each of
the three samples of 5000 points is scored by `coverage`, and the three lines
print as the JAX script prints them:

    python -m diagan_tpu_torch.cli.smoke_toy [--num_steps 8000] [--work_dir /tmp/exp_toy]

--device defaults to cuda (without a card, pass --device cpu). Writes
{work_dir}/toy25/checkpoints/{netG,netD}/*_{num_steps}_steps.pth,
logits_netD_eval.pkl and phase2/checkpoints/{netG,netD,netD_drs}/
*_{num_steps * 3 // 2}_steps.pth. The draws are torch's, not the JAX
package's, so a run agrees with a JAX run as a distribution, not point for
point.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from diagan_tpu_torch.cli.common import load_phase1_scores
from diagan_tpu_torch.data.predefined import get_predefined_dataset
from diagan_tpu_torch.device import pin_fp32_precision, resolve_device
from diagan_tpu_torch.eval.drs import DRS
from diagan_tpu_torch.eval.evaluate import make_disc_fn, make_gen_fn
from diagan_tpu_torch.models.registry import get_gan_model
from diagan_tpu_torch.train.trainer import LogTrainer
from diagan_tpu_torch.utils import set_seed

N_SAMPLES = 5000  # points drawn for each coverage line


def coverage(pts):
    """(modes covered, fraction of samples within 3 sigma of a mode).

    The dataset (and hence G's output) lives in the /2.828-scaled space;
    rescale back before snapping to the unscaled 5x5 grid."""
    pts = np.asarray(pts) * 2.828
    centers = np.array([[2 * x, 2 * y] for x in range(-2, 3)
                        for y in range(-2, 3)], np.float32)
    d2 = ((pts[:, None, :] - centers[None]) ** 2).sum(-1)
    nearest = d2.argmin(1)
    good = d2[np.arange(len(pts)), nearest] < (3 * 0.05 * 2) ** 2
    return len(set(nearest[good].tolist())), float(good.mean())


def sample_plain(gen, nz, n, device, seed=123):
    """n points of G (eval mode) from latents seeded with `seed`."""
    z = torch.randn((n, nz), generator=torch.Generator(device).manual_seed(seed), device=device)
    return make_gen_fn(gen)(z).cpu().numpy()


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--num_steps", default=8000, type=int)
    parser.add_argument("--num_data", default=10000, type=int)
    parser.add_argument("--batch_size", default=256, type=int)
    parser.add_argument("--resample_score", default="ldrv", type=str)
    parser.add_argument("--work_dir", default="/tmp/exp_toy", type=str)
    parser.add_argument("--seed", default=1, type=int)
    parser.add_argument("--device", default="cuda", type=str)
    return parser


def main(argv=None):
    """Run the protocol; returns {"coverage": {"phase1" | "phase2" |
    "phase2+DRS": (modes, fraction)}, "weights": phase 2's sample weights,
    "trainers": (phase 1's, phase 2's), "drs": the DRS sampler}."""
    pin_fp32_precision()
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    set_seed(args.seed)
    out = Path(args.work_dir) / "toy25"
    out.mkdir(parents=True, exist_ok=True)
    ds = get_predefined_dataset("25gaussian", root=None, n_samples=args.num_data)
    n1 = args.num_steps
    # a snapshot every 100 steps, as the JAX script, or every n1 // 4 below 400
    # steps (where its window [n1 // 2, n1) would hold fewer than the two
    # snapshots that the scores need, and the JAX script raises)
    common = dict(n_dis=1, batch_size=args.batch_size, print_steps=1000, vis_steps=10**9,
                  log_steps=1000, logit_save_steps=max(1, min(100, n1 // 4)), seed=args.seed,
                  device=device)

    # ---- phase 1 ----
    bundle = get_gan_model("25gaussian", loss_type="ns", device=device)
    tr1 = LogTrainer(output_path=out, bundle=bundle, dataset=ds, num_steps=n1, save_steps=n1,
                     save_logit_after=n1 // 2, stop_save_logit_after=n1, save_logits=True,
                     **common)
    tr1.train()
    cov = {"phase1": coverage(sample_plain(tr1.g.module, bundle.nz, N_SAMPLES, device))}

    # ---- phase 2: weighted resampling + the twin DRS D ----
    weights = load_phase1_scores(out, n1, args.resample_score, window=n1 // 2)
    bundle2 = get_gan_model("25gaussian", loss_type="ns", drs=True, device=device)
    n2 = n1 + n1 // 2
    netD = out / f"checkpoints/netD/netD_{n1}_steps.pth"
    tr2 = LogTrainer(output_path=out / "phase2", bundle=bundle2, dataset=ds,
                     sample_weights=weights, dataset_drs=ds, num_steps=n2, save_steps=n2,
                     save_logit_after=10**9, stop_save_logit_after=10**9, save_logits=False,
                     netG_ckpt_file=out / f"checkpoints/netG/netG_{n1}_steps.pth",
                     netD_ckpt_file=netD, netD_drs_ckpt_file=netD, **common)
    tr2.train()
    cov["phase2"] = coverage(sample_plain(tr2.g.module, bundle2.nz, N_SAMPLES, device))

    # ---- phase 2 + DRS sampling ----
    drs = DRS(make_gen_fn(tr2.g.module), make_disc_fn(tr2.d_drs.module), bundle2.nz,
              batch_size=args.batch_size, device=device)
    cov["phase2+DRS"] = coverage(drs.generate_images(N_SAMPLES))

    for name, (m, f) in cov.items():
        print(f"{name}: {m}/25 modes, {f:.3f} high-quality")
    return {"coverage": cov, "weights": weights, "trainers": (tr1, tr2), "drs": drs}


if __name__ == "__main__":
    main()
