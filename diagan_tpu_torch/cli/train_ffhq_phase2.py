"""StyleGAN2 FFHQ phase-2 Dia-GAN training: LDR-score weighted resampling and
the twin DRS discriminator trained in the same step.

    python -m diagan_tpu_torch.cli.train_ffhq_phase2 -d ffhq -r ./dataset/ffhq \\
        --size 256 --iter 250000 --augment --exp_name p2 --baseline_exp_name p1 \\
        --p1_step 200000 --resample_score ldr_conf_3.0_ratio_50

The argparse surface of stylegan2/train_ffhq_phase2.py (phase 1's flags,
plus --p1_step, --baseline_exp_name and --resample_score; r1 defaults to 10
and logit recording is off unless asked). It scores `logits_netD.pkl` of the
baseline experiment over the 5000 steps before --p1_step, loads the phase-1
checkpoint {p1_step:06d}.pt (drs_d starts from d) and trains on. That
checkpoint may be the port's, the JAX package's or the reference's
(StyleGAN2Trainer.load_ckpt); --bf16, --remat, --stream_data and
--data_parallel work as in phase 1.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from diagan_tpu_torch.cli.train_ffhq import build_parser, make_trainer
from diagan_tpu_torch.device import resolve_device
from diagan_tpu_torch.score import calculate_scores, warn_if_degenerate_weights


def main(argv=None):
    """Train phase 2; returns the trainer."""
    parser = build_parser()
    parser.add_argument("--p1_step", default=200000, type=int)
    parser.add_argument("--baseline_exp_name", type=str)
    parser.add_argument("--resample_score", type=str)
    parser.set_defaults(r1=10.0, save_logit_after=1000000)
    args = parser.parse_args(argv)
    resolve_device(args.device)  # no card and no --device cpu: raise before any work

    baseline_dir = Path(args.work_dir) / (args.baseline_exp_name or args.exp_name)
    logit_path = baseline_dir / "logits_netD.pkl"
    print(f"Use logit from: {logit_path}")
    with open(logit_path, "rb") as f:
        logits = pickle.load(f)
    window = 5000
    score_dict = calculate_scores(logits, start_epoch=args.p1_step - window,
                                  end_epoch=args.p1_step)
    if args.resample_score is None:
        parser.error("--resample_score is required (e.g. ldr_conf_3.0_ratio_50)")
    sample_weights = np.asarray(score_dict[args.resample_score])
    print(f"sample_weights mean: {sample_weights.mean()}, "
          f"max: {sample_weights.max()}, min: {sample_weights.min()}")
    warn_if_degenerate_weights(sample_weights, args.resample_score)

    trainer, start = make_trainer(args, sample_weights=sample_weights, drs=True, r1=args.r1)
    if not args.ckpt and start == 0:
        # start != 0: --auto_resume found a phase-2 checkpoint of this experiment
        ckpt = baseline_dir / "checkpoint" / f"{args.p1_step:06d}.pt"
        start = trainer.load_ckpt(ckpt)
        print(f"loaded phase-1 checkpoint {ckpt} (step {start})")
    return trainer.train(start_step=start)


if __name__ == "__main__":
    main()
