"""FID against the top- and bottom-scored real examples.

    python -m diagan_tpu_torch.cli.eval_gan_with_index -d cifar10 \\
        -r ./dataset/cifar10 --exp_name cifar10_p2 --baseline_exp_name cifar10 \\
        --p1_step 40000 --resample_score ldr_conf_1.0_ratio_50 --netG_ckpt_step 80000

The argparse surface of the JAX package's eval_gan_with_index.py, plus
--device. It scores the baseline run's logits_netD_eval.pkl over the 5000
steps before --p1_step (cli.common.load_phase1_scores), takes the
--index_num highest- and lowest-scored real examples, and computes the FID of
50k fakes against each slice (JSONs fid_{high,low}_{resample_score}_*).
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from diagan_tpu_torch.cli.common import load_phase1_scores
from diagan_tpu_torch.data.predefined import get_predefined_dataset
from diagan_tpu_torch.device import pin_fp32_precision, resolve_device
from diagan_tpu_torch.eval.evaluate import evaluate_checkpoint
from diagan_tpu_torch.eval.inception import InceptionFeaturizer
from diagan_tpu_torch.models.registry import get_gan_model
from diagan_tpu_torch.utils import set_seed


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", "-d", default="cifar10", type=str)
    parser.add_argument("--root", "-r", default="./dataset/cifar10", type=str)
    parser.add_argument("--work_dir", default="./exp_results", type=str)
    parser.add_argument("--exp_name", default="mimicry_pretrained-seed1", type=str)
    parser.add_argument("--baseline_exp_name", type=str)
    parser.add_argument("--p1_step", default=40000, type=int)
    parser.add_argument("--model", default="sngan", type=str)
    parser.add_argument("--loss_type", default="hinge", type=str)
    parser.add_argument("--gpu", default="0", type=str)
    parser.add_argument("--batch_size", default=128, type=int)
    parser.add_argument("--seed", default=1, type=int)
    parser.add_argument("--netG_ckpt_step", type=int)
    parser.add_argument("--netG_train_mode", action="store_true")
    parser.add_argument("--resample_score", type=str)
    parser.add_argument("--gold", action="store_true")
    parser.add_argument("--topk", action="store_true")
    parser.add_argument("--index_num", default=100, type=int)
    parser.add_argument("--device", default="cuda", type=str)
    return parser


def run(args, use_drs=False, use_original_netD=False):
    """The high and low slices' FID; returns their result dicts."""
    device = resolve_device(args.device)
    if not args.netG_ckpt_step:
        raise ValueError("--netG_ckpt_step is required")
    save_path = Path(f"{args.work_dir}/{args.exp_name}")
    baseline_save_path = Path(f"{args.work_dir}/{args.baseline_exp_name}")
    set_seed(args.seed)

    sample_weights = load_phase1_scores(baseline_save_path, args.p1_step,
                                        args.resample_score, window=5000)
    sort_index = np.argsort(sample_weights)
    high_index = sort_index[-args.index_num:]
    low_index = sort_index[: args.index_num]

    bundle = get_gan_model(dataset_name=args.dataset, model=args.model,
                           loss_type=args.loss_type, topk=args.topk, gold=args.gold,
                           drs=use_drs, device=device)
    real_images = get_predefined_dataset(args.dataset, args.root).images
    featurizer = InceptionFeaturizer(batch_size=args.batch_size, device=device)
    return [
        evaluate_checkpoint(
            "fid", bundle=bundle, log_dir=save_path, evaluate_step=args.netG_ckpt_step,
            real_images=real_images, real_subset_index=index,
            num_real_samples=len(index), num_fake_samples=50000, featurizer=featurizer,
            use_drs=use_drs, use_original_netD=use_original_netD,
            name=f"{name}_{args.resample_score}", device=device)
        for name, index in (("high", high_index), ("low", low_index))
    ]


def main(argv=None):
    pin_fp32_precision()
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
