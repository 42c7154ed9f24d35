"""FID + IS + PR of a checkpoint, without DRS.

    python -m diagan_tpu_torch.cli.eval_gan -d cifar10 -r ./dataset/cifar10 \\
        --exp_name cifar10_p2 --netG_ckpt_step 80000

The argparse surface of the JAX package's eval_gan.py, plus --device
(default cuda; without a card and without --device cpu it raises). FID uses
./precalculated_statistics/fid_stats_{name}.npz when that file exists and
otherwise featurizes the real dataset; FID on 50k/50k, the Inception Score on
50k, PR (k = 3) on 10k/10k, the fakes drawn once per count and cached. The
JSONs go under {work_dir}/{exp_name}/evaluate/step-{step}/ (eval.evaluate).
--gpu and --netG_train_mode are accepted and ignored, as in the JAX package.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from diagan_tpu_torch.data.predefined import get_predefined_dataset
from diagan_tpu_torch.device import pin_fp32_precision, resolve_device
from diagan_tpu_torch.eval.evaluate import evaluate_checkpoint
from diagan_tpu_torch.eval.inception import InceptionFeaturizer
from diagan_tpu_torch.models.registry import get_gan_model
from diagan_tpu_torch.utils import set_seed

STATS_NAMES = {"celeba": "celeba_64_202k_run_0", "cifar10": "cifar10_train",
               "ffhq": "ffhq_69k_run_0"}


def add_eval_flags(parser, gpu_default):
    parser.add_argument("--dataset", "-d", default="cifar10", type=str)
    parser.add_argument("--root", "-r", default="./dataset/cifar10", type=str)
    parser.add_argument("--work_dir", default="./exp_results", type=str)
    parser.add_argument("--exp_name", default="mimicry_pretrained-seed1", type=str)
    parser.add_argument("--model", default="sngan", type=str)
    parser.add_argument("--loss_type", default="hinge", type=str)
    parser.add_argument("--gpu", default=gpu_default, type=str)
    parser.add_argument("--batch_size", default=128, type=int)
    parser.add_argument("--seed", default=1, type=int)
    parser.add_argument("--netG_ckpt_step", type=int)
    parser.add_argument("--netG_train_mode", action="store_true")
    return parser


def real_side(dataset, root):
    """(real_images, stats_file): the precalculated statistics when their file
    exists, else the real dataset's images."""
    stats_file = Path(
        f"./precalculated_statistics/fid_stats_{STATS_NAMES.get(dataset, dataset)}.npz")
    if stats_file.is_file():
        return None, stats_file
    return get_predefined_dataset(dataset, root).images, None


def evaluate_fid_is_pr(args, bundle, device, use_drs=False, use_original_netD=False,
                       batch_size=None):
    """FID 50k/50k, IS 50k and PR 10k/10k of --netG_ckpt_step, seed 0."""
    save_path = Path(f"{args.work_dir}/{args.exp_name}")
    real_images, stats_file = real_side(args.dataset, args.root)
    featurizer = InceptionFeaturizer(batch_size=args.batch_size, device=device)
    common = dict(bundle=bundle, log_dir=save_path, evaluate_step=args.netG_ckpt_step,
                  start_seed=0, num_runs=1, featurizer=featurizer, use_drs=use_drs,
                  use_original_netD=use_original_netD,
                  batch_size=args.batch_size if batch_size is None else batch_size,
                  device=device)
    return [
        evaluate_checkpoint("fid", real_images=real_images, stats_file=stats_file,
                            num_real_samples=50000, num_fake_samples=50000, **common),
        evaluate_checkpoint("inception_score", num_fake_samples=50000, **common),
        evaluate_checkpoint("pr", real_images=real_images, num_real_samples=10000,
                            num_fake_samples=10000, **common),
    ]


def main(argv=None):
    """Evaluate; returns the three metrics' result dicts."""
    pin_fp32_precision()
    parser = add_eval_flags(argparse.ArgumentParser(), gpu_default="0")
    parser.add_argument("--device", default="cuda", type=str)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if not args.netG_ckpt_step:
        parser.error("--netG_ckpt_step is required")
    set_seed(args.seed)
    print(f"load model from {args.work_dir}/{args.exp_name} step: {args.netG_ckpt_step}")
    bundle = get_gan_model(dataset_name=args.dataset, model=args.model,
                           loss_type=args.loss_type, device=device)
    return evaluate_fid_is_pr(args, bundle, device)


if __name__ == "__main__":
    main()
