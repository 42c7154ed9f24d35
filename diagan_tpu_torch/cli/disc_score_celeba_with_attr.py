"""Mean LDR resampling weight of the CelebA training examples with and
without an attribute: do the phase-1 scores up-weight the rare ones?

    python -m diagan_tpu_torch.cli.disc_score_celeba_with_attr -r ./dataset/celeba \\
        --exp_name celeba --p1_step 60000 --resample_score ldr_conf_1.0_ratio_50 --attr Bald

The argparse surface of the JAX package's disc_score_celeba_with_attr.py
(no --device: it runs on the host). Scores logits_netD_eval.pkl over the
5000 steps before --p1_step, and compares the weights of the attr-positive
and attr-negative examples among the first train_num = min(162,770,
len(weights)) (CelebA's train split, capped at the logit record's length):
attributes from list_attr_celeba.txt, or, without it, from load_celeba.
"""
from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np

from diagan_tpu_torch.data.sources import CELEBA_ATTR_NAMES, load_celeba, load_celeba_attrs
from diagan_tpu_torch.score import calculate_scores


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", "-d", default="celeba", type=str)
    parser.add_argument("--root", "-r", default="./dataset/celeba", type=str)
    parser.add_argument("--work_dir", default="./exp_results", type=str)
    parser.add_argument("--exp_name", default="mimicry_pretrained-seed1", type=str)
    parser.add_argument("--p1_step", default=60000, type=int)
    parser.add_argument("--resample_score", type=str)
    parser.add_argument("--attr", default="Bald", type=str)
    return parser


def main(argv=None):
    """Print the means; returns {"attr": mean, "not_attr": mean} of the weights."""
    args = build_parser().parse_args(argv)
    save_path = Path(f"{args.work_dir}/{args.exp_name}")
    logit_path = save_path / "logits_netD_eval.pkl"
    print(f"Use logit from: {logit_path}")
    with open(logit_path, "rb") as f:
        logits = pickle.load(f)
    score_dict = calculate_scores(logits, start_epoch=args.p1_step - 5000, end_epoch=args.p1_step)
    sample_weights = np.asarray(score_dict[args.resample_score])
    print(f"sample_weights mean: {sample_weights.mean()}, "
          f"var: {sample_weights.var()}, max: {sample_weights.max()}, "
          f"min: {sample_weights.min()}")

    train_num = min(162770, len(sample_weights))
    attr_file = Path(args.root) / "list_attr_celeba.txt"
    if attr_file.is_file():
        attrs = load_celeba_attrs(attr_file, n=train_num + 40000)
    else:
        _, attrs = load_celeba(args.root)
    col = CELEBA_ATTR_NAMES.index(args.attr)
    attr_index = np.where(attrs[:, col] == 1)[0]
    not_attr_index = np.where(attrs[:, col] != 1)[0]
    attr_index = attr_index[attr_index < train_num]
    not_attr_index = not_attr_index[not_attr_index < train_num]
    means = {"attr": sample_weights[attr_index].mean(),
             "not_attr": sample_weights[not_attr_index].mean()}
    print(f"attr weights mean: {means['attr']}")
    print(f"not attr weights mean: {means['not_attr']}")
    return means


if __name__ == "__main__":
    main()
