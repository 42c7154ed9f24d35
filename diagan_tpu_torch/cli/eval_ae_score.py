"""Baseline against resampled CAE reconstruction errors, over all and the
minority examples, appended to a CSV.

    python -m diagan_tpu_torch.cli.eval_ae_score -d color_mnist \\
        --baseline_exp_path exp_results/colour_mnist \\
        --resample_exp_path exp_results/colour_mnist_p2 --p1_step 15000 \\
        --p2_step 20000 --resample_score ldr_conf_1.0_ratio_50 --use_loss --name run

The argparse surface of the JAX package's eval_ae_score.py (reference
eval_ae_score.py:13-78), plus --device as every port CLI (default cuda; no
card and no --device cpu raises), though it computes on the host. Both runs'
cae_checkpoints/{p2_step}_steps_seed{seed}/cae_training_loss.npy (last
epoch; --use_loss is required), the baseline's
logits_netD_eval.pkl or, failing that, logits_netD_train.pkl (the MNIST
phase-1 scripts record train-mode logits) scored over the window
[p1_step - 5000, p1_step]. Rows ["Ratio", "Seed", "Type", "Baseline",
"Resample", "Difference(%)"] go to ./re_{dataset}_{name}.csv (a header
when the file is new) for "all" and the minority ("green" for color_mnist,
"fmnist" otherwise: bias label 1).
"""
from __future__ import annotations

import argparse
import csv
import os
import pickle
from pathlib import Path

import numpy as np

from diagan_tpu_torch.data.predefined import get_predefined_dataset
from diagan_tpu_torch.device import pin_fp32_precision, resolve_device
from diagan_tpu_torch.score import calculate_scores
from diagan_tpu_torch.utils import set_seed


def main(argv=None):
    """Returns the CSV rows written: [major_ratio, seed, type, baseline,
    resample, difference %]."""
    pin_fp32_precision()
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", "-d", default="color_mnist", type=str)
    parser.add_argument("--root", "-r", default="./dataset/colour_mnist", type=str)
    parser.add_argument("--baseline_exp_path", default="color_mnist", type=str)
    parser.add_argument("--resample_exp_path", default="color_mnist", type=str)
    parser.add_argument("--p1_step", default=15000, type=int)
    parser.add_argument("--p2_step", default=20000, type=int)
    parser.add_argument("--resample_score", type=str)
    parser.add_argument("--use_loss", action="store_true")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--major_ratio", default=0.99, type=float)
    parser.add_argument("--num_data", default=10000, type=int)
    parser.add_argument("--name", type=str)
    parser.add_argument("--device", default="cuda", type=str)
    args = parser.parse_args(argv)
    resolve_device(args.device)
    if not args.use_loss:
        parser.error("the RE comparison reads cae_training_loss.npy: pass --use_loss")

    set_seed(args.seed)
    baseline_exp_path = Path(args.baseline_exp_path)
    resample_exp_path = Path(args.resample_exp_path)
    loss_file = f"cae_checkpoints/{args.p2_step}_steps_seed{args.seed}/cae_training_loss.npy"
    baseline_ae = np.load(baseline_exp_path / loss_file)[:, -1]
    resample_ae = np.load(resample_exp_path / loss_file)[:, -1]

    logit_path = baseline_exp_path / "logits_netD_eval.pkl"
    if not logit_path.is_file():
        logit_path = baseline_exp_path / "logits_netD_train.pkl"
    with open(logit_path, "rb") as f:
        logits = pickle.load(f)
    score_dict = calculate_scores(logits, start_epoch=args.p1_step - 5000,
                                  end_epoch=args.p1_step)
    weight_sort_index = np.argsort(np.asarray(score_dict[args.resample_score]))

    ds_train = get_predefined_dataset(dataset_name=args.dataset, root=args.root,
                                      major_ratio=args.major_ratio, num_data=args.num_data)

    csv_file = f"./re_{args.dataset}_{args.name}.csv"
    new_file = not os.path.exists(csv_file)
    rows = []
    with open(csv_file, "w" if new_file else "a", newline="") as f:
        wr = csv.writer(f)
        if new_file:
            wr.writerow(["Ratio", "Seed", "Type", "Baseline", "Resample", "Difference(%)"])
        minority_name = "green" if args.dataset == "color_mnist" else "fmnist"
        test_dict = {"all": weight_sort_index, minority_name: np.where(ds_train.labels == 1)}
        for idx_name, index in test_dict.items():
            b = baseline_ae[index].mean()
            r = resample_ae[index].mean()
            diff = (r - b) / b * 100
            print(f"{idx_name}, baseline_mean: {b}, resample_mean: {r} diff: {diff}%")
            rows.append([args.major_ratio, args.seed, idx_name, b, r, diff])
            wr.writerow(rows[-1])
    return rows


if __name__ == "__main__":
    main()
