"""Train a CelebA single-attribute classifier for the attribute study.

    python -m diagan_tpu_torch.cli.train_convnet_celeba -r ./dataset/celeba \\
        --attr Bald --num_epochs 10

The argparse surface of the JAX package's train_convnet_celeba.py, plus
--device (default cuda; no card and no --device cpu raises). A binary
attr-vs-not AttrClassifier (num_attrs=2, trained from scratch: the
reference's pretrained vgg16 cannot be fetched) on CelebA's train split at
64 px; accuracy on the valid and test splits. The official split boundaries
(162,770 / 182,637) apply to the full 202,599 images and scale in
proportion on a smaller set. Writes {work_dir}/attr_classifier/{attr}.pth
(a torch state_dict; the JAX package writes Flax bytes under the same name,
and neither reads the other's) and {attr}_results.csv. --model and --gpu
are accepted and ignored, as in the JAX package.
"""
from __future__ import annotations

import argparse
import csv
from pathlib import Path

import numpy as np
import torch

from diagan_tpu_torch.data.sources import CELEBA_ATTR_NAMES, load_celeba
from diagan_tpu_torch.device import pin_fp32_precision, resolve_device
from diagan_tpu_torch.models.convnets import AttrClassifier
from diagan_tpu_torch.train.classifier import predict_classifier, train_classifier
from diagan_tpu_torch.utils import set_seed

CELEBA_N, CELEBA_TRAIN, CELEBA_VALID = 202599, 162770, 182637


def split_bounds(n):
    """(end of train, end of valid) for a CelebA set of n images."""
    if n >= CELEBA_N:
        return CELEBA_TRAIN, CELEBA_VALID
    return int(n * CELEBA_TRAIN / CELEBA_N), int(n * CELEBA_VALID / CELEBA_N)


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", "-r", default="./dataset/celeba", type=str)
    parser.add_argument("--work_dir", default="./exp_results", type=str)
    parser.add_argument("--model", default="vgg16", type=str)
    parser.add_argument("--gpu", default="0", type=str)
    parser.add_argument("--batch_size", default=128, type=int)
    parser.add_argument("--seed", default=1, type=int)
    parser.add_argument("--num_epochs", default=10, type=int)
    parser.add_argument("--attr", default="Bald", type=str)
    parser.add_argument("--device", default="cuda", type=str)
    return parser


def main(argv=None):
    """Train and evaluate; returns (model, history, val_acc, test_acc)."""
    pin_fp32_precision()
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    set_seed(args.seed)
    images, attrs = load_celeba(args.root, size=64)
    col = CELEBA_ATTR_NAMES.index(args.attr)
    labels = (attrs[:, col] == 1).astype(np.int64)
    tr, va = split_bounds(len(images))
    model = AttrClassifier(num_attrs=2, device=device)
    model, history = train_classifier(model, images[:tr], labels[:tr], epochs=args.num_epochs,
                                      batch_size=args.batch_size, seed=args.seed)

    def acc(split_imgs, split_labels):
        logits = predict_classifier(model, split_imgs)
        return float((logits.argmax(-1) == split_labels).mean())

    val_acc = acc(images[tr:va], labels[tr:va])
    test_acc = acc(images[va:], labels[va:])
    print(f"val_acc: {val_acc}, test_acc: {test_acc}")

    save_path = Path(args.work_dir) / "attr_classifier"
    save_path.mkdir(parents=True, exist_ok=True)
    torch.save(model.state_dict(), save_path / f"{args.attr}.pth")
    with open(save_path / f"{args.attr}_results.csv", "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(["attr", "train_acc", "val_acc", "test_acc"])
        wr.writerow([args.attr, history[-1]["acc"], val_acc, test_acc])
    return model, history, val_acc, test_acc


if __name__ == "__main__":
    main()
