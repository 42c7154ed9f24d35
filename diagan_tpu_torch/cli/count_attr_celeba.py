"""Count an attribute among a checkpoint's samples with the trained
attribute classifier: does phase 2 + DRS draw more of the rare ones?

    python -m diagan_tpu_torch.cli.count_attr_celeba --exp_name celeba_p2 \\
        --netG_ckpt_step 75000 --attr Bald --drs

The argparse surface of the JAX package's count_attr_celeba.py, plus
--device. Draws --num_samples images from the SNGAN-64 G at --netG_ckpt_step
(plainly, or by DRS through netD_drs, or with --use_original_netD the run's
own netD), at batch 256; turns them to uint8 by clip((x + 1) * 127.5, 0,
255) and truncation, as the JAX package does; classifies them with
{work_dir}/attr_classifier/{attr}.pth (cli.train_convnet_celeba's torch
state_dict, or the JAX package's Flax bytes: train/classifier.py
load_classifier) at --batch_size; writes count_attr_{attr}{_drs}.json under the
run. --classifier, --gpu and --netG_train_mode are accepted and ignored.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from diagan_tpu_torch.device import resolve_device
from diagan_tpu_torch.eval.drs import DRS
from diagan_tpu_torch.eval.evaluate import Sampler, load_eval_models, make_disc_fn, make_gen_fn
from diagan_tpu_torch.models.convnets import AttrClassifier
from diagan_tpu_torch.models.registry import get_gan_model
from diagan_tpu_torch.train.classifier import load_classifier, predict_classifier
from diagan_tpu_torch.utils import set_seed


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--work_dir", default="./exp_results", type=str)
    parser.add_argument("--exp_name", default="mimicry_pretrained-seed1", type=str)
    parser.add_argument("--model", default="sngan", type=str)
    parser.add_argument("--loss_type", default="hinge", type=str)
    parser.add_argument("--classifier", default="vgg16", type=str)
    parser.add_argument("--gpu", default="0", type=str)
    parser.add_argument("--batch_size", default=100, type=int)
    parser.add_argument("--seed", default=1, type=int)
    parser.add_argument("--netG_ckpt_step", type=int)
    parser.add_argument("--netG_train_mode", action="store_true")
    parser.add_argument("--use_original_netD", action="store_true")
    parser.add_argument("--attr", default="Bald", type=str)
    parser.add_argument("--drs", action="store_true")
    parser.add_argument("--num_samples", default=50000, type=int)
    parser.add_argument("--device", default="cuda", type=str)
    return parser


def make_sampler(bundle, save_path, step, use_drs, use_original_netD, device):
    """The plain Sampler, or DRS through the run's DRS discriminator, at batch 256."""
    gen, disc = load_eval_models(bundle, save_path, step, use_drs=use_drs,
                                 use_original_netD=use_original_netD)
    if use_drs:
        return DRS(make_gen_fn(gen), make_disc_fn(disc), bundle.nz, batch_size=256,
                   device=device)
    return Sampler(make_gen_fn(gen), bundle.nz, batch_size=256, device=device)


def main(argv=None):
    """Count; returns the JSON's dict."""
    parser = build_parser()
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if not args.netG_ckpt_step:
        parser.error("--netG_ckpt_step is required")
    set_seed(args.seed)
    save_path = Path(f"{args.work_dir}/{args.exp_name}")
    bundle = get_gan_model("celeba", model=args.model, loss_type=args.loss_type, drs=args.drs,
                           device=device)
    sampler = make_sampler(bundle, save_path, args.netG_ckpt_step, args.drs,
                           args.use_original_netD, device)

    clf_path = Path(args.work_dir) / "attr_classifier" / f"{args.attr}.pth"
    if not clf_path.is_file():
        raise FileNotFoundError(f"train the classifier first: {clf_path}")
    model = AttrClassifier(num_attrs=2, device=device)
    load_classifier(model, clf_path)

    imgs = sampler.generate_images(args.num_samples)
    imgs_u8 = np.clip((imgs + 1) * 127.5, 0, 255).astype(np.uint8)
    logits = predict_classifier(model, imgs_u8, batch_size=args.batch_size)
    positive = int((logits.argmax(-1) == 1).sum())
    frac = positive / args.num_samples
    print(f"attr {args.attr}: {positive}/{args.num_samples} = {frac:.4f}")
    out = {"attr": args.attr, "count": positive, "total": args.num_samples, "fraction": frac}
    (save_path / f"count_attr_{args.attr}{'_drs' if args.drs else ''}.json").write_text(
        json.dumps(out))
    return out


if __name__ == "__main__":
    main()
