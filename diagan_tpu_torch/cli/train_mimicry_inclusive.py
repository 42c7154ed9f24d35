"""Inclusive-GAN training on Colored-MNIST / MNIST-FMNIST: the MNIST DCGAN
with the nearest-latent reconstruction and interpolation terms in G's loss
(advG + 10 recons + 4 itp; nearest latents refreshed every
num_data // batch_size * 20 steps; train/inclusive.py).

    python -m diagan_tpu_torch.cli.train_mimicry_inclusive -d color_mnist \\
        -r ./dataset/colour_mnist --exp_name colour_inclusive --num_steps 20000

The argparse surface of the JAX package's train_mimicry_inclusive.py, plus
--device (default cuda; no card and no --device cpu raises). --bf16,
--simultaneous_g and --data_parallel are accepted and change nothing, as in
the root script, which passes none of them on. The model is
the MNIST DCGAN whatever --model says, with train-mode logits recorded as
the phase-1 scripts do (not with PacGAN). The features come from the FID
InceptionV3, with its weights from DIAGAN_TPU_INCEPTION_WEIGHTS or its
seeded random fallback. After a Colored-MNIST run, the red/green counts of
1000 samples (latents from a generator seeded 123) are drawn as
eval_inclusive_channel_counts.png.
"""
from __future__ import annotations

import argparse

from diagan_tpu_torch.cli.common import add_common_train_flags
from diagan_tpu_torch.cli.mnist_scripts import _dataset, _decay, _gen_fn_from_trainer, _setup
from diagan_tpu_torch.device import pin_fp32_precision
from diagan_tpu_torch.models.registry import get_gan_model
from diagan_tpu_torch.train.inclusive import InclusiveTrainer
from diagan_tpu_torch.utils.plot import plot_color_mnist_generator, print_num_params


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", "-d", default="color_mnist", type=str)
    parser.add_argument("--root", "-r", default="./dataset/colour_mnist", type=str)
    parser.add_argument("--exp_name", default="colour_mnist", type=str)
    parser.add_argument("--loss_type", default="ns", type=str)
    parser.add_argument("--model", default="mnist_dcgan", type=str)
    parser.add_argument("--num_pack", default=1, type=int)
    parser.add_argument("--use_clipping", action="store_true")
    parser.add_argument("--num_steps", default=20000, type=int)
    parser.add_argument("--logit_save_steps", default=100, type=int)
    parser.add_argument("--decay", default="None", type=str)
    parser.add_argument("--n_dis", default=1, type=int)
    parser.add_argument("--major_ratio", default=0.99, type=float)
    parser.add_argument("--num_data", default=10000, type=int)
    parser.add_argument("--topk", default=0, type=int)
    parser.add_argument("--resample_score", type=str)
    add_common_train_flags(parser)
    return parser


def main(argv=None):
    """Returns the trainer (with .channel_counts after a Colored-MNIST run)."""
    pin_fp32_precision()
    args, device, save_path = _setup(build_parser(), argv)
    bundle = get_gan_model(dataset_name=args.dataset, model="mnistgan", num_pack=args.num_pack,
                           loss_type=args.loss_type, topk=args.topk == 1, device=device)
    ds_train = _dataset(args)
    print(args)

    trainer = InclusiveTrainer(
        output_path=save_path, bundle=bundle, dataset=ds_train, num_steps=args.num_steps,
        n_dis=args.n_dis, lr_decay=_decay(args), batch_size=args.batch_size,
        log_dir=str(save_path), print_steps=10, save_steps=1000, vis_steps=100,
        logit_save_steps=args.logit_save_steps, save_logits=args.num_pack == 1,
        save_eval_logits=False, seed=args.seed, device=device)
    print_num_params(bundle.gen, bundle.disc)
    trainer.train()
    if args.dataset == "color_mnist":
        trainer.channel_counts = plot_color_mnist_generator(
            _gen_fn_from_trainer(trainer), save_path=save_path, file_name="eval_inclusive")
    return trainer


if __name__ == "__main__":
    main()
