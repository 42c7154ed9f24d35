"""CelebA attribute-sliced partial recall and FID with DRS sampling.

    python -m diagan_tpu_torch.cli.eval_gan_drs_celeba_with_attr -r ./dataset/celeba \\
        --exp_name celeba_p2 --netG_ckpt_step 75000 --attr Bald --metric all

cli.eval_gan_celeba_with_attr with every fake drawn by DRS at batch 256
through netD_drs (or, with --use_original_netD, the run's own netD); the
JSONs carry a drs_ tag.
"""
from __future__ import annotations

from diagan_tpu_torch.cli.eval_gan_celeba_with_attr import build_parser, run


def main(argv=None):
    parser = build_parser()
    parser.add_argument("--use_original_netD", action="store_true")
    args = parser.parse_args(argv)
    return run(args, use_drs=True, use_original_netD=args.use_original_netD)


if __name__ == "__main__":
    main()
