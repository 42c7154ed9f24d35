"""FID against the top- and bottom-scored real examples, with DRS sampling
(the JAX package's eval_gan_drs_with_index.py: cli.eval_gan_with_index's
surface plus --use_original_netD).

    python -m diagan_tpu_torch.cli.eval_gan_drs_with_index ... --netG_ckpt_step 80000
"""
from __future__ import annotations

from diagan_tpu_torch.cli.eval_gan_with_index import build_parser, run


def main(argv=None):
    parser = build_parser()
    parser.add_argument("--use_original_netD", action="store_true")
    args = parser.parse_args(argv)
    return run(args, use_drs=True, use_original_netD=args.use_original_netD)


if __name__ == "__main__":
    main()
