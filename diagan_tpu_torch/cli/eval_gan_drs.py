"""FID + IS + PR of a checkpoint under DRS: the paper's evaluation.

    python -m diagan_tpu_torch.cli.eval_gan_drs -d cifar10 -r ./dataset/cifar10 \\
        --exp_name cifar10_p2 --netG_ckpt_step 80000

The argparse surface of the JAX package's eval_gan_drs.py, plus --device.
As cli.eval_gan, with every fake drawn by DRS at batch 256 through netD_drs
(or, with --use_original_netD, the run's own netD: a phase-1 model under
DRS, reference eval_gan_drs.py:28); the fakes are cached with a _drs tag.
"""
from __future__ import annotations

import argparse

from diagan_tpu_torch.cli.eval_gan import add_eval_flags, evaluate_fid_is_pr
from diagan_tpu_torch.device import pin_fp32_precision, resolve_device
from diagan_tpu_torch.models.registry import get_gan_model
from diagan_tpu_torch.utils import set_seed


def main(argv=None):
    """Evaluate under DRS; returns the three metrics' result dicts."""
    pin_fp32_precision()
    parser = add_eval_flags(argparse.ArgumentParser(), gpu_default=None)
    parser.add_argument("--use_original_netD", action="store_true")
    parser.add_argument("--device", default="cuda", type=str)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if not args.netG_ckpt_step:
        parser.error("--netG_ckpt_step is required")
    set_seed(args.seed)
    bundle = get_gan_model(dataset_name=args.dataset, model=args.model,
                           loss_type=args.loss_type, drs=True, device=device)
    return evaluate_fid_is_pr(args, bundle, device, use_drs=True,
                              use_original_netD=args.use_original_netD, batch_size=256)


if __name__ == "__main__":
    main()
