"""Phase-1 training for CIFAR-10 (SNGAN-32) and CelebA (SNGAN-64): train G
and D, and record D's per-example logits for the LDR scores.

    python -m diagan_tpu_torch.cli.train_mimicry_phase1 -d cifar10 \\
        -r ./dataset/cifar10 --exp_name cifar10

The argparse surface of the JAX package's train_mimicry_phase1.py, plus
--device (default cuda; no card and no --device cpu raises), and its
schedule overrides (cifar10: 50k steps, logits recorded every 100 steps over
35k-40k; celeba: 75k steps, logits over 55k-60k) unless
--no_schedule_override. --root holds cifar-10-batches-py/, or CelebA's
celeba_64.npy (or img_align_celeba/) and list_attr_celeba.txt; without
them, a procedural stand-in (50k CIFAR images, 20k CelebA ones). Writes
checkpoints/{netG,netD}/*_{step}_steps.pth and logits_netD_eval.pkl under
{work_dir}/{exp_name}. --data_parallel trains over every rank of the process
group (one process per card under `torchrun --standalone --nproc_per_node=N
-m diagan_tpu_torch.cli.train_mimicry_phase1 --data_parallel ...`, else a
world of one in process); --batch_size stays the global batch.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from diagan_tpu_torch.cli.common import (
    add_common_train_flags,
    data_parallel_from_args,
    latest_ckpt_step,
    step_fusions_from_args,
)
from diagan_tpu_torch.data.predefined import get_predefined_dataset
from diagan_tpu_torch.device import pin_fp32_precision, resolve_device
from diagan_tpu_torch.models.registry import get_gan_model
from diagan_tpu_torch.train.trainer import LogTrainer
from diagan_tpu_torch.utils import set_seed
from diagan_tpu_torch.utils.plot import print_num_params


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", "-d", default="cifar10", type=str)
    parser.add_argument("--root", "-r", default="./dataset/cifar10", type=str,
                        help="dataset dir")
    parser.add_argument("--exp_name", default="cifar10", type=str)
    parser.add_argument("--model", default="sngan", type=str)
    parser.add_argument("--loss_type", default="hinge", type=str)
    parser.add_argument("--num_pack", default=1, type=int)
    parser.add_argument("--download_dataset", action="store_true")
    parser.add_argument("--topk", action="store_true")
    parser.add_argument("--num_steps", default=100000, type=int)
    parser.add_argument("--logit_save_steps", default=100, type=int)
    parser.add_argument("--decay", default="linear", type=str)
    parser.add_argument("--n_dis", default=5, type=int)
    parser.add_argument("--imb_factor", default=0.1, type=float)
    parser.add_argument("--celeba_class_attr", default="glass", type=str)
    parser.add_argument("--ckpt_step", type=int)
    parser.add_argument("--no_save_logits", action="store_true")
    parser.add_argument("--no_schedule_override", action="store_true")
    parser.add_argument("--save_logit_after", default=30000, type=int)
    parser.add_argument("--stop_save_logit_after", default=60000, type=int)
    return add_common_train_flags(parser)


def main(argv=None):
    """Train phase 1; returns the trainer."""
    pin_fp32_precision()
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    dp, device = data_parallel_from_args(args, device)
    output_dir = f"{args.work_dir}/{args.exp_name}"
    save_path = Path(output_dir)
    save_path.mkdir(parents=True, exist_ok=True)
    set_seed(args.seed)

    bundle = get_gan_model(dataset_name=args.dataset, model=args.model,
                           loss_type=args.loss_type, topk=args.topk, num_pack=args.num_pack,
                           bf16=args.bf16, device=device)
    ds_train = get_predefined_dataset(dataset_name=args.dataset, root=args.root)

    # dataset-conditional schedule overrides (reference :82-92);
    # --no_schedule_override keeps the given ones, for short runs
    if args.no_schedule_override:
        pass
    elif args.dataset == "celeba":
        args.num_steps = 75000
        args.logit_save_steps = 100
        args.save_logit_after = 55000
        args.stop_save_logit_after = 60000
    elif args.dataset == "cifar10":
        args.num_steps = 50000
        args.logit_save_steps = 100
        args.save_logit_after = 35000
        args.stop_save_logit_after = 40000
    print(args)

    if not args.ckpt_step and args.auto_resume:
        args.ckpt_step = latest_ckpt_step(save_path)
        if args.ckpt_step:
            print(f"auto-resuming from step {args.ckpt_step}")
    if args.ckpt_step:
        netG_ckpt_file = save_path / f"checkpoints/netG/netG_{args.ckpt_step}_steps.pth"
        netD_ckpt_file = save_path / f"checkpoints/netD/netD_{args.ckpt_step}_steps.pth"
    else:
        netG_ckpt_file = netD_ckpt_file = None

    trainer = LogTrainer(
        output_path=save_path,
        bundle=bundle,
        dataset=ds_train,
        num_steps=args.num_steps,
        n_dis=args.n_dis,
        lr_decay=args.decay,
        batch_size=args.batch_size,
        netG_ckpt_file=netG_ckpt_file,
        netD_ckpt_file=netD_ckpt_file,
        log_dir=output_dir,
        print_steps=10,
        save_steps=1000,
        logit_save_steps=args.logit_save_steps,
        topk=args.topk,
        save_logits=not args.no_save_logits,
        save_logit_after=args.save_logit_after,
        stop_save_logit_after=args.stop_save_logit_after,
        seed=args.seed,
        device=device,
        step_fusions=step_fusions_from_args(args),
        data_parallel=dp,
    )
    print_num_params(bundle.gen, bundle.disc)
    return trainer.train()


if __name__ == "__main__":
    main()
