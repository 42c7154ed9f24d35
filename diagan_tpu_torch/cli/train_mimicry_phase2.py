"""Phase-2 Dia-GAN training for CIFAR-10 (SNGAN-32) and CelebA (SNGAN-64,
-d celeba): LDR-score weighted resampling and the twin DRS discriminator
(or the --gold / --topk baselines).

    python -m diagan_tpu_torch.cli.train_mimicry_phase2 -d cifar10 \\
        -r ./dataset/cifar10 --exp_name cifar10_p2 --baseline_exp_name cifar10 \\
        --p1_step 40000 --resample_score ldr_conf_1.0_ratio_50

The argparse surface of the JAX package's train_mimicry_phase2.py, plus
--device. It scores `logits_netD_eval.pkl` of the baseline run over the 5000
steps before --p1_step, floors the weights at 1e-6, restores G and D from
the phase-1 checkpoints, starts netD_drs from netD's phase-1 file (weights,
Adam state and update count), turns GOLD on from --p1_step, and trains on
to --num_steps without recording logits. The phase-1 files may be the
port's, the JAX package's or the reference's (train/checkpoint.py
restore_net: from a reference file Adam and the lr schedule start afresh, as
in the JAX package). --data_parallel as in phase 1.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from diagan_tpu_torch.cli.common import (
    add_common_train_flags,
    data_parallel_from_args,
    is_main,
    load_phase1_scores,
    phase1_ckpt_paths,
    resolve_phase2_resume,
    step_fusions_from_args,
)
from diagan_tpu_torch.data.predefined import get_predefined_dataset
from diagan_tpu_torch.device import pin_fp32_precision, resolve_device
from diagan_tpu_torch.models.registry import get_gan_model
from diagan_tpu_torch.train.trainer import LogTrainer
from diagan_tpu_torch.utils import set_seed
from diagan_tpu_torch.utils.plot import print_num_params, show_sorted_score_samples


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", "-d", default="cifar10", type=str)
    parser.add_argument("--root", "-r", default="./dataset/cifar10", type=str)
    parser.add_argument("--exp_name", type=str)
    parser.add_argument("--baseline_exp_name", type=str)
    parser.add_argument("--p1_step", default=40000, type=int)
    parser.add_argument("--model", default="sngan", type=str)
    parser.add_argument("--loss_type", default="hinge", type=str)
    parser.add_argument("--num_steps", default=80000, type=int)
    parser.add_argument("--decay", default="linear", type=str)
    parser.add_argument("--n_dis", default=5, type=int)
    parser.add_argument("--resample_score", type=str)
    parser.add_argument("--gold", action="store_true")
    parser.add_argument("--topk", action="store_true")
    # median-centre each logit snapshot before scoring (score/score.py)
    parser.add_argument("--normalize_logits", action="store_true")
    return add_common_train_flags(parser)


def main(argv=None):
    """Train phase 2; returns the trainer."""
    pin_fp32_precision()
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    dp, device = data_parallel_from_args(args, device)
    output_dir = f"{args.work_dir}/{args.exp_name}"
    save_path = Path(output_dir)
    save_path.mkdir(parents=True, exist_ok=True)
    baseline_save_path = Path(f"{args.work_dir}/{args.baseline_exp_name}")
    set_seed(args.seed)
    prefix = args.exp_name.split("/")[-1]

    window = 5000  # all datasets (reference :78-83)
    if not args.gold:
        sample_weights = load_phase1_scores(baseline_save_path, args.p1_step,
                                            args.resample_score, window,
                                            normalize_logits=args.normalize_logits)
    else:
        sample_weights = None

    netG_ckpt_path, netD_ckpt_path = phase1_ckpt_paths(baseline_save_path, args.p1_step)
    # D_drs starts from netD's phase-1 weights (reference :98-101)
    netG_ckpt_path, netD_ckpt_path, netD_drs_ckpt_path = resolve_phase2_resume(
        args, save_path, netG_ckpt_path, netD_ckpt_path, netD_ckpt_path)

    bundle = get_gan_model(dataset_name=args.dataset, model=args.model,
                           loss_type=args.loss_type, drs=True, topk=args.topk, gold=args.gold,
                           bf16=args.bf16, device=device)
    ds_train = get_predefined_dataset(dataset_name=args.dataset, root=args.root)

    if not args.gold and is_main(dp):
        show_sorted_score_samples(ds_train, score=sample_weights, save_path=save_path,
                                  score_name=args.resample_score, plot_name=prefix)
    print(args)

    trainer = LogTrainer(
        output_path=save_path,
        bundle=bundle,
        dataset=ds_train,
        sample_weights=sample_weights,
        dataset_drs=ds_train,
        num_steps=args.num_steps,
        n_dis=args.n_dis,
        lr_decay=args.decay,
        batch_size=args.batch_size,
        netG_ckpt_file=str(netG_ckpt_path),
        netD_ckpt_file=str(netD_ckpt_path),
        netD_drs_ckpt_file=str(netD_drs_ckpt_path),
        log_dir=output_dir,
        print_steps=10,
        save_steps=1000,
        topk=args.topk,
        gold=args.gold,
        gold_step=args.p1_step,
        save_logits=False,
        seed=args.seed,
        weight_eps=1e-6,  # reference get_dataloader eps (:21-23)
        device=device,
        step_fusions=step_fusions_from_args(args),
        data_parallel=dp,
    )
    print_num_params(bundle.gen, bundle.disc)
    return trainer.train()


if __name__ == "__main__":
    main()
