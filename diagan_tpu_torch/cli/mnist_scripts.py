"""The Colored-MNIST / MNIST-FMNIST script family (counterpart of
diagan_tpu/cli/mnist_scripts.py): phase 1, phase 2 and the GOLD phase 2 of
each, behind the entry points cli/train_mimicry_{color_mnist,mnist_fmnist}_
phase{1,2,2_gold}.py.

    python -m diagan_tpu_torch.cli.train_mimicry_color_mnist_phase1 \\
        --num_steps 20000 [--device cpu]
    python -m diagan_tpu_torch.cli.train_mimicry_color_mnist_phase2 \\
        --exp_name colour_mnist_p2 --baseline_exp_name colour_mnist \\
        --p1_step 10000 --resample_score ldr_conf_1.0_ratio_50

Flags and defaults as the JAX scripts' (n_dis 1, ns loss in phase 1, 20k
steps, no decay, vis every 100, checkpoints every 1000), with their
per-script differences (_base_parser), plus --device (default cuda; no card
and no --device cpu raises). --bf16 builds the DCGAN with the bf16 compute
dtype, as the JAX scripts do; --simultaneous_g is accepted and changes
nothing, as there (the JAX scripts pass no step_fusions). The outputs are the JAX package's: checkpoints,
the train-mode `logits_netD_train.pkl` of phase 1 (none with PacGAN,
--num_pack > 1), the score sorts and the first resampled batch of phase 2,
and for Colored-MNIST the red/green counts of 1000 samples after each run
and, after phase 2, of 1000 DRS samples (batch 250) from the twin D. The
sample latents, the resampled batch and DRS draw from seeded
torch.Generators where the JAX package uses its keys, and the figures are
PNGs (utils/plot.py).
"""
from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np
import torch

from diagan_tpu_torch.cli.common import (
    add_common_train_flags,
    data_parallel_from_args,
    is_main,
    latest_ckpt_step,
    resolve_phase2_resume,
)
from diagan_tpu_torch.data.predefined import get_predefined_dataset
from diagan_tpu_torch.device import pin_fp32_precision, resolve_device
from diagan_tpu_torch.models.registry import get_gan_model
from diagan_tpu_torch.score import calculate_scores, warn_if_degenerate_weights
from diagan_tpu_torch.train.logger import save_image_grid
from diagan_tpu_torch.train.trainer import LogTrainer
from diagan_tpu_torch.utils import set_seed
from diagan_tpu_torch.utils.plot import (
    plot_color_mnist_generator,
    plot_score_sort,
    print_num_params,
)


def _base_parser(dataset, root, exp, num_steps=20000, model="mnistgan", use_clipping=True,
                 quiet=False):
    """The flag surface varies per JAX script: --use_clipping exists in the
    phase-1 and GOLD phase-2 scripts only, --quiet in the mnist_fmnist family
    only, and the fmnist phase-1 --model default is 'mnist_dcgan'. Both are
    accepted and unused, as in the reference."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", "-d", default=dataset, type=str)
    parser.add_argument("--root", "-r", default=root, type=str)
    parser.add_argument("--exp_name", default=exp, type=str)
    parser.add_argument("--model", default=model, type=str)
    if quiet:
        parser.add_argument("--quiet", dest="quiet", action="store_true",
                            help="reference CLI compat; unused there too")
    parser.add_argument("--num_pack", default=1, type=int)
    if use_clipping:
        parser.add_argument("--use_clipping", action="store_true")
    parser.add_argument("--num_steps", default=num_steps, type=int)
    parser.add_argument("--logit_save_steps", default=100, type=int)
    parser.add_argument("--decay", default="None", type=str)
    parser.add_argument("--n_dis", default=1, type=int)
    parser.add_argument("--major_ratio", default=0.99, type=float)
    parser.add_argument("--num_data", default=10000, type=int)
    add_common_train_flags(parser)
    return parser


def _decay(args):
    return args.decay if args.decay not in ("None", "none", "") else None


def _setup(parser, argv):
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    save_path = Path(f"{args.work_dir}/{args.exp_name}")
    save_path.mkdir(parents=True, exist_ok=True)
    set_seed(args.seed)
    return args, device, save_path


def _dataset(args):
    return get_predefined_dataset(dataset_name=args.dataset, root=args.root,
                                  major_ratio=args.major_ratio, num_data=args.num_data)


def _gen_fn_from_trainer(trainer, n_batch=250):
    """num_images -> eval-mode G samples (numpy NHWC), n_batch latents at a
    time from a generator seeded 123."""
    def gen(num_images):
        g = torch.Generator(trainer.device).manual_seed(123)
        out = []
        for _ in range(-(-num_images // n_batch)):
            z = torch.randn((n_batch, trainer.bundle.nz), generator=g, device=trainer.device)
            out.append(trainer.generate_images(z=z).cpu().numpy())
        return np.concatenate(out)[:num_images]

    return gen


def _trainer(args, device, save_path, bundle, ds, **kwargs):
    return LogTrainer(output_path=save_path, bundle=bundle, dataset=ds,
                      num_steps=args.num_steps, n_dis=args.n_dis, lr_decay=_decay(args),
                      batch_size=args.batch_size, log_dir=str(save_path), print_steps=10,
                      save_steps=1000, vis_steps=100, logit_save_steps=args.logit_save_steps,
                      seed=args.seed, device=device, **kwargs)


def _phase1_ckpts(args, baseline_save_path):
    base = Path(baseline_save_path)
    return (base / f"checkpoints/netG/netG_{args.p1_step}_steps.pth",
            base / f"checkpoints/netD/netD_{args.p1_step}_steps.pth")


def phase1(dataset, root, exp, argv=None):
    """Phase 1: train G and D, recording D's train-mode logits every
    --logit_save_steps (not with PacGAN). Returns the trainer."""
    pin_fp32_precision()
    fmnist = dataset == "mnist_fmnist"
    parser = _base_parser(dataset, root, exp, model="mnist_dcgan" if fmnist else "mnistgan",
                          quiet=fmnist)
    parser.add_argument("--loss_type", default="ns", type=str)
    parser.add_argument("--topk", default=0, type=int)
    parser.add_argument("--resample_score", type=str)
    args, device, save_path = _setup(parser, argv)
    dp, device = data_parallel_from_args(args, device)

    bundle = get_gan_model(dataset_name=args.dataset, model=args.model, num_pack=args.num_pack,
                           loss_type=args.loss_type, topk=args.topk == 1, bf16=args.bf16,
                           device=device)
    ds_train = _dataset(args)
    print(args)

    netG_ckpt = netD_ckpt = None
    if args.auto_resume:
        own = latest_ckpt_step(save_path)
        if own:
            netG_ckpt = str(save_path / f"checkpoints/netG/netG_{own}_steps.pth")
            netD_ckpt = str(save_path / f"checkpoints/netD/netD_{own}_steps.pth")
            print(f"auto-resuming from step {own}")

    trainer = _trainer(args, device, save_path, bundle, ds_train,
                       netG_ckpt_file=netG_ckpt, netD_ckpt_file=netD_ckpt,
                       topk=args.topk == 1,
                       save_logits=args.num_pack == 1,  # PacGAN records none (reference :130)
                       save_eval_logits=False,  # train-mode logits (reference :131)
                       data_parallel=dp)
    print_num_params(bundle.gen, bundle.disc)
    trainer.train()
    if dataset == "color_mnist" and is_main(dp):
        trainer.channel_counts = plot_color_mnist_generator(
            _gen_fn_from_trainer(trainer), save_path=save_path, file_name="eval_p1")
    return trainer


def phase2(dataset, root, exp, argv=None):
    """Phase 2: LDR-score resampling from the phase-1 logits and the twin DRS
    discriminator (MNIST-FMNIST: --gold turns GOLD on from --p1_step).
    Returns the trainer."""
    pin_fp32_precision()
    fmnist = dataset == "mnist_fmnist"
    # --use_clipping exists in the fmnist phase-2 script but not the
    # color_mnist one
    parser = _base_parser(dataset, root, exp, use_clipping=fmnist, quiet=fmnist)
    parser.add_argument("--baseline_exp_name",
                        default="mnist_fmnist_baseline" if fmnist else exp, type=str)
    parser.add_argument("--p1_step", default=10000, type=int)
    parser.add_argument("--resample_score", type=str)
    parser.add_argument("--loss_type", default="ns" if fmnist else "hinge", type=str)
    parser.add_argument("--use_eval_logits", type=int)
    if fmnist:
        # the reference fmnist phase 2 only (train_mimicry_mnist_fmnist_phase2.py:65,156-157)
        parser.add_argument("--gold", action="store_true")
    args, device, save_path = _setup(parser, argv)
    dp, device = data_parallel_from_args(args, device)
    gold = bool(getattr(args, "gold", False))
    baseline_save_path = Path(f"{args.work_dir}/{args.baseline_exp_name}")
    prefix = args.exp_name.split("/")[-1]

    bundle = get_gan_model(dataset_name=args.dataset, model=args.model, drs=True, gold=gold,
                           loss_type=args.loss_type, num_pack=args.num_pack, bf16=args.bf16,
                           device=device)
    netG_ckpt, netD_ckpt = _phase1_ckpts(args, baseline_save_path)
    netG_ckpt, netD_ckpt, netD_drs_ckpt = resolve_phase2_resume(args, save_path, netG_ckpt,
                                                                netD_ckpt, netD_ckpt)

    logit_name = "netD_eval" if args.use_eval_logits == 1 else "netD_train"
    logit_path = baseline_save_path / f"logits_{logit_name}.pkl"
    print(f"Use logit from: {logit_path}")
    with open(logit_path, "rb") as f:
        logits = pickle.load(f)
    score_dict = calculate_scores(logits, start_epoch=args.p1_step - 5000,
                                  end_epoch=args.p1_step)
    sample_weights = (np.asarray(score_dict[args.resample_score])
                      if args.resample_score is not None else None)
    if sample_weights is not None:
        print(f"sample_weights mean: {sample_weights.mean()}, var: {sample_weights.var()}, "
              f"max: {sample_weights.max()}, min: {sample_weights.min()}")
        warn_if_degenerate_weights(sample_weights, args.resample_score)

    ds_train = _dataset(args)
    if is_main(dp):
        plot_score_sort(ds_train, score_dict, save_path=save_path,
                        phase=f"{prefix}_{args.p1_step - 5000}-{args.p1_step}_score")
    print(args, netG_ckpt, netD_ckpt)

    trainer = _trainer(args, device, save_path, bundle, ds_train,
                       sample_weights=sample_weights, dataset_drs=ds_train,
                       netG_ckpt_file=str(netG_ckpt), netD_ckpt_file=str(netD_ckpt),
                       netD_drs_ckpt_file=str(netD_drs_ckpt), save_logits=False, gold=gold,
                       gold_step=args.p1_step if gold else 0, data_parallel=dp)
    if is_main(dp):  # the first resampled batch (reference :119-121)
        src = trainer.source
        imgs = src.gather(src.sample_indices(64, torch.Generator(device).manual_seed(0)))
        save_image_grid(imgs.cpu().numpy(), save_path / f"{prefix}_resampled_train_data_p2.png")
    print_num_params(bundle.gen, bundle.disc)
    trainer.train()

    if dataset == "color_mnist" and is_main(dp):
        from diagan_tpu_torch.eval.drs import DRS
        from diagan_tpu_torch.eval.evaluate import make_disc_fn, make_gen_fn

        trainer.channel_counts = plot_color_mnist_generator(
            _gen_fn_from_trainer(trainer), save_path=save_path, file_name=f"{prefix}-eval_p2")
        # DRS-filtered generation (reference :158-163)
        sampler = DRS(make_gen_fn(bundle.gen), make_disc_fn(bundle.disc_drs), bundle.nz,
                      batch_size=250, device=device)
        trainer.drs = sampler
        trainer.drs_channel_counts = plot_color_mnist_generator(
            lambda n: sampler.generate_images(n), save_path=save_path,
            file_name=f"{prefix}-eval_drs_percent80_p2")
    return trainer


def phase2_gold(dataset, root, exp, argv=None):
    """The GOLD baseline's phase 2 from the phase-1 checkpoints, GOLD on from
    --p1_step, uniform data. Returns the trainer."""
    pin_fp32_precision()
    fmnist = dataset == "mnist_fmnist"
    parser = _base_parser(dataset, root, exp, quiet=fmnist)
    parser.add_argument("--baseline_exp_name",
                        default="mnist_fmnist_baseline" if fmnist else exp, type=str)
    parser.add_argument("--p1_step", default=10000, type=int)
    if not fmnist:
        # declared and unused in the reference color_mnist GOLD script
        parser.add_argument("--resample_score", type=str)
    parser.add_argument("--loss_type", default="ns" if fmnist else "hinge", type=str)
    if fmnist:
        # declared and unused in the reference
        parser.add_argument("--use_eval_logits", type=int)
    args, device, save_path = _setup(parser, argv)
    dp, device = data_parallel_from_args(args, device)
    baseline_save_path = Path(f"{args.work_dir}/{args.baseline_exp_name}")
    prefix = args.exp_name.split("/")[-1]

    bundle = get_gan_model(dataset_name=args.dataset, model=args.model,
                           loss_type=args.loss_type, gold=True, num_pack=args.num_pack,
                           bf16=args.bf16, device=device)
    netG_ckpt, netD_ckpt = _phase1_ckpts(args, baseline_save_path)
    netG_ckpt, netD_ckpt, _ = resolve_phase2_resume(args, save_path, netG_ckpt, netD_ckpt)
    ds_train = _dataset(args)
    print(args, netG_ckpt, netD_ckpt)

    trainer = _trainer(args, device, save_path, bundle, ds_train,
                       netG_ckpt_file=str(netG_ckpt), netD_ckpt_file=str(netD_ckpt),
                       save_logits=False, gold=True, gold_step=args.p1_step, data_parallel=dp)
    print_num_params(bundle.gen, bundle.disc)
    trainer.train()
    if dataset == "color_mnist" and is_main(dp):
        trainer.channel_counts = plot_color_mnist_generator(
            _gen_fn_from_trainer(trainer), save_path=save_path, file_name=f"{prefix}-eval_p2")
    return trainer


def bias_probe(dataset, root, stem, argv=None):
    """The bias-probe classifier (the JAX package's
    train_{color_mnist,mnist_fmnist}_feature.py): SimpleConvNet(num_labels=20)
    trained on the bias labels of a balanced (major_ratio 0.5) build, batch
    128, checkpoints every 10 epochs under
    ./exp_results/{stem}-{num_data}-seed{seed}/. Returns (model, history)."""
    pin_fp32_precision()
    from diagan_tpu_torch.models.convnets import SimpleConvNet
    from diagan_tpu_torch.train.classifier import train_classifier

    parser = argparse.ArgumentParser()
    parser.add_argument("--gpu", type=int, default=0)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--bs", type=int, default=64)
    parser.add_argument("--epochs", type=int, default=80)
    parser.add_argument("--num_data", type=int, default=10000)
    parser.add_argument("--device", default="cuda", type=str)
    opt = parser.parse_args(argv)
    device = resolve_device(opt.device)

    set_seed(opt.seed)
    ds = get_predefined_dataset(dataset_name=dataset, root=root, major_ratio=0.5,
                                num_data=opt.num_data)
    model = SimpleConvNet(num_labels=20, device=device, in_ch=ds.images.shape[-1])
    return train_classifier(model, ds.images, ds.labels, epochs=opt.epochs, batch_size=128,
                            seed=opt.seed,
                            ckpt_path=f"./exp_results/{stem}-{opt.num_data}-seed{opt.seed}")
