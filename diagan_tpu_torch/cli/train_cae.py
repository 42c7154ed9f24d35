"""CAE reconstruction-error training of a run's G (the CAE protocol of
Colored-MNIST and MNIST-FMNIST): draw 50,000 images from the G checkpoint,
through DRS where the run has a twin D, train a CAE on them and record each
real example's reconstruction error after every epoch.

    python -m diagan_tpu_torch.cli.train_cae -d color_mnist \\
        -r ./dataset/colour_mnist --exp_name colour_mnist_p2 --netG_step 20000

The argparse surface of the JAX package's train_cae.py (reference
train_cae.py:112-213), plus --device (default cuda; no card and no --device
cpu raises); --gpu, --netG_train_mode and --cae_ckpt_path are accepted and
unused, as there. DRS (batch 256) is used if and only if
checkpoints/netD_drs/netD_drs_{step}_steps.pth exists. Files under
{work_dir}/{exp_name}, with the reference's names:
netG_{step}_steps_seed{seed}_generated_dataset.pkl (skipped with
--generated_dataset_path), cae_checkpoints/{step}_steps_seed{seed}/
cae_training_loss.npy [N, epochs], netG_{step}_steps_seed{seed}_epoch{epochs}
_ae_score.pkl (the last epoch's RE) and the sorted-score grids. The samplers
draw from seeded torch.Generators and the CAE's weights from --seed
(models/cae.py), where the JAX package uses its keys.
"""
from __future__ import annotations

import argparse
import pickle
from pathlib import Path

from diagan_tpu_torch.data.generated import load_generated
from diagan_tpu_torch.data.predefined import get_predefined_dataset
from diagan_tpu_torch.device import resolve_device
from diagan_tpu_torch.eval.cae_protocol import generate_dataset, train_cae
from diagan_tpu_torch.eval.drs import DRS
from diagan_tpu_torch.eval.evaluate import Sampler, load_eval_models, make_disc_fn, make_gen_fn
from diagan_tpu_torch.models.cae import get_ae_model
from diagan_tpu_torch.models.registry import get_gan_model
from diagan_tpu_torch.utils import set_seed
from diagan_tpu_torch.utils.plot import show_sorted_score_samples


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", "-d", default="cifar10", type=str)
    parser.add_argument("--root", "-r", default="./dataset/cifar10", type=str)
    parser.add_argument("--work_dir", default="./exp_results", type=str)
    parser.add_argument("--exp_name", default="mimicry_pretrained-seed1", type=str)
    parser.add_argument("--gpu", default="0", type=str)
    parser.add_argument("--batch_size", default=128, type=int)
    parser.add_argument("--seed", default=1, type=int)
    parser.add_argument("--epochs", default=50, type=int)
    parser.add_argument("--netG_step", type=int)
    parser.add_argument("--netG_train_mode", action="store_true")
    parser.add_argument("--cae_ckpt_path", type=str)
    parser.add_argument("--model", type=str)
    parser.add_argument("--loss_type", default="ns", type=str)
    parser.add_argument("--generated_dataset_path", type=str)
    parser.add_argument("--major_ratio", default=0.99, type=float)
    parser.add_argument("--num_data", default=10000, type=int)
    parser.add_argument("--num_pack", default=1, type=int)
    parser.add_argument("--topk", action="store_true")
    parser.add_argument("--device", default="cuda", type=str)
    return parser


def main(argv=None):
    """Returns the RE matrix [N_real, epochs]."""
    parser = build_parser()
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if not args.netG_step:
        parser.error("--netG_step is required")
    save_path = Path(f"{args.work_dir}/{args.exp_name}")
    save_path.mkdir(parents=True, exist_ok=True)
    set_seed(args.seed)
    step = args.netG_step

    bundle = get_gan_model(args.dataset, model=args.model, drs=True, loss_type=args.loss_type,
                           topk=args.topk, num_pack=args.num_pack, device=device)
    use_drs = (save_path / f"checkpoints/netD_drs/netD_drs_{step}_steps.pth").is_file()
    gen, disc = load_eval_models(bundle, save_path, step, use_drs=use_drs)
    if use_drs:
        sampler = DRS(make_gen_fn(gen), make_disc_fn(disc), bundle.nz, batch_size=256,
                      device=device)
    else:
        sampler = Sampler(make_gen_fn(gen), bundle.nz, batch_size=256, device=device)
    print(f"use drs: {use_drs}")

    ds_test = get_predefined_dataset(dataset_name=args.dataset, root=args.root,
                                     major_ratio=args.major_ratio, num_data=args.num_data)
    if args.generated_dataset_path:
        print(f"skip data generation, use: {args.generated_dataset_path}")
        gen_imgs = load_generated(args.generated_dataset_path).images
    else:
        gen_path = save_path / f"netG_{step}_steps_seed{args.seed}_generated_dataset.pkl"
        gen_imgs = generate_dataset(sampler.generate_images, gen_path)
        print(f"data generated in: {gen_path}")

    cae = get_ae_model(args.dataset, in_channels=bundle.nc, seed=args.seed, device=device)
    cae_ckpt_path = save_path / "cae_checkpoints" / f"{step}_steps_seed{args.seed}"
    re = train_cae(cae, gen_imgs, ds_test.images, cae_ckpt_path, epochs=args.epochs,
                   batch_size=args.batch_size, seed=args.seed)
    final_score = re[:, -1]
    stem = f"netG_{step}_steps_seed{args.seed}_epoch{args.epochs}_ae_score"
    with open(save_path / f"{stem}.pkl", "wb") as f:
        pickle.dump(final_score, f)
    show_sorted_score_samples(dataset=ds_test, score=final_score, save_path=save_path,
                              score_name="ae_score", plot_name=stem)
    return re


if __name__ == "__main__":
    main()
