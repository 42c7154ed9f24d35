"""The CAE reconstruction-error protocol of Colored-MNIST and MNIST-FMNIST
(counterpart of diagan_tpu/eval/cae_protocol.py; reference train_cae.py and
eval_ae_score.py):

  1. draw 50,000 images from G, through DRS where the run has a twin D,
     into a uint8 pickle (generate_dataset);
  2. train a CAE (models/cae.py) on them: MSE, Adam(lr 1e-3, eps 1e-7) with
     the L2 term 5e-4 added to the gradient before the moments, batch 128;
  3. after every epoch, each REAL example's reconstruction error
     RE = ||x_hat - x||_2 / 32, in eval mode, stored at its index:
     `cae_training_loss.npy` of shape [N, epochs] (train_cae);
  4. eval_ae_score: the last epoch's mean RE of a baseline and a resampled
     run over all and the minority examples, and their % difference.

As the JAX train_cae: each epoch takes `np.random.default_rng(seed)`'s
next permutation of the generated images and keeps the first
steps * batch_size (drop-last); every train-mode forward moves the CAE's
BatchNorm statistics; the sweep runs batches of 256. The CAE's initial
weights are the module's own (models/cae.py draws them from its seed);
`cae_epoch-{e}.pth` is the CAE's torch state_dict (the JAX package writes
Flax bytes of {params, batch_stats}); load_cae reads either.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from diagan_tpu_torch.data.generated import save_generated
from diagan_tpu_torch.train.checkpoint import read_state_dict
from diagan_tpu_torch.utils.jax_params import cae_state_dict


def load_cae(cae, path):
    """Load a `cae_epoch-{e}.pth` into `cae` (a models/cae.py module), on its
    device: the port's torch state_dict, or the JAX package's Flax bytes of
    {params, batch_stats} through utils/jax_params.py cae_state_dict.
    Returns the module."""
    cae.load_state_dict(read_state_dict(path, cae_state_dict))
    return cae


def make_cae_optimizer(params, lr=1e-3, eps=1e-7, weight_decay=5e-4):
    """torch Adam's weight_decay adds weight_decay * param to the gradient
    before the moments, as the JAX package's add_decayed_weights + adam
    chain (make_cae_tx:30): on every parameter, BatchNorm's included."""
    return torch.optim.Adam(params, lr=lr, eps=eps, weight_decay=weight_decay)


def generate_dataset(generate_images_fn, save_path, num_images=50000, step_data=1000):
    """Draw `num_images` uint8 images in one request to a sampler's
    generate_images (eval.evaluate.Sampler or eval.drs.DRS, which quantize
    on the device) and pickle them (data/generated.py save_generated).
    step_data is the reference's signature only: the samplers batch
    internally."""
    del step_data
    arr = np.asarray(generate_images_fn(num_images, return_uint8=True))[:num_images]
    save_generated(save_path, arr)
    return arr


def _dequantize(x, dtype):
    """uint8 -> x / 127.5 - 1 in float32, then the CAE's dtype. (The JAX
    package's formula; jitted on the CPU, XLA rounds 205 of the 256 codes one
    ulp away from this division.)"""
    return (x.float() / 127.5 - 1.0 if x.dtype == torch.uint8 else x).to(dtype)


@torch.no_grad()
def reconstruction_errors(cae, real, norm_div=32.0, batch_size=256):
    """Eval-mode RE = ||cae(x) - x||_2 / norm_div of every image of `real`
    (a uint8 or float NHWC tensor on the CAE's device), as a float32 numpy
    array (float64 for a float64 CAE)."""
    cae.eval()
    dtype = next(cae.parameters()).dtype
    out = []
    for s in range(0, len(real), batch_size):
        batch = _dequantize(real[s: s + batch_size], dtype)
        out.append(torch.sqrt(((cae(batch) - batch) ** 2).flatten(1).sum(1)) / norm_div)
    return torch.cat(out).cpu().numpy()


def train_cae(cae, generated_images, real_images, save_path, epochs=100, batch_size=128,
              seed=0, norm_div=32.0, model_save_epochs=50):
    """Train `cae` (a models/cae.py module, on its device, with the weights
    to start from) on the generated images; returns the RE matrix
    [N_real, epochs] and writes cae_training_loss.npy (and a checkpoint every
    model_save_epochs) under save_path. Images: uint8 [0, 255] or float
    [-1, 1] NHWC numpy arrays."""
    save_path = Path(save_path)
    save_path.mkdir(parents=True, exist_ok=True)
    device, dtype = next(cae.parameters()).device, next(cae.parameters()).dtype
    gen = torch.from_numpy(np.ascontiguousarray(generated_images)).to(device)
    real = torch.from_numpy(np.ascontiguousarray(real_images)).to(device)
    steps = len(gen) // batch_size
    opt = make_cae_optimizer(cae.parameters())
    rng = np.random.default_rng(seed)
    re_epochs = []
    for epoch in range(1, epochs + 1):
        perm = rng.permutation(len(gen))[: steps * batch_size]
        idx = torch.from_numpy(perm).to(device).view(steps, batch_size)
        cae.train()
        losses = []
        for s in range(steps):
            batch = _dequantize(gen[idx[s]], dtype)
            loss = ((cae(batch) - batch) ** 2).mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        re_epochs.append(reconstruction_errors(cae, real, norm_div))
        print(f"Epoch: [{epoch} | {epochs}], loss: {float(torch.stack(losses).mean()):.6f}")
        if epoch % model_save_epochs == 0:
            torch.save(cae.state_dict(), save_path / f"cae_epoch-{epoch}.pth")
    loss_epoch_arr = np.stack(re_epochs, axis=1)  # [N, epochs]
    np.save(save_path / "cae_training_loss.npy", loss_epoch_arr)
    return loss_epoch_arr


def eval_ae_score(baseline_loss_npy, resampled_loss_npy, minority_mask):
    """% RE change of the resampled run against the baseline, over all and
    the minority examples (reference eval_ae_score.py:32-78); lower RE is
    better."""
    base = np.load(baseline_loss_npy)[:, -1]
    res = np.load(resampled_loss_npy)[:, -1]
    minority_mask = np.asarray(minority_mask, bool)
    out = {}
    for name, sel in (("all", np.ones_like(minority_mask)), ("minority", minority_mask)):
        b, r = base[sel].mean(), res[sel].mean()
        out[name] = {"baseline": float(b), "resampled": float(r),
                     "pct_diff": float((r - b) / b * 100.0)}
    return out
