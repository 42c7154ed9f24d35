"""Classifier training and prediction (counterpart of
diagan_tpu/train/classifier.py): the attribute classifier of the CelebA
study and the bias probes.

Adam(lr) whose lr is multistep_lr's value at each step's index (0.1 decays
at 3/7 and 6/7 of the epochs, as optax.piecewise_constant_schedule), softmax
cross-entropy with top-1 accuracy, or per-attribute sigmoid BCE with
(logits > 0) == (y > 0) accuracy when `multilabel`. Each epoch walks
np.random.default_rng(seed).permutation(n) in steps_per_epoch = max(1, n //
batch_size) batches (the tail dropped): the same numpy draws as the JAX
package, so a run compares step by step. The uint8 images go to the model's
device once and each batch becomes x / 127.5 - 1 there.

The JAX package hands one dropout key, unchanged, to every step
(diagan_tpu/train/classifier.py:42,57), so the whole run trains under one
dropout mask; the port keeps that: one keep mask per run, drawn from a
torch.Generator seeded from `seed` (or given as `dropout_mask`), on every
step. Checkpoints are torch state_dicts under the JAX package's file names;
`load_classifier` reads either package's (the JAX package writes Flax bytes of
{params, batch_stats}).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from diagan_tpu_torch.models.convnets import AttrClassifier, Simple3DNet, SimpleConvNet, SimpleNet
from diagan_tpu_torch.train.checkpoint import bridge_for, read_state_dict
from diagan_tpu_torch.utils import jax_params

# a classifier's class -> the bridge of its JAX twin's variables (subclasses first)
_BRIDGES = ((AttrClassifier, jax_params.attr_classifier_state_dict),
            (Simple3DNet, jax_params.simple3dnet_state_dict),
            (SimpleConvNet, jax_params.simple_convnet_state_dict),
            (SimpleNet, jax_params.simple_net_state_dict))


def load_classifier(model, path):
    """Load a classifier file into `model`, on its device: the port's torch
    state_dict ({attr}.pth of cli.train_convnet_celeba, ckpt_{epoch}.pt of
    train_classifier), or the JAX package's Flax bytes of {params,
    batch_stats} under the same names, through the bridge of the model's
    class. Returns the model."""
    model.load_state_dict(read_state_dict(path, lambda v: bridge_for(model, _BRIDGES)(v)))
    return model


def multistep_lr(base_lr, epochs, steps_per_epoch, gamma=0.1):
    """step index -> lr, float32 as optax's piecewise-constant schedule: each
    boundary's scale applies from that step index on. The boundaries are a
    dict, so equal ones collapse into one decay (at epochs = 1 both are 0:
    base_lr * gamma from step 0)."""
    b1 = (epochs * 3 // 7) * steps_per_epoch
    b2 = (epochs * 6 // 7) * steps_per_epoch
    bounds = sorted({b1: gamma, b2: gamma}.items())

    def schedule(count):
        v = np.float32(base_lr)
        for b, scale in bounds:
            if count >= b:
                v = np.float32(v * np.float32(scale))
        return float(v)

    return schedule


def _loss_and_acc(logits, y, multilabel):
    if multilabel:
        loss = F.binary_cross_entropy_with_logits(logits, (y > 0).float())
        acc = ((logits > 0) == (y > 0)).float().mean()
    else:
        loss = F.cross_entropy(logits, y)
        acc = (logits.argmax(-1) == y).float().mean()
    return loss, acc


def train_classifier(model, images, labels, epochs=80, batch_size=128, lr=1e-3, seed=1,
                     multilabel=False, ckpt_path=None, ckpt_every=10, dropout_mask=None):
    """images: uint8 NHWC; labels: int64 [N] (or {-1,+1} [N, A] when
    multilabel). Trains `model` in place on its device and returns (model,
    history), history a list of {"epoch", "loss", "acc"} (epoch means)."""
    device = next(model.parameters()).device
    n = len(images)
    steps_per_epoch = max(1, n // batch_size)
    schedule = multistep_lr(lr, epochs, steps_per_epoch)
    opt = torch.optim.Adam(model.parameters(), lr=schedule(0))
    imgs = torch.as_tensor(np.asarray(images)).to(device)
    labs = torch.as_tensor(np.asarray(labels)).to(device)
    kwargs = {}
    if isinstance(model, AttrClassifier):
        if dropout_mask is None:
            g = torch.Generator().manual_seed(seed + 2)
            dropout_mask = torch.rand((batch_size, 512), generator=g) < 0.5
        kwargs["dropout_mask"] = torch.as_tensor(dropout_mask, dtype=torch.bool).to(device)
    model.train()
    rng = np.random.default_rng(seed)
    history = []
    step = 0
    for epoch in range(1, epochs + 1):
        perm = rng.permutation(n)[: steps_per_epoch * batch_size]
        idxs = torch.from_numpy(perm.reshape(steps_per_epoch, batch_size)).to(device)
        losses, accs = [], []
        for idx in idxs:
            x = imgs[idx].float() / 127.5 - 1.0
            logits, _ = model(x, **kwargs)
            loss, acc = _loss_and_acc(logits, labs[idx], multilabel)
            for group in opt.param_groups:
                group["lr"] = schedule(step)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
            accs.append(acc)
            step += 1
        loss, acc = float(torch.stack(losses).mean()), float(torch.stack(accs).mean())
        history.append({"epoch": epoch, "loss": loss, "acc": acc})
        print(f"[{epoch} / {epochs}] train_acc: {acc * 100:.2f}")
        if ckpt_path and epoch % ckpt_every == 0:
            ckpt_path = Path(ckpt_path)
            ckpt_path.mkdir(parents=True, exist_ok=True)
            torch.save(model.state_dict(), ckpt_path / f"ckpt_{epoch}.pt")
    return model, history


@torch.no_grad()
def predict_classifier(model, images, batch_size=256):
    """Eval-mode logits (numpy) for uint8 NHWC images, `batch_size` at a time
    on the model's device; the last batch is padded with zeros, as in the JAX
    package, and the result cut to len(images). (The JAX package's 1 GB slabs
    are its TPU dispatch batching; here each batch is one forward.)"""
    device = next(model.parameters()).device
    model.eval()
    images = np.asarray(images)
    n = len(images)
    out = []
    for s in range(0, n, batch_size):
        batch = torch.as_tensor(images[s: s + batch_size]).to(device)
        pad = batch_size - len(batch)
        if pad:
            batch = torch.cat([batch, batch.new_zeros((pad,) + batch.shape[1:])])
        logits, _ = model(batch.float() / 127.5 - 1.0)
        out.append(logits[: batch_size - pad].cpu())
    return torch.cat(out).numpy()[:n]
