"""Inclusive GAN: the nearest-latent reconstruction and interpolation terms
of G's loss (counterpart of diagan_tpu/train/inclusive.py; reference
diagan-pkg/diagan/models/inclusive_gan.py:82-369).

  - every real training image is embedded once through the featurizer
    (`features`: under random Inception weights, standardised by the probe
    affine);
  - at construction and then every refresh_every = max(1, num_data //
    batch_size * 20) steps, latent_factor * num_data latents go through G in
    eval mode and the network in chunks of 500, and each real example keeps
    the latent whose raw pool3 features are nearest to its own: squared
    distances in the expanded form |a|^2 - 2 a.b + |b|^2 (as the JAX
    package computes them, so that fp32 argmins match), the first index on a
    tie, a running minimum with strict <;
  - G's loss gains LAMB * recons + BETA * itp (LAMB 10, BETA 4, SIGMA 0.05),
    through the fused step's g_aux_loss hook (train/steps.py): two uniform
    index draws pick real features and their nearest latents, each latent
    plus SIGMA times a normal draw goes through G, recons = the mean of the
    two feature distances / 2, and itp the alpha-weighted distances of
    G(alpha z1 + (1 - alpha) z2) to both, alpha a uniform draw. The hook's
    G forwards run in train mode on batch statistics without moving G's
    running statistics (the JAX hook's gen_fwd(..., mutable=False)), and its
    features are raw pool3 (eval/inception.py pool3_with_grad) with
    gradients back to G: the JAX package's choice; the reference's numpy
    features carried none (docs/PARITY.md deviation 2).

Kept from the JAX package, as ROADMAP.md Queue C records: under random
Inception weights the real features are standardised and the G-side
features raw (two scales); the hook's G forwards read no running statistics,
so the stale G state the JAX jit captures is read by nothing.

Draws (train/steps.py): the hook's kinds "inclusive_idx1",
"inclusive_idx2" (indices), "inclusive_z1", "inclusive_z2" (normal) and
"inclusive_alpha" (uniform), in that order, after the step's "g_z"; the
refresh's latents from a torch.Generator seeded from (seed + 4, step): fresh
latents at every refresh, as the reference draws them (the JAX trainer folds
its key with its global step, which stays at the run's first step inside
train(), so its every refresh draws the same latents).
"""
from __future__ import annotations

import torch

from diagan_tpu_torch.data.sampler import sample_uniform_indices
from diagan_tpu_torch.eval.inception import InceptionFeaturizer, pool3_with_grad
from diagan_tpu_torch.train.steps import seeded_generator
from diagan_tpu_torch.train.trainer import LogTrainer

SIGMA = 0.05
LAMB = 10.0
BETA = 0.4 * LAMB


def _pool3(model, images):
    """Raw pool3 of NHWC G output."""
    return pool3_with_grad(model, images.permute(0, 3, 1, 2))


class InclusiveLoss:
    """The g_aux_loss hook: (gen, draws, i, metrics) -> LAMB * recons +
    BETA * itp, with reconsG and itpG in metrics. model: the featurizer's
    network; train_feats: (num_data, d) real features; nearest_latent:
    (num_data, nz), set by the refresh."""

    def __init__(self, model, train_feats, batch_size, nz):
        self.model = model
        self.train_feats = train_feats
        self.nearest_latent = None
        self.batch_size = batch_size
        self.nz = nz

    def sample_indices(self, n, generator):
        """Uniform draws over the real examples (the source the hook's index
        draws read)."""
        return sample_uniform_indices(len(self.train_feats), n, generator,
                                      self.train_feats.device)

    def __call__(self, gen, draws, i, metrics):
        bs, device = self.batch_size, self.train_feats.device
        idx1 = draws.indices("inclusive_idx1", i, self, bs)
        idx2 = draws.indices("inclusive_idx2", i, self, bs)
        feat1, feat2 = self.train_feats[idx1], self.train_feats[idx2]
        nz1 = self.nearest_latent[idx1] + SIGMA * draws.normal("inclusive_z1", i, bs, self.nz,
                                                               device)
        nz2 = self.nearest_latent[idx2] + SIGMA * draws.normal("inclusive_z2", i, bs, self.nz,
                                                               device)
        gen1, gen2 = gen(nz1), gen(nz2)  # the JAX hook's order of forwards
        f1, f2 = _pool3(self.model, gen1), _pool3(self.model, gen2)
        recons = 0.5 * ((f1 - feat1).norm(dim=-1) + (f2 - feat2).norm(dim=-1)).mean()
        alpha = draws.uniform("inclusive_alpha", i, bs, device)
        itp_z = alpha[:, None] * nz1 + (1 - alpha[:, None]) * nz2
        fi = _pool3(self.model, gen(itp_z))
        itp = (alpha * (fi - feat1).norm(dim=-1) + (1 - alpha) * (fi - feat2).norm(dim=-1)).mean()
        metrics["reconsG"] = recons
        metrics["itpG"] = itp
        return LAMB * recons + BETA * itp


@torch.no_grad()
def nearest_latents(gen, model, train_feats, num_latent, draw, chunk=500):
    """For each row of train_feats, the latent among num_latent draws
    (draw(n) -> (n, nz), called per chunk) whose G image's raw pool3
    features are nearest, G in eval mode. Returns (latents, squared
    distances)."""
    was_training = gen.training
    gen.eval()
    sq = (train_feats ** 2).sum(1)[:, None]
    best_d = torch.full((len(train_feats),), float("inf"), dtype=train_feats.dtype,
                        device=train_feats.device)
    best_z = None
    for start in range(0, num_latent, chunk):
        z = draw(min(chunk, num_latent - start))
        if best_z is None:
            best_z = torch.zeros((len(train_feats), z.shape[1]), dtype=z.dtype, device=z.device)
        pool3 = _pool3(model, gen(z))
        d = sq - 2 * train_feats @ pool3.T + (pool3 ** 2).sum(1)[None, :]
        d_min, idx = d.min(dim=1)
        better = d_min < best_d
        best_d = torch.where(better, d_min, best_d)
        best_z[better] = z[idx[better]]
    gen.train(was_training)
    return best_z, best_d


class InclusiveTrainer(LogTrainer):
    """LogTrainer with Inclusive GAN's G-loss terms (module docstring).
    featurizer: an object with `features(images)` (numpy rows, one per
    image) and `model` (a network returning (pool3, logits)); default the
    FID InceptionV3 (eval/inception.py) on the trainer's device."""

    def __init__(self, *args, featurizer=None, refresh_multiplier=20, latent_factor=10,
                 **kwargs):
        super().__init__(*args, g_aux_loss=self._aux_loss, **kwargs)
        self.featurizer = featurizer or InceptionFeaturizer(device=self.device)
        self.featurizer.model.requires_grad_(False)
        self.refresh_every = max(1, self.num_data // self.cfg.batch_size * refresh_multiplier)
        self.latent_factor = latent_factor
        feats = self.featurizer.features(self.source.dataset.images)
        self.inclusive = InclusiveLoss(
            self.featurizer.model,
            torch.as_tensor(feats, dtype=torch.float32, device=self.device),
            self.cfg.batch_size, self.bundle.nz)
        self.refresh_nearest_latents(self.global_step)
        step_fn = self.fused_step

        def fused_step(global_step, draws):
            if global_step > 0 and global_step % self.refresh_every == 0:
                self.refresh_nearest_latents(global_step)
            return step_fn(global_step, draws)

        self.fused_step = fused_step

    def _aux_loss(self, gen, draws, i, metrics):
        return self.inclusive(gen, draws, i, metrics)

    def refresh_nearest_latents(self, step):
        generator = seeded_generator(self.seed + 4, step, self.device)
        nz = self.bundle.nz
        self.inclusive.nearest_latent, _ = nearest_latents(
            self.g.module, self.featurizer.model, self.inclusive.train_feats,
            self.latent_factor * self.num_data,
            lambda n: torch.randn((n, nz), generator=generator, device=self.device))
        print(f"INFO: refreshed nearest latents (step {step})")
