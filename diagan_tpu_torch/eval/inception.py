"""InceptionV3 feature extractor for FID/IS/KID/PR (counterpart of
diagan_tpu/eval/inception.py). NCHW inside, NHWC images in.

The FID-Inception topology (pool3 = 2048-d features, a 1008-way logits head
for IS), with the two pytorch-fid patches: every average pool excludes the
padded zeros (count_include_pad=False), and Mixed_7c (the second InceptionE)
max-pools its pool branch. Submodules carry pytorch-fid's / torchvision's
names (Conv2d_1a_3x3, ..., Mixed_7c, branch1x1, ...), registered in
torchvision's order, which is also the order of the JAX package's Flax
auto-names sorted naturally (ConvBN_10 after ConvBN_2); both weight paths
below rely on it:

  - `load_torch_weights(model, path)` reads a pytorch-fid / torchvision
    state_dict file by definition order, as the JAX loader does
    (AuxLogits dropped, each tensor shape-checked, a count mismatch raises);
  - utils/jax_params.py `inception_state_dict` bridges the Flax variables.

InceptionFeaturizer takes its weights from a path argument or
DIAGAN_TPU_INCEPTION_WEIGHTS ("loaded"); without a file it falls back to
random weights from a seeded CPU generator ("random"), whose features are
standardised by a fixed affine from a 48-image probe. Metrics from random
weights are relative pipeline numbers only, not comparable to published
FIDs (nor to the JAX package's random-weight numbers: Flax's init draws
other weights); every metric JSON says which weights it used.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from diagan_tpu_torch.device import resolve_device

INCEPTION_SIZE = 299


class ConvBN(nn.Module):
    """Conv without bias, BatchNorm (eps 1e-3) on its running statistics, ReLU."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0, device="cpu"):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False,
                              device=device)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3, device=device)

    def forward(self, x):
        bn = self.bn
        x = F.batch_norm(self.conv(x), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                         training=False, eps=bn.eps)
        return F.relu(x)


def _avg_pool(x):
    # the FID-Inception patch: TF's average pool leaves the padded zeros out
    # of the mean (reference models/inception.py:222-223)
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin, pool_features, device="cpu"):
        super().__init__()
        kw = dict(device=device)
        self.branch1x1 = ConvBN(cin, 64, 1, **kw)
        self.branch5x5_1 = ConvBN(cin, 48, 1, **kw)
        self.branch5x5_2 = ConvBN(48, 64, 5, padding=2, **kw)
        self.branch3x3dbl_1 = ConvBN(cin, 64, 1, **kw)
        self.branch3x3dbl_2 = ConvBN(64, 96, 3, padding=1, **kw)
        self.branch3x3dbl_3 = ConvBN(96, 96, 3, padding=1, **kw)
        self.branch_pool = ConvBN(cin, pool_features, 1, **kw)

    def forward(self, x):
        return torch.cat([
            self.branch1x1(x),
            self.branch5x5_2(self.branch5x5_1(x)),
            self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
            self.branch_pool(_avg_pool(x)),
        ], 1)


class InceptionB(nn.Module):
    def __init__(self, cin, device="cpu"):
        super().__init__()
        kw = dict(device=device)
        self.branch3x3 = ConvBN(cin, 384, 3, stride=2, **kw)
        self.branch3x3dbl_1 = ConvBN(cin, 64, 1, **kw)
        self.branch3x3dbl_2 = ConvBN(64, 96, 3, padding=1, **kw)
        self.branch3x3dbl_3 = ConvBN(96, 96, 3, stride=2, **kw)

    def forward(self, x):
        return torch.cat([
            self.branch3x3(x),
            self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
            F.max_pool2d(x, 3, stride=2),
        ], 1)


class InceptionC(nn.Module):
    def __init__(self, cin, c7, device="cpu"):
        super().__init__()
        kw = dict(device=device)
        self.branch1x1 = ConvBN(cin, 192, 1, **kw)
        self.branch7x7_1 = ConvBN(cin, c7, 1, **kw)
        self.branch7x7_2 = ConvBN(c7, c7, (1, 7), padding=(0, 3), **kw)
        self.branch7x7_3 = ConvBN(c7, 192, (7, 1), padding=(3, 0), **kw)
        self.branch7x7dbl_1 = ConvBN(cin, c7, 1, **kw)
        self.branch7x7dbl_2 = ConvBN(c7, c7, (7, 1), padding=(3, 0), **kw)
        self.branch7x7dbl_3 = ConvBN(c7, c7, (1, 7), padding=(0, 3), **kw)
        self.branch7x7dbl_4 = ConvBN(c7, c7, (7, 1), padding=(3, 0), **kw)
        self.branch7x7dbl_5 = ConvBN(c7, 192, (1, 7), padding=(0, 3), **kw)
        self.branch_pool = ConvBN(cin, 192, 1, **kw)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for m in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                  self.branch7x7dbl_5):
            bd = m(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin, device="cpu"):
        super().__init__()
        kw = dict(device=device)
        self.branch3x3_1 = ConvBN(cin, 192, 1, **kw)
        self.branch3x3_2 = ConvBN(192, 320, 3, stride=2, **kw)
        self.branch7x7x3_1 = ConvBN(cin, 192, 1, **kw)
        self.branch7x7x3_2 = ConvBN(192, 192, (1, 7), padding=(0, 3), **kw)
        self.branch7x7x3_3 = ConvBN(192, 192, (7, 1), padding=(3, 0), **kw)
        self.branch7x7x3_4 = ConvBN(192, 192, 3, stride=2, **kw)

    def forward(self, x):
        b7 = self.branch7x7x3_1(x)
        for m in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = m(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7,
                          F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    """pool="max" is the FID graph's Mixed_7c, which max-pools its pool branch
    where every other block averages (reference models/inception.py:314-318)."""

    def __init__(self, cin, pool="avg", device="cpu"):
        super().__init__()
        kw = dict(device=device)
        self.branch1x1 = ConvBN(cin, 320, 1, **kw)
        self.branch3x3_1 = ConvBN(cin, 384, 1, **kw)
        self.branch3x3_2a = ConvBN(384, 384, (1, 3), padding=(0, 1), **kw)
        self.branch3x3_2b = ConvBN(384, 384, (3, 1), padding=(1, 0), **kw)
        self.branch3x3dbl_1 = ConvBN(cin, 448, 1, **kw)
        self.branch3x3dbl_2 = ConvBN(448, 384, 3, padding=1, **kw)
        self.branch3x3dbl_3a = ConvBN(384, 384, (1, 3), padding=(0, 1), **kw)
        self.branch3x3dbl_3b = ConvBN(384, 384, (3, 1), padding=(1, 0), **kw)
        self.branch_pool = ConvBN(cin, 192, 1, **kw)
        self.pool = pool

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = F.max_pool2d(x, 3, stride=1, padding=1) if self.pool == "max" else _avg_pool(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class InceptionV3(nn.Module):
    """forward(x: [-1, 1] NCHW) -> (pool3 (N, 2048), logits (N, 1008))."""

    def __init__(self, num_classes=1008, device="cpu"):
        super().__init__()
        kw = dict(device=device)
        self.Conv2d_1a_3x3 = ConvBN(3, 32, 3, stride=2, **kw)
        self.Conv2d_2a_3x3 = ConvBN(32, 32, 3, **kw)
        self.Conv2d_2b_3x3 = ConvBN(32, 64, 3, padding=1, **kw)
        self.Conv2d_3b_1x1 = ConvBN(64, 80, 1, **kw)
        self.Conv2d_4a_3x3 = ConvBN(80, 192, 3, **kw)
        self.Mixed_5b = InceptionA(192, 32, **kw)
        self.Mixed_5c = InceptionA(256, 64, **kw)
        self.Mixed_5d = InceptionA(288, 64, **kw)
        self.Mixed_6a = InceptionB(288, **kw)
        self.Mixed_6b = InceptionC(768, 128, **kw)
        self.Mixed_6c = InceptionC(768, 160, **kw)
        self.Mixed_6d = InceptionC(768, 160, **kw)
        self.Mixed_6e = InceptionC(768, 192, **kw)
        self.Mixed_7a = InceptionD(768, **kw)
        self.Mixed_7b = InceptionE(1280, **kw)
        self.Mixed_7c = InceptionE(2048, pool="max", **kw)
        self.fc = nn.Linear(2048, num_classes, device=device)

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                      self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e,
                      self.Mixed_7a, self.Mixed_7b, self.Mixed_7c):
            x = block(x)
        pool3 = x.mean(dim=(2, 3))
        return pool3, self.fc(pool3)


def conv_bn_names(model):
    """The model's ConvBN submodule names in definition order."""
    return [name for name, m in model.named_modules() if isinstance(m, ConvBN)]


def random_init_(model, seed=0):
    """Seeded random weights in place, drawn on the CPU so every device gets
    the same ones: conv and dense kernels lecun-normal (Flax's default
    initialiser: a normal truncated at 2 sigma, variance 1/fan_in), fc bias 0,
    BatchNorm scale 1, bias 0, running mean 0, running variance 1."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model


def load_torch_weights(model, path):
    """Load a torchvision / pytorch-fid InceptionV3 state_dict file into
    `model` by definition order (counterpart of the JAX package's
    load_torch_weights): AuxLogits dropped, the k-th conv weight and its
    BatchNorm to the k-th ConvBN, each copy shape-checked, and the fc layer
    when its shape fits (a torchvision file's is 1000-way). Raises on a count
    mismatch."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    sd = {k: v for k, v in sd.items() if "AuxLogits" not in k}
    conv_w = [v for k, v in sd.items() if k.endswith("conv.weight")]
    bn = {part: [v for k, v in sd.items() if k.endswith(f"bn.{part}")]
          for part in ("weight", "bias", "running_mean", "running_var")}
    names = conv_bn_names(model)
    if len(names) != len(conv_w):
        raise ValueError(f"conv count mismatch: {len(names)} port vs {len(conv_w)} torch")
    modules = dict(model.named_modules())

    def put(dst, src, where):
        if tuple(dst.shape) != tuple(src.shape):
            raise ValueError(f"shape mismatch at {where}: {tuple(dst.shape)} vs "
                             f"{tuple(src.shape)}")
        dst.copy_(src)

    with torch.no_grad():
        for i, name in enumerate(names):
            m = modules[name]
            put(m.conv.weight, conv_w[i], f"{name}.conv.weight")
            for part in ("weight", "bias", "running_mean", "running_var"):
                put(getattr(m.bn, part), bn[part][i], f"{name}.bn.{part}")
        fc_w, fc_b = sd.get("fc.weight"), sd.get("fc.bias")
        if fc_w is not None and tuple(fc_w.shape) == tuple(model.fc.weight.shape):
            put(model.fc.weight, fc_w, "fc.weight")
            put(model.fc.bias, fc_b, "fc.bias")
    return model


def _resize_weights(n_in, n_out):
    """(n_in, n_out) float32 matrix of jax.image.resize's "bilinear" along one
    axis (jax/_src/image/scale.py compute_weight_mat): half-pixel centres, a
    triangle kernel widened by 1/scale when shrinking (the antialias), the
    columns normalised. The sample positions are rounded once from float64,
    as XLA's fused multiply-add computes them inside the JAX featurizer's jit."""
    inv = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(inv, np.float32(1.0))
    sample = ((np.arange(n_out) + 0.5) * np.float64(inv) - 0.5).astype(np.float32)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = w.sum(0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.from_numpy(np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32))


def resize_bilinear(x, size):
    """jax.image.resize(x, (N, h, w, C), "bilinear") of a float NCHW tensor
    (the weights cast to its dtype), with (h, w) = `size` (an int: a
    square), as two contractions (rows, then columns) with _resize_weights'
    matrices, each one matrix product over the flattened other axes (on the
    CPU this sums as the JAX package's eager resize does: the probe's
    8 -> 64 upsample is bit-exact); an axis already at its size is left as
    it is, as in JAX."""
    sizes = (size, size) if isinstance(size, int) else tuple(size)
    for axis, n_out in zip((2, 3), sizes):
        n = x.shape[axis]
        if n != n_out:
            w = _resize_weights(n, n_out).to(x.device, x.dtype)
            x = torch.tensordot(x.movedim(axis, -1), w, dims=1).movedim(-1, axis)
    return x


def make_probe(noise_u, coarse_u):
    """The 48-image probe of the random-weight fallback (JAX
    InceptionFeaturizer, inception.py:209-229), NHWC float32 at 64 px, from
    two uniform [0, 1) draws of shapes (16, 64, 64, 3) and (16, 8, 8, 3):
    16 noise images, 16 smooth ones (the coarse draw resized to 64 px),
    8 vertical ramps of amplitude 0.25..1 and 8 flat images at -1..1."""
    noise = torch.tensor(np.asarray(noise_u), dtype=torch.float32) * 2 - 1
    coarse = torch.tensor(np.asarray(coarse_u), dtype=torch.float32) * 2 - 1
    smooth = resize_bilinear(coarse.permute(0, 3, 1, 2), 64).permute(0, 2, 3, 1)
    yy = torch.linspace(-1.0, 1.0, 64)[None, :, None, None]
    ramps = yy.expand(8, 64, 64, 3) * torch.linspace(0.25, 1.0, 8)[:, None, None, None]
    flat = torch.ones((8, 64, 64, 3)) * torch.linspace(-1.0, 1.0, 8)[:, None, None, None]
    return torch.cat([noise, smooth, ramps, flat])


def standardizing_affine(probe_features):
    """(shift, scale) in float64 from the probe's features: per-dimension
    mean and 1 / (std + 1e-12), then the scale divided so that the
    standardised probe features have unit RMS."""
    pf = np.asarray(probe_features, np.float64)
    shift = pf.mean(0)
    scale = 1.0 / (pf.std(0) + 1e-12)
    z = (pf - shift) * scale
    return shift, scale / np.sqrt((z**2).mean() + 1e-12)


def _resize_to_network(x):
    """A float NCHW batch resized to INCEPTION_SIZE, one channel repeated to
    three (the JAX package's fwd_one and _resize_for_inception)."""
    x = resize_bilinear(x, INCEPTION_SIZE)
    return x.repeat(1, 3, 1, 1) if x.shape[1] == 1 else x


def inception_input(images, device):
    """uint8 or float [-1, 1] NHWC images (numpy or tensor) -> the network's
    float32 NCHW input at 299 on `device`: uint8 crosses as uint8 and becomes
    x / 127.5 - 1 there, then resize_bilinear, and one channel is repeated to
    three (the JAX featurizer's fwd_one)."""
    x = torch.as_tensor(images).to(device)
    if x.dtype == torch.uint8:
        x = x.float() / 127.5 - 1.0
    return _resize_to_network(x.float().permute(0, 3, 1, 2))


def pool3_with_grad(model, x):
    """Raw pool3 features of a float [-1, 1] NCHW batch (a G's output), with
    gradients back to x: the JAX package's _resize_for_inception and
    incep_model.apply (train/inclusive.py:35-40, 66-68), no probe affine.
    resize_bilinear is two contractions, so it is differentiable; the
    network's BatchNorm uses its running statistics in either mode; the
    convolutions run with TF32 off."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        return model(_resize_to_network(x))[0]


class InceptionFeaturizer:
    """Batched feature extraction on `device` with weight management.

    features_and_logits(images) takes uint8 or float [-1, 1] NHWC images of
    any size as a numpy array or tensor, `batch_size` at a time through
    inception_input and the network. BatchNorm runs on its running
    statistics, so a short last batch gives the same rows as the JAX
    package's zero-padded one."""

    def __init__(self, weights_path=None, batch_size=100, device="cuda"):
        self.device = resolve_device(device)
        self.batch_size = batch_size
        weights_path = weights_path or os.environ.get("DIAGAN_TPU_INCEPTION_WEIGHTS")
        self.model = InceptionV3(device="cpu")
        if weights_path and os.path.exists(weights_path):
            load_torch_weights(self.model, weights_path)
            self.weights_kind = "loaded"
        else:
            random_init_(self.model, seed=0)
            self.weights_kind = "random"
        self.model.to(self.device).eval()
        # A randomly initialised deep net emits features at a tiny, nearly
        # degenerate scale, which costs precision downstream (cov, sqrtm):
        # the random fallback standardises them by a fixed affine from a
        # probe of noise, smooth images, ramps and flats. Loaded weights pass
        # through unchanged.
        self._feat_shift = self._feat_scale = None
        if self.weights_kind == "random":
            g = torch.Generator().manual_seed(1)
            probe = make_probe(torch.rand((16, 64, 64, 3), generator=g),
                               torch.rand((16, 8, 8, 3), generator=g))
            pf, _ = self._forward(probe)
            self._feat_shift, self._feat_scale = standardizing_affine(pf.cpu().numpy())

    @torch.no_grad()
    def _forward(self, images):
        """One batch of NHWC images -> (pool3, logits) on the device. The
        convolutions run in fp32 whatever torch.backends.cudnn.allow_tf32
        says (TF32 would move the features by ~1e-3 of their scale)."""
        x = inception_input(images, self.device)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return self.model(x)

    def features_and_logits(self, images):
        """-> (pool3 features, logits) as numpy arrays; features standardised
        (float64) under random weights."""
        feats, logits = [], []
        for s in range(0, len(images), self.batch_size):
            f, lg = self._forward(images[s: s + self.batch_size])
            feats.append(f.cpu().numpy())
            logits.append(lg.cpu().numpy())
        feats, logits = np.concatenate(feats), np.concatenate(logits)
        if self._feat_scale is not None:
            feats = (feats - self._feat_shift) * self._feat_scale
        return feats, logits

    def features(self, images):
        return self.features_and_logits(images)[0]
