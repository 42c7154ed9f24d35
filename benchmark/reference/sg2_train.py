"""Plain StyleGAN2 + ADA training, phase 2 of Dia-GAN: the reference that
follows the program's first steps, and the count of a step's work.

One training step at global step t, as rosinality's train.py and the
Dia-GAN phase-2 script run it: a D update on weighted reals (reals and fakes
augmented with their own draws); the same update of the twin DRS
discriminator on uniform reals; when t % d_reg_every == 0, the lazy R1
update of each discriminator (weight r1 / 2 * d_reg_every); the G update
through the augmented fake, then the EMA of G; when t % g_reg_every == 0,
the path-length update (batch // path_batch_shrink, weight path_regularize
* g_reg_every), then the EMA again. Adam is the lazy-regularisation Adam
(lr * k / (k + 1), betas 0 ** r and 0.99 ** r). ADA's p is tuned from the
sign of D(real) after each step.

`Follower` replays a list of recorded calls with their draws, so that the
reference sees the latents, noises, rows and augment matrices the program
saw, and computes everything else itself from the seeded weights.
"""
from __future__ import annotations

import copy

import torch

from benchmark.harness import compare
from benchmark.reference import ops
from benchmark.reference.stylegan2 import (
    AdaptiveAugment,
    Discriminator,
    Generator,
    augment,
    d_logistic,
    g_nonsaturating,
    noise_shapes,
    path_length,
    r1_penalty,
)

EMA_DECAY = 0.5 ** (32 / (10 * 1000))


def models(cfg, device):
    """(G, D, twin D) of the configuration on `device` (uninitialised)."""
    ws = cfg.get("width_scale", 1.0)
    g = Generator(cfg["size"], cfg["style_dim"], cfg["n_mlp"], cfg["channel_multiplier"],
                  cfg["lr_mlp"], ws, device=device)
    return (g, Discriminator(cfg["size"], cfg["channel_multiplier"], width_scale=ws, device=device),
            Discriminator(cfg["size"], cfg["channel_multiplier"], width_scale=ws, device=device))


def reg_adam(params, lr, every):
    r = every / (every + 1)
    return torch.optim.Adam(params, lr=lr * r, betas=(0.0 ** r, 0.99 ** r), eps=1e-8)


class Follower:
    """The reference trainer. state: {"g", "d", "drs"} -> state_dict.
    fault="half" plants a fault for the check's own test: every loss takes
    the mean over the first half of its batch only."""

    def __init__(self, cfg, state, p0, device, fault=None):
        self.cfg, self.half = cfg, fault == "half"
        self.g, self.d, self.drs = models(cfg, device)
        for name, m in (("g", self.g), ("d", self.d), ("drs", self.drs)):
            m.load_state_dict(state[name])
        self.g_ema = copy.deepcopy(self.g).requires_grad_(False)
        lr = cfg["lr"]
        self.opt = {"g": reg_adam(self.g.parameters(), lr, cfg["g_reg_every"]),
                    "d": reg_adam(self.d.parameters(), lr, cfg["d_reg_every"]),
                    "drs": reg_adam(self.drs.parameters(), lr, cfg["d_reg_every"])}
        self.nets = {"d": self.d, "drs": self.drs}
        self.first = {}  # each optimizer's first gradient (compare.record_first_step)
        for name, module in (("g", self.g), ("d", self.d), ("drs", self.drs)):
            compare.record_first_step(self.opt[name], module, self.first, name, norms=False)
        self.pl_mean = torch.zeros((), device=device)
        self.ada = AdaptiveAugment(p0, cfg["ada_target"], cfg["ada_length"])
        self.device = device

    def _aug(self, x, aug):
        if aug is None or self.ada.p == 0:
            return x
        return augment(x, *aug, pad_frac=self.cfg["ada_pad_frac"])

    def _h(self, pred):
        return pred[:len(pred) // 2] if self.half else pred

    def _fake(self, fd):
        z1, z2, cutoff, noises = fd
        return self.g.sample([z1, z2], cutoff, noises)

    def _update(self, name, module, loss):
        self.opt[name].zero_grad(set_to_none=True)
        loss.backward()
        self.opt[name].step()

    def d_step(self, net, real, fd, aug_real, aug_fake):
        with torch.no_grad():
            fake = self._fake(fd)
        d = self.nets[net]
        rp = d(self._aug(real, aug_real))
        fp = d(self._aug(fake, aug_fake))
        loss = d_logistic(self._h(rp), self._h(fp))
        self._update(net, d, loss)
        return float(loss.detach()), float(torch.sign(rp.detach()).sum())

    def r1_step(self, net, real, aug):
        d = self.nets[net]
        real = self._aug(real, aug).detach().requires_grad_(True)
        pen = r1_penalty(d(real), real)
        self._update(net, d, self.cfg["r1"] / 2 * pen * self.cfg["d_reg_every"])
        return float(pen.detach())

    def g_step(self, fd, aug):
        self.d.requires_grad_(False)
        loss = g_nonsaturating(self._h(self.d(self._aug(self._fake(fd), aug))))
        self._update("g", self.g, loss)
        self.d.requires_grad_(True)
        self.ema()
        return float(loss.detach())

    def path_step(self, z, noises, path_noise):
        w = self.g.mapping(z)
        styles = w[:, None, :].expand(-1, self.g.n_latent, -1)
        imgs = self.g.synthesis(styles, noises).permute(0, 2, 3, 1)
        pen, new_mean = path_length(imgs, styles, path_noise, self.pl_mean)
        loss = self.cfg["path_regularize"] * self.cfg["g_reg_every"] * pen + 0.0 * imgs[:1].sum()
        self._update("g", self.g, loss)
        self.pl_mean = new_mean.detach()
        self.ema()
        return float(pen.detach())

    @torch.no_grad()
    def ema(self):
        for pe, p in zip(self.g_ema.parameters(), self.g.parameters()):
            pe.mul_(EMA_DECAY).add_(p, alpha=1 - EMA_DECAY)

    def nets_by_name(self):
        return {"g": self.g, "d": self.d, "drs": self.drs, "g_ema": self.g_ema}


def run_call(f, call, rows_to_real):
    """One recorded call on the follower; returns its loss (and the sign sum
    of a main D step)."""
    k = call["kind"]
    if k == "d":
        return f.d_step(call["net"], rows_to_real(call["rows"]), call["fake"], call["aug_real"],
                        call["aug_fake"])
    if k == "r1":
        return f.r1_step(call["net"], rows_to_real(call["rows"]), call["aug"]), None
    if k == "g":
        return f.g_step(call["fake"], call["aug"]), None
    return f.path_step(call["z"], call["noises"], call["path_noise"]), None


def step_kind(t, cfg):
    r1, path = t % cfg["d_reg_every"] == 0, t % cfg["g_reg_every"] == 0
    return "r1+path" if r1 else "path" if path else "plain"


# --- counts ---------------------------------------------------------------------
class _Global:
    """FlopCounterMode's module tracker refuses torch.autograd.grad with
    respect to a leaf (R1's reals): book every count under "Global"."""
    parents = {"Global"}

    def __enter__(self):
        return self

    def __exit__(self, *args):
        return False


def flop_counter():
    """FlopCounterMode that also counts matrix-vector and dot products and
    counts a grouped convolution's backward once per group, not groups times."""
    from torch.utils.flop_counter import FlopCounterMode, conv_flop_count
    aten = torch.ops.aten

    def conv_bwd(grad_out_shape, x_shape, w_shape, bias, stride, padding, dilation, transposed,
                 output_padding, groups, output_mask, out_shape=None, **kw):
        return conv_flop_count(x_shape, w_shape, grad_out_shape, transposed) * (
            bool(output_mask[0]) + bool(output_mask[1]))

    counter = FlopCounterMode(display=False, custom_mapping={
        aten.mv: lambda a, b, *x, out_shape=None, **k: 2 * a[0] * a[1],
        aten.dot: lambda a, b, *x, out_shape=None, **k: 2 * a[0],
        aten.convolution_backward: conv_bwd})
    counter.mod_tracker = _Global()
    return counter


def count_step(cfg, kind, batch):
    """(FLOPs, op calls) of one training step of `kind` at `batch`, on the
    meta device, without ADA (its share is counted per call, `count_augment`)
    and without the optimizer and EMA updates (no matrix products)."""
    dev = torch.device("meta")
    g, d, drs = models(cfg, dev)
    size, sd, n_lat = cfg["size"], cfg["style_dim"], g.n_latent

    def fakes(n):
        z = torch.empty((n, sd), device=dev)
        return g.sample([z, z], n_lat // 2, [torch.empty(s, device=dev)
                                              for s in noise_shapes(size, n)])

    def real(n):
        return torch.empty((n, size, size, 3), device=dev)

    ops.CALLS = calls = []
    counter = flop_counter()
    try:
        with counter:
            for net in (d, drs):
                with torch.no_grad():
                    fake = fakes(batch)
                d_logistic(net(real(batch)), net(fake)).backward()
            if kind == "r1+path":
                for net in (d, drs):
                    x = real(batch).requires_grad_(True)
                    r1_penalty(net(x), x).backward()
            d.requires_grad_(False)
            g_nonsaturating(d(fakes(batch))).backward()
            if kind != "plain":
                m = max(1, batch // cfg["path_batch_shrink"])
                w = g.mapping(torch.empty((m, sd), device=dev))
                styles = w[:, None, :].expand(-1, n_lat, -1)
                imgs = g.synthesis(styles, [torch.empty(s, device=dev)
                                            for s in noise_shapes(size, m)]).permute(0, 2, 3, 1)
                pen, _ = path_length(imgs, styles, torch.empty_like(imgs),
                                     torch.zeros((), device=dev))
                pen.backward()
    finally:
        ops.CALLS = None
    return counter.get_total_flops(), calls


def count_augment(cfg, G, C, backward, touched):
    """Op calls of one augment call with draws (G, C) on the meta device;
    `backward`: the call's gradient is taken (G's step); `touched`: the
    warp's touched-pixel count (stylegan2.warp_touched)."""
    dev = torch.device("meta")
    x = torch.empty((G.shape[0], cfg["size"], cfg["size"], 3), device=dev,
                    requires_grad=backward)
    ops.CALLS = calls = []
    try:
        y = augment(x, G, C, cfg["ada_pad_frac"], touched)
        if backward:
            y.sum().backward()
    finally:
        ops.CALLS = None
    return calls


def count_forward(cfg, batch):
    """(FLOPs, op calls) of one DRS proposal batch: G_ema and the twin D
    forward, on the meta device."""
    dev = torch.device("meta")
    g, d, _ = models(cfg, dev)
    ops.CALLS = calls = []
    counter = flop_counter()
    try:
        with counter, torch.no_grad():
            z = torch.empty((batch, cfg["style_dim"]), device=dev)
            d(g.sample([z], g.n_latent, [torch.empty(s, device=dev)
                                         for s in noise_shapes(cfg["size"], batch)]))
    finally:
        ops.CALLS = None
    return counter.get_total_flops(), calls
