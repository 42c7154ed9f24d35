"""The numbers that decide `correct` for a training cell, from the program's
and the reference's readings (see PERF.md for how each limit was set).

  loss    the widest relative gap of a loss that a step reported,
          |program - reference| / max(|reference|, LOSS_FLOOR);
  grad    the first gradient each discriminator's optimizer took (Adam's
          first moment right after its first step; beta1 = 0 makes it that
          gradient): the widest gap between the program's and the
          reference's norm of one leaf, over the larger of the reference
          leaf's norm and the median leaf's. G's first gradient is left out
          of it (GRAD_NETS): it is taken through D after D's first Adam
          updates, which move every weight by about +-lr whatever its
          gradient's size, so the sign of a gradient that is nought but for
          rounding decides 2 lr; G is held by the loss and change numbers;
  change  the same gap for the norm of each leaf's change over the followed
          steps.

Leaves whose reference gradient is below a thousandth of the median leaf's
(nought but for rounding, such as a bias that R1 does not reach) are left
out of both, by that rule and not by name.
"""
from __future__ import annotations

import math

import torch

NOUGHT = 1e-3
GRAD_NETS = ("d", "drs")
LOSS_FLOOR = 0.1  # losses are O(1); a hinge loss can be nought exactly


def leaf_norms(tensors):
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def median(values):
    v = sorted(values)
    return v[len(v) // 2] if v else 0.0


def kept_leaves(ref_grad_norms):
    med = median(ref_grad_norms.values())
    return {k for k, v in ref_grad_norms.items() if v >= NOUGHT * med}


def norm_gap(prog, ref, keep):
    """The widest |prog - ref| / max(ref, median of ref) over the leaves in
    `keep`, and that leaf's name."""
    keys = [k for k in ref if k in keep]
    med = median(ref[k] for k in keys)
    worst, leaf = 0.0, None
    for k in keys:
        gap = abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30)
        if not math.isfinite(gap):
            return math.inf, k
        if gap > worst or leaf is None:
            worst, leaf = gap, k
    return worst, leaf


def loss_gap(pairs):
    """pairs: [(name, program, reference)] -> (widest gap, its name)."""
    worst, name = 0.0, None
    for n, p, r in pairs:
        gap = abs(p - r) / max(abs(r), LOSS_FLOOR)
        if not math.isfinite(gap):
            return math.inf, n
        if gap > worst or name is None:
            worst, name = gap, n
    return worst, name


def record_first_step(optimizer, module, out, key, norms=True):
    """Keep in out[key], once, the gradient that `optimizer` took in its first
    step, from its state right after it (Adam's first moment: beta1 = 0
    makes it that gradient), by leaf name: norms, or the tensors. Returns
    the hook's handle (remove it when done)."""
    names = {p: n for n, p in module.named_parameters()}

    def hook(opt, args, kwargs):
        if key not in out:
            g = {names[p]: opt.state[p]["exp_avg"] for p in names if p in opt.state}
            out[key] = leaf_norms(g) if norms else {k: v.clone() for k, v in g.items()}

    return optimizer.register_step_post_hook(hook)


def detail(prog, ref, keep):
    """{net: 'worst gap (leaf), median leaf's gap'}, for the log."""
    out = {}
    for k in ref:
        gaps = sorted(abs(prog.get(k, {}).get(n, 0.0) - v) / max(v, median(ref[k][m] for m in ref[k]
                                                                if m in keep[k]), 1e-30)
                      for n, v in ref[k].items() if n in keep[k])
        worst = norm_gap(prog.get(k, {}), ref[k], keep[k])
        out[k] = f"{worst[0]:.3e} ({worst[1]}), median {median(gaps):.3e}"
    return out
