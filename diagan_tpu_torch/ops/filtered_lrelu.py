"""filtered_lrelu: StyleGAN3's alias-free activation (Karras et al. 2021,
NVlabs stylegan3 torch_utils/ops/filtered_lrelu.py `_filtered_lrelu_ref`) on
NCHW tensors, composed of kernel A (ops/upfirdn2d.py) and the bias-act
kernel (ops/fused_act.py):

    u   = upfirdn2d(x, fu x fu, up, padding) * up^2     upsample
    a   = clamp(sqrt(2) * leaky_relu(u, 0.2), -clamp, clamp)
    out = upfirdn2d(a, fd x fd, down=down)              downsample

The filters are 1-D and separable, as StyleGAN3-T designs them (a 2-D
filter is their outer product): each upfirdn2d is an x pass with taps
(1, K) and then a y pass with taps (K, 1), the up pass's taps times `up`
(its gain of up^2 split over the two axes). With 12-tap filters at up and
down 2 the passes are kernel A's fir12x_up2, fir12y_up2, fir12x_down2 and
fir12y_down2 instances; the 24-tap passes at up 4 take its generic
instance. The filters are symmetric, so the flip of the correlation does not
matter. Negative pads crop.

With autograd off the activation is one `flr_fwd` pass with its CLAMP flag
(`clamped_leaky_relu`); under autograd it is `fused_leaky_relu` over a zero
bias and then torch.clamp, and the backward is kernel A's and the bias-act's
own. Each call is a device-timed span `g.filtered_lrelu` and counts
`filtered_lrelu`, and `filtered_lrelu_fused` when its activation ran as the
one CLAMP pass (utils/trace.py).
"""
from __future__ import annotations

import torch

from diagan_tpu_torch.ops.fused_act import clamped_leaky_relu, fused_leaky_relu
from diagan_tpu_torch.ops.upfirdn2d import upfirdn2d
from diagan_tpu_torch.utils import trace


def _separable(x, taps, up, down, padding):
    """upfirdn2d of x with the 2-D filter outer(taps, taps): the x pass, then
    the y pass. padding (x0, x1, y0, y1)."""
    px0, px1, py0, py1 = padding
    x = upfirdn2d(x, taps.reshape(1, -1), up=(up, 1), down=(down, 1), pad=(px0, px1, 0, 0))
    return upfirdn2d(x, taps.reshape(-1, 1), up=(1, up), down=(1, down), pad=(0, 0, py0, py1))


def filtered_lrelu(x, fu, fd, up, down, padding, clamp):
    """x (N, C, H, W) float32, its bias already added (NVlabs' `b`: the
    StyleGAN3 layer adds it with the demodulation); fu, fd 1-D float32 taps
    on x's device; padding (x0, x1, y0, y1) of the up pass; clamp the bound
    (NVlabs' gain sqrt(2) and slope 0.2, those of every layer but ToRGB,
    which has no filters).
    Returns (N, C, H', W') with, per axis, n' = ((n * up + p0 + p1 - len(fu)
    + 1) - len(fd)) // down + 1."""
    trace.count("filtered_lrelu")
    with trace.span("g.filtered_lrelu", x.device):
        u = _separable(x, fu * up, up, 1, padding)
        if torch.is_grad_enabled():
            a = torch.clamp(fused_leaky_relu(u, u.new_zeros(u.shape[1])), -clamp, clamp)
        else:
            trace.count("filtered_lrelu_fused")
            a = clamped_leaky_relu(u, clamp)
        del u  # the upsampled map (20.7 GB at L10, batch 64) goes before the down passes
        return _separable(a, fd, 1, down, (0, 0, 0, 0))

