"""The benchmark's FLOP and byte counts on the meta device against closed
forms at small sizes."""
import math

import numpy as np
import pytest
import torch

from benchmark.harness import counts
from benchmark.reference import ops, sg2_train
from benchmark.reference.stylegan2 import Discriminator, augment, noise_shapes

TINY = {"size": 16, "style_dim": 32, "n_mlp": 2, "channel_multiplier": 2, "lr_mlp": 0.01,
        "width_scale": 1 / 32, "path_batch_shrink": 2, "ada_pad_frac": 0.75}


def _logged(fn):
    ops.CALLS = calls = []
    try:
        fn()
    finally:
        ops.CALLS = None
    return calls


@pytest.mark.parametrize("up,down,pad", [(1, 1, (2, 1)), (2, 1, (2, 1)), (1, 2, (1, 1))])
def test_fir_bytes_and_flops(up, down, pad):
    x = torch.empty((2, 3, 10, 10), device="meta")
    calls = _logged(lambda: ops.upfirdn2d(x, np.ones((4, 4), np.float32), up, down, pad))
    out = (10 * up + sum(pad) - 4) // down + 1
    assert calls == [("fir", 4 * 2 * 3 * (100 + out * out), 2 * 2 * 3 * out * out * 16 // up // up)]


def test_fir_backward_and_double_backward_are_logged():
    x = torch.empty((2, 3, 10, 10), device="meta", requires_grad=True)

    def run():
        y = ops.upfirdn2d(x, np.ones((4, 4), np.float32), 1, 2, (1, 1))
        (g,) = torch.autograd.grad((y * y).sum(), x, create_graph=True)
        g.sum().backward()

    calls = _logged(run)
    # forward; its gradient; the gradient's gradient and the forward's again
    assert [c[0] for c in calls] == ["fir"] * 4
    assert all(c[1] == calls[0][1] for c in calls)


def test_act_bytes_forward_backward():
    x = torch.empty((4, 5, 6, 6), device="meta", requires_grad=True)
    b = torch.empty(5, device="meta", requires_grad=True)
    calls = _logged(lambda: ops.fused_act(x, b).sum().backward())
    n = 4 * 5 * 36 * 4
    assert calls == [("act", 2 * n + 20, 0), ("act", 3 * n + 20, 0)]


def test_identity_warp_touches_one_pixel_per_output():
    win, s2 = 8, 8
    coef = torch.tensor([[1.0, 0.0, 0.0, 0.0, 1.0, 0.0]] * 3)
    # the bilinear taps of integer points include the next row and column
    assert ops.touched_pixels(coef, win, s2) == 3 * s2 * s2
    coef = torch.tensor([[0.0, 0.0, 3.0, 0.0, 0.0, 5.0]])  # every output reads one point
    assert ops.touched_pixels(coef, win, s2) == 4


def test_conv_flops_of_the_discriminator_head():
    counter = sg2_train.flop_counter()
    d = Discriminator(16, 2, width_scale=1 / 32, device="meta")
    with counter, torch.no_grad():
        d(torch.empty((4, 16, 16, 3), device="meta"))
    ch = 16  # channels(16) * width_scale, floor 8
    from_rgb = 2 * 4 * 16 * 16 * ch * 3
    final_linear = 2 * 4 * ch * 16 * ch
    assert counter.get_total_flops() > from_rgb + final_linear
    assert counter.get_flop_counts()["Global"][torch.ops.aten.mm] == \
        final_linear + 2 * 4 * ch * 1


def test_augment_calls_are_four_fir_passes_and_a_warp():
    G = torch.eye(3).repeat(2, 1, 1)
    C = torch.eye(4).repeat(2, 1, 1)
    calls = sg2_train.count_augment(TINY, G, C, backward=True, touched=0)
    assert [c[0] for c in calls].count("fir") == 8
    ops_ = [c[0] for c in calls]
    assert ops_.count("gather") == 1 and ops_.count("scatter") == 1


def test_roofline_share_counts_only_families_that_ran():
    class Trace:
        def device_time(self, pattern):
            return 2e-3 if "fir_" in pattern else 0.0

    facts = {"trace": Trace()}
    calls = [("fir", 3.35e9, 0), ("act", 3.35e9, 0)]
    assert math.isclose(counts.ops_roofline_pct(facts, calls), 50.0)
    facts["trace"].device_time = lambda p: 0.0
    assert counts.ops_roofline_pct(facts, calls) is None


def test_step_counts_add_the_path_and_r1_work():
    cfg = dict(TINY, batch=4)
    plain = sg2_train.count_step(cfg, "plain", 4)[0]
    path = sg2_train.count_step(cfg, "path", 4)[0]
    r1 = sg2_train.count_step(cfg, "r1+path", 4)[0]
    assert plain < path < r1
    assert len(noise_shapes(16, 2)) == 5
