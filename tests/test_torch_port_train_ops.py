"""The training path's kernels (their CPU paths) against the JAX package.

On the CPU each port op runs its plain-torch version through the same
autograd Functions the card uses. Here they are held against the Pallas
kernels they replace, run in interpret mode, and against JAX autodiff:

  - the fused-act backward (dx, db) against `fused_act._pallas_backward` plus
    the JAX db sum, and its double backward against jax.grad through
    `fused_leaky_relu`, at 1e-6;
  - upfirdn2d gradients and the gradient of a gradient norm against
    jax.grad through `upfirdn2d_pallas(..., interpret=True)`, on the configs
    and the kernel's shape families of test_torch_port_ops.py, at 1e-5;
  - the affine warp and its adjoint against `affine_gather` (Pallas in
    interpret mode on three cases, XLA on all six), at the tolerances of
    tests/test_warp_pallas.py.

Inputs come from numpy with fixed seeds; layouts go NHWC <-> NCHW at the
boundary.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402
from test_torch_port_ops import CONFIGS, FAMILY_CONFIGS, _taps  # noqa: E402

from diagan_tpu.ops import fused_act  # noqa: E402
from diagan_tpu.ops.fir_pallas import upfirdn2d_pallas  # noqa: E402
from diagan_tpu.ops.warp_pallas import affine_gather as jax_affine_gather  # noqa: E402
from diagan_tpu_torch import ops as tops  # noqa: E402
from diagan_tpu_torch.ops import _build  # noqa: E402

SLOPE, SCALE = 0.2, math.sqrt(2.0)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy() if t.ndim == 4 else t.numpy()


def _nchw(a):
    return a.transpose(0, 3, 1, 2) if a.ndim == 4 else a


# --- fused bias-LeakyReLU backward ------------------------------------------
@pytest.mark.parametrize("shape", [(2, 8, 4, 4), (3, 16, 5, 7), (4, 32)])
def test_fused_act_backward_matches_pallas(shape):
    rng = np.random.default_rng(5)
    g = rng.standard_normal(shape).astype(np.float32)
    y = rng.standard_normal(shape).astype(np.float32)
    dx, db = tops.fused_leaky_relu_backward(torch.from_numpy(g), torch.from_numpy(y))
    g_j, y_j = (jnp.asarray(a.transpose(0, 2, 3, 1) if a.ndim == 4 else a) for a in (g, y))
    with pltpu.force_tpu_interpret_mode():
        want = fused_act._pallas_backward(g_j, y_j, SLOPE, SCALE)
    want_db = jnp.sum(want, axis=tuple(range(want.ndim - 1)))  # as _flr_bwd sums it
    np.testing.assert_allclose(_nhwc(dx), np.asarray(want), rtol=1e-6, atol=1e-6)
    # db sums the same dx in another order: 1e-6 of the sum of |dx| per channel
    mag = np.abs(np.asarray(want)).sum(axis=tuple(range(want.ndim - 1)))
    assert np.all(np.abs(db.numpy() - np.asarray(want_db)) <= 1e-6 * mag)


@pytest.mark.parametrize("shape", [(2, 8, 4, 4), (4, 32)])
def test_fused_act_double_backward_matches_jax(shape):
    """d/du of <dx, a> + <db, cb>, where (dx, db) are the grads of
    <flr(x, b), u>: the mask applied to a + cb (broadcast) times the scale.
    Leaving out the db term would still pass a first-order test."""
    rng = np.random.default_rng(6)
    x, u, a = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    b, cb = (rng.standard_normal(shape[1]).astype(np.float32) for _ in range(2))

    def jax_second(u_):
        def inner(x_, b_):
            return jnp.sum(fused_act.fused_leaky_relu(x_, b_) * u_)

        gx, gb = jax.grad(inner, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(b))
        return jnp.sum(gx * a) + jnp.sum(gb * cb)

    def nhwc(v):
        return v.transpose(0, 2, 3, 1) if v.ndim == 4 else v

    x, u, a = nhwc(x), nhwc(u), nhwc(a)
    want = np.asarray(jax.grad(jax_second)(jnp.asarray(u)))

    xt, ut = (torch.from_numpy(_nchw(v).copy()).requires_grad_(True) for v in (x, u))
    bt = torch.from_numpy(b).requires_grad_(True)
    dx, db = torch.autograd.grad((tops.fused_leaky_relu(xt, bt) * ut).sum(), (xt, bt),
                                 create_graph=True)
    loss = (dx * torch.from_numpy(_nchw(a).copy())).sum() + (db * torch.from_numpy(cb)).sum()
    got, gx2 = torch.autograd.grad(loss, (ut, xt), allow_unused=True)
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-6, atol=1e-6)
    # the mask is a step in the saved output: x gets no second-order gradient
    assert gx2 is None or not gx2.any()


def test_fused_act_backward_extra_term_and_no_sums():
    """The double backward's entry: `extra` is added per channel before the
    mask, and sums=False skips db."""
    rng = np.random.default_rng(7)
    g, y = (torch.from_numpy(rng.standard_normal((2, 3, 4, 5)).astype(np.float32))
            for _ in range(2))
    e = torch.from_numpy(rng.standard_normal(3).astype(np.float32))
    dx, db = tops.fused_leaky_relu_backward(g, y, extra=e, sums=False)
    want, _ = tops.fused_leaky_relu_backward(g + e[None, :, None, None], y)
    assert db is None
    torch.testing.assert_close(dx, want, rtol=0, atol=0)


# --- upfirdn2d backward -----------------------------------------------------
@pytest.mark.parametrize("up,down,pad,k", CONFIGS + FAMILY_CONFIGS)
def test_upfirdn2d_grads_match_pallas(up, down, pad, k):
    """The gradient of <up(x), w> and the gradient of the squared norm of the
    gradient of <tanh(up(x)), w>: the second runs the backward's backward."""
    rng = np.random.default_rng(9)
    taps = _taps(k)
    x = rng.standard_normal((2, 12, 9, 3)).astype(np.float32)
    y_shape = np.asarray(upfirdn2d_pallas(jnp.asarray(x), taps, up=up, down=down, pad=pad,
                                          interpret=True)).shape
    w = rng.standard_normal(y_shape).astype(np.float32)

    def f_jax(x_):
        return upfirdn2d_pallas(x_, taps, up=up, down=down, pad=pad, interpret=True)

    def grad_norm_jax(x_):
        g = jax.grad(lambda z: jnp.sum(jnp.tanh(f_jax(z)) * w))(x_)
        return jnp.sum(g**2)

    want_g = np.asarray(jax.jit(jax.grad(lambda z: jnp.sum(f_jax(z) * w)))(jnp.asarray(x)))
    want_gg = np.asarray(jax.jit(jax.grad(grad_norm_jax))(jnp.asarray(x)))

    xt = torch.from_numpy(_nchw(x).copy()).requires_grad_(True)
    wt = torch.from_numpy(_nchw(w).copy())
    (g,) = torch.autograd.grad((tops.upfirdn2d(xt, taps, up, down, pad) * wt).sum(), xt)
    (gt,) = torch.autograd.grad((torch.tanh(tops.upfirdn2d(xt, taps, up, down, pad)) * wt).sum(),
                                xt, create_graph=True)
    (gg,) = torch.autograd.grad((gt**2).sum(), xt)
    np.testing.assert_allclose(_nhwc(g), want_g, rtol=1e-5, atol=1e-5)
    # the second derivative sums tanh'' terms in another order: 1e-5 of the
    # largest element
    np.testing.assert_allclose(_nhwc(gg), want_gg, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(want_gg).max()))


def test_upfirdn2d_backward_is_counted_apart():
    """On the CPU nothing launches; the backward's own counter exists so a
    card run can show that backward passes ran kernel A."""
    _build.reset_launches()
    x = torch.randn(1, 2, 8, 8, requires_grad=True)
    tops.upfirdn2d(x, tops.make_resample_kernel([1, 3, 3, 1]), up=2, pad=(2, 1)).sum().backward()
    assert x.grad.shape == x.shape
    assert _build.LAUNCHES["upfirdn2d_backward"] == 0 == _build.LAUNCHES["upfirdn2d"]


# --- ADA's affine warp and its adjoint ---------------------------------------
_TH = 0.6
WARP_CASES = {  # tests/test_warp_pallas.py; rows [ay, by, cy, ax, bx, cx]
    "identity": [1.0, 0.0, 30.0, 0.0, 1.0, 30.0],
    "rot_scale": [1.3 * np.cos(_TH), -1.3 * np.sin(_TH), 30.0,
                  1.3 * np.sin(_TH), 1.3 * np.cos(_TH), 20.0],
    "flip": [1.0, 0.0, 30.0, 0.0, -1.0, 90.0],
    "shrink": [0.4, 0.02, 40.0, -0.02, 0.4, 40.0],
    "clipped": [0.8, 0.1, -3.0, -0.2, 1.1, 120.0],
    "fractional": [1.01, -0.3, 17.25, 0.3, 0.97, 33.75],
}


def _warp_pair(x2, coef, win, w):
    """Port (out, d<out, w>/dx2) in NHWC."""
    xt = torch.from_numpy(_nchw(x2).copy()).requires_grad_(True)
    out = tops.affine_gather(xt, torch.from_numpy(coef), win)
    (g,) = torch.autograd.grad((out * torch.from_numpy(_nchw(w).copy())).sum(), xt)
    return _nhwc(out.detach()), _nhwc(g)


def _jax_pair(x2, coef, win, w, backend):
    def loss(x):
        out = jax_affine_gather(x, jnp.asarray(coef), win, backend=backend,
                                interpret=backend == "pallas")
        return jnp.sum(out * w), out

    (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(jnp.asarray(x2))
    return np.asarray(out), np.asarray(g)


def _assert_warp(got, want, case):
    """tests/test_warp_pallas.py's tolerances. The JAX lowerings may contract
    the coordinates into FMAs, which moves the hat weights by ~1 ulp of a
    coordinate of size ~s2; the adjoint sums hundreds of edge terms in
    another order in the clipped case."""
    np.testing.assert_allclose(got[0], want[0], rtol=5e-3, atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4,
                               atol=2e-4 if case == "clipped" else 2e-5)


def _warp_inputs(n, s2, c, win, seed=7):
    rng = np.random.default_rng(seed)
    x2 = rng.normal(size=(n, s2, s2, c)).astype(np.float32)
    w = rng.normal(size=(n, win, win, c)).astype(np.float32)
    return x2, w


@pytest.mark.parametrize("case", ["rot_scale", "clipped", "fractional"])
def test_warp_matches_pallas(case):
    n, s2, c, win = 2, 128, 3, 44
    x2, w = _warp_inputs(n, s2, c, win)
    coef = np.stack([WARP_CASES[case]] * n).astype(np.float32)
    _assert_warp(_warp_pair(x2, coef, win, w), _jax_pair(x2, coef, win, w, "pallas"), case)


@pytest.mark.parametrize("case", sorted(WARP_CASES))
def test_warp_matches_xla(case):
    n, s2, c, win = 2, 128, 3, 44
    x2, w = _warp_inputs(n, s2, c, win, seed=8)
    coef = np.stack([WARP_CASES[case]] * n).astype(np.float32)
    _assert_warp(_warp_pair(x2, coef, win, w), _jax_pair(x2, coef, win, w, "xla"), case)


def test_warp_per_image_matrices_and_single_channel():
    n, s2, c, win = 3, 128, 1, 32
    x2, w = _warp_inputs(n, s2, c, win, seed=3)
    coef = np.stack([WARP_CASES[k] for k in ("identity", "rot_scale", "shrink")]).astype(np.float32)
    out, g = _warp_pair(x2, coef, win, w)
    _assert_warp((out, g), _jax_pair(x2, coef, win, w, "xla"), "per_image")
    # each image used its own row: the identity image is a plain crop
    np.testing.assert_array_equal(out[0], x2[0, 30:30 + win, 30:30 + win])


def test_warp_adjoint_identity_and_first_order_only():
    """<gather(x), g> == <x, scatter(g)>, and the warp has no second
    derivative (R1 differentiates after the augment)."""
    rng = np.random.default_rng(4)
    coef = torch.tensor([WARP_CASES["rot_scale"]] * 2, dtype=torch.float32)
    x2 = torch.from_numpy(rng.normal(size=(2, 3, 64, 64)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, 3, 20, 20)).astype(np.float32))
    lhs = (tops.affine_gather(x2, coef, 20) * g).sum()
    rhs = (x2 * tops.affine_scatter(g, coef, 64)).sum()
    torch.testing.assert_close(lhs, rhs, rtol=1e-5, atol=1e-4)
    xr = x2.clone().requires_grad_(True)
    (d,) = torch.autograd.grad((tops.affine_gather(xr, coef, 20) ** 2).sum(), xr,
                               create_graph=True)
    with pytest.raises(RuntimeError):
        d.sum().backward()
