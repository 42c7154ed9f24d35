"""The port's upfirdn2d against the JAX package's NHWC FIR routes.

diagan_tpu/ops/fir_pallas.py sends a stride-1 call on NHWC input to
`_fir2d_nhwc` (#2) when C is a multiple of 128 and to `_fir2d_pair` (#3)
when C is 64 and the taps are separable; test_torch_port_ops.py reaches
neither (its inputs have C = 3). Here the port's CPU path is held against
both routes, run in interpret mode as the JAX package's own tests run them,
at 16 px and one image: the G upsample blur's 4x4 taps with its pad (1, 1),
the pad (2, 2) of its backward, and taps that are not symmetric; the port's
input in NCHW and channels-last; fp32 within 1e-5 and bf16 within twice
bf16's own shift (the JAX bf16 output against the JAX fp32 one); and the
gradient of each route in fp32 against torch autograd.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diagan_tpu.ops import fir_pallas  # noqa: E402
from diagan_tpu.ops.fir_pallas import upfirdn2d_pallas  # noqa: E402
from diagan_tpu.ops.upfirdn2d import make_resample_kernel  # noqa: E402
from diagan_tpu_torch import ops as tops  # noqa: E402

_BLUR = make_resample_kernel([1, 3, 3, 1]) * 4  # the G upsample blur (up 2 folded in)
_ASYM = np.random.default_rng(21).standard_normal((4, 4)).astype(np.float32)
_SEP = np.outer([1.0, 2.0, 0.5, -1.0], [0.5, 1.5, 1.0, 0.25]).astype(np.float32)

# (C, taps, pad, the route fir_pallas takes)
CASES = [
    (128, _BLUR, (1, 1), "_fir2d_nhwc"),
    (128, _BLUR, (2, 2), "_fir2d_nhwc"),
    (128, _ASYM, (2, 1), "_fir2d_nhwc"),
    (64, _BLUR, (1, 1), "_fir2d_pair"),
    (64, _SEP, (2, 2), "_fir2d_pair"),
]


@pytest.fixture
def routes(monkeypatch):
    """The names of the Pallas FIR functions each JAX call reached."""
    seen = []
    for name in ("_fir2d", "_fir2d_nhwc", "_fir2d_pair"):
        fn = getattr(fir_pallas, name)

        def spy(*a, _fn=fn, _name=name, **k):
            seen.append(_name)
            return _fn(*a, **k)

        monkeypatch.setattr(fir_pallas, name, spy)
    return seen


def _port(x_nhwc, taps, pad, dtype, channels_last):
    x = torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last if channels_last else torch.contiguous_format)
    return tops.upfirdn2d(x, taps, 1, 1, pad).float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "channels_last"])
@pytest.mark.parametrize("c,taps,pad,route", CASES,
                         ids=[f"c{c}-{r}-pad{p}-{i}" for i, (c, _, p, r) in enumerate(CASES)])
def test_port_matches_the_nhwc_routes(routes, c, taps, pad, route, channels_last):
    x = np.random.default_rng(c + len(pad)).standard_normal((1, 16, 16, c)).astype(np.float32)
    want = np.asarray(upfirdn2d_pallas(jnp.asarray(x), taps, pad=pad, interpret=True))
    want16 = np.asarray(upfirdn2d_pallas(jnp.asarray(x, jnp.bfloat16), taps, pad=pad,
                                         interpret=True).astype(jnp.float32))
    assert routes == [route, route], routes
    got = _port(x, taps, pad, torch.float32, channels_last)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    shift = np.abs(want16 - want).max()
    assert shift > 0
    got16 = _port(x, taps, pad, torch.bfloat16, channels_last)
    assert np.abs(got16 - want16).max() <= 2 * shift


@pytest.mark.parametrize("c,taps,pad,route", [CASES[0], CASES[3]], ids=["nhwc", "pair"])
def test_port_gradient_matches_the_nhwc_routes(routes, c, taps, pad, route):
    """The backward (flipped taps, pad (2, 2)) takes the same route."""
    rng = np.random.default_rng(c)
    x = rng.standard_normal((1, 16, 16, c)).astype(np.float32)
    g = rng.standard_normal((1, 15, 15, c)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: upfirdn2d_pallas(a, taps, pad=pad, interpret=True),
                     jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    assert routes == [route, route], routes
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    xt.requires_grad_(True)
    y = tops.upfirdn2d(xt, taps, 1, 1, pad)
    (got,) = torch.autograd.grad(y, xt, torch.from_numpy(g).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-5, atol=1e-5)
