"""Port ops (diagan_tpu_torch.ops) against the JAX package's kernels.

The CPU path of each port op is its plain-torch version; here it is held
against the Pallas kernel it stands beside on the card, run in interpret
mode, and against the JAX package's naive oracle. Inputs come from numpy
with a fixed seed; layouts are converted NHWC <-> NCHW at the boundary.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from diagan_tpu.ops import fused_act  # noqa: E402
from diagan_tpu.ops.fir_pallas import upfirdn2d_pallas  # noqa: E402
from diagan_tpu.ops.upfirdn2d import make_resample_kernel, upfirdn2d_ref  # noqa: E402
from diagan_tpu_torch import ops as tops  # noqa: E402
from diagan_tpu_torch.ops import _build  # noqa: E402

_ASYM = np.random.default_rng(11).standard_normal((3, 4)).astype(np.float32)
_ROW5 = np.random.default_rng(12).standard_normal((1, 5)).astype(np.float32)
_K12 = np.random.default_rng(13).standard_normal(12).astype(np.float32)
_K6 = np.random.default_rng(14).standard_normal(6).astype(np.float32)
_K66 = np.random.default_rng(15).standard_normal((6, 6)).astype(np.float32)
_K44 = np.random.default_rng(16).standard_normal((4, 4)).astype(np.float32)
_K24 = np.random.default_rng(17).standard_normal(24).astype(np.float32)

# (up, down, pad, taps): the tests/test_ops.py configs (1-D tap lists), then
# kernels that are not symmetric, so a missing flip of the taps cannot pass:
# a rank-2 (3, 4) kernel and a 1-D (1, k) row with up=(2, 1), as ADA calls it
CONFIGS = [
    (1, 1, (1, 1), [1, 3, 3, 1]),
    (1, 1, (1, 1), [1, 2, 1]),
    (1, 1, (2, 1), [1, 3, 3, 1]),
    (2, 1, (2, 1), [1, 3, 3, 1]),
    (1, 2, (1, 1), [1, 3, 3, 1]),
    (2, 1, (1, 0), [1, 2, 1]),
    (1, 2, (0, 0), [1, 1]),
    (1, 1, (-1, 2), [1, 3, 3, 1]),
    (3, 2, (2, 2), [1, 3, 3, 1]),
    (1, 1, (1, 2, 0, 1), _ASYM),
    (2, 2, (2, 1), _ASYM),
    ((2, 1), 1, (2, 1, 0, 0), _ROW5),
    ((2, 1), (1, 2), (3, 1, 1, 0), _ROW5.T),
]
# the shape families of the kernel's own instances (ops/upfirdn2d.py
# fir_instance) that CONFIGS leaves out, with taps that are not symmetric:
# ADA's 12-tap passes at up 2 and down 2 on each axis, the polyphase 6-tap y
# and 6x6 stride-1 passes, the 4x4 up 2 / down 2 pair at other pads, and
# StyleGAN3-T's 24-tap up-4 x and y passes with its crop -6 in front
FAMILY_CONFIGS = [
    ((1, 2), 1, (0, 0, 6, 5), _K12.reshape(12, 1)),
    (1, (1, 2), (0, 0, 5, 5), _K12.reshape(12, 1)),
    ((2, 1), 1, (6, 5, 0, 0), _K12.reshape(1, 12)),
    (1, (2, 1), (5, 5, 0, 0), _K12.reshape(1, 12)),
    (1, 1, (0, 0, 3, 2), _K6.reshape(6, 1)),
    (1, 1, (3, 2, 2, 3), _K66),
    (2, 1, (1, 2), _K44),
    (1, 2, (2, 1), _K44),
    ((4, 1), 1, (-6, 3, 0, 0), _K24.reshape(1, 24)),
    ((1, 4), 1, (0, 0, -6, -9), _K24.reshape(24, 1)),
]


def _taps(k):
    return k if isinstance(k, np.ndarray) else make_resample_kernel(k)


@pytest.mark.parametrize("up,down,pad,k", CONFIGS + FAMILY_CONFIGS)
def test_upfirdn2d_plain_matches_pallas_and_oracle(up, down, pad, k):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 12, 9, 3)).astype(np.float32)
    taps = _taps(k)
    got = tops.upfirdn2d(torch.from_numpy(x).permute(0, 3, 1, 2), taps, up, down, pad)
    got = got.permute(0, 2, 3, 1).numpy()
    want = np.asarray(upfirdn2d_ref(x, taps, up=up, down=down, pad=pad))
    pallas = np.asarray(upfirdn2d_pallas(jnp.asarray(x), taps, up=up, down=down,
                                         pad=pad, interpret=True))
    assert got.shape == want.shape == pallas.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


def test_upfirdn2d_channels_last_and_bf16_on_cpu():
    """The plain version takes channels-last input and bf16 (fp32 math)."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((2, 5, 8, 8)).astype(np.float32))
    k = make_resample_kernel([1, 3, 3, 1])
    want = tops.upfirdn2d(x, k, up=2, pad=(2, 1))
    got = tops.upfirdn2d(x.contiguous(memory_format=torch.channels_last), k, up=2, pad=(2, 1))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    got16 = tops.upfirdn2d(x.bfloat16(), k, up=2, pad=(2, 1))
    assert got16.dtype == torch.bfloat16
    torch.testing.assert_close(got16.float(), want, rtol=1e-2, atol=2e-2)


def test_make_resample_kernel_matches_jax():
    for k in ([1, 3, 3, 1], [1, 2, 1], [[1, 2], [3, 4]]):
        np.testing.assert_array_equal(tops.make_resample_kernel(k), make_resample_kernel(k))


@pytest.mark.parametrize("bad", [dict(pad=(1, 2, 3)), dict(up=0), dict(kernel=np.ones(4))])
def test_upfirdn2d_rejects_bad_arguments(bad):
    args = dict(kernel=make_resample_kernel([1, 3, 3, 1]), up=1, down=1, pad=(1, 1))
    args.update(bad)
    with pytest.raises(ValueError):
        tops.upfirdn2d(torch.zeros(1, 1, 8, 8), **args)


def _pallas_flr(x_nhwc, b):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fused_act._pallas_forward(jnp.asarray(x_nhwc), jnp.asarray(b),
                                                    0.2, math.sqrt(2.0)))


@pytest.mark.parametrize("shape", [(2, 8, 4, 4), (3, 16, 5, 7), (4, 32)])
def test_fused_leaky_relu_plain_matches_pallas(shape):
    rng = np.random.default_rng(4)
    x = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal((shape[1],)).astype(np.float32)
    got = tops.fused_leaky_relu(torch.from_numpy(x), torch.from_numpy(b)).numpy()
    if x.ndim == 4:  # the JAX op takes the channel last
        want = _pallas_flr(x.transpose(0, 2, 3, 1), b).transpose(0, 3, 1, 2)
    else:
        want = _pallas_flr(x, b)
    assert fused_act.USE_PALLAS is False
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_cpu_tensors_take_the_plain_versions():
    """CPU tensors never reach a kernel: the launch counts stay 0 and the
    results equal the plain versions."""
    _build.reset_launches()
    x = torch.randn(2, 4, 6, 6)
    b = torch.randn(4)
    k = make_resample_kernel([1, 3, 3, 1])
    torch.testing.assert_close(tops.upfirdn2d(x, k, pad=(1, 1)),
                               tops.upfirdn2d_plain(x, k, pad=(1, 1)), rtol=0, atol=0)
    torch.testing.assert_close(tops.fused_leaky_relu(x, b),
                               tops.fused_leaky_relu_plain(x, b), rtol=0, atol=0)
    assert {"upfirdn2d", "fused_leaky_relu"} <= set(_build.LAUNCHES)
    assert all(v == 0 for v in _build.LAUNCHES.values()), _build.LAUNCHES
