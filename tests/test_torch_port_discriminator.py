"""Port StyleGAN2 discriminator against the JAX module.

The same Flax params go to both sides, the port's through the weight bridge
(diagan_tpu_torch.utils.jax_params), and the same numpy images. Small
models: size 16/32, width_scale 1/16. Tolerance atol 3e-4, rtol 1e-3, as the
existing torch-import parity tests use for the StyleGAN2 discriminator.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diagan_tpu.models import stylegan2 as J  # noqa: E402
from diagan_tpu_torch.models import stylegan2 as T  # noqa: E402
from diagan_tpu_torch.utils import jax_params  # noqa: E402

WIDTH = 1 / 16
ATOL, RTOL = 3e-4, 1e-3


def _randomize_biases(params, seed):
    """Give the zero-initialised biases random values so each one matters."""
    rng = np.random.default_rng(seed)

    def fix(path, leaf):
        leaf = np.asarray(leaf)
        if path[-1].key == "bias":
            return (0.2 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(fix, jax.device_get(params))


@functools.cache
def _jax_discriminator(size, seed=0):
    disc = J.StyleGAN2Discriminator(size=size, width_scale=WIDTH)
    v = disc.init({"params": jax.random.key(seed)}, jnp.zeros((4, size, size, 3)))
    return disc, _randomize_biases(v["params"], seed + 1)


@pytest.mark.parametrize("size,n", [(16, 4), (32, 8)])
def test_discriminator_logits_match_jax(size, n):
    disc, params = _jax_discriminator(size)
    port = T.StyleGAN2Discriminator(size=size, width_scale=WIDTH, device="cpu")
    port.load_state_dict(jax_params.discriminator_state_dict(params))
    x = np.random.default_rng(size).standard_normal((n, size, size, 3)).astype(np.float32)
    want, want_feats = jax.jit(disc.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got, feats = port.eval()(torch.from_numpy(x))
    assert got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(feats["features"].numpy(), np.asarray(want_feats["features"]),
                               atol=ATOL, rtol=RTOL)


def test_discriminator_bridge_raises_on_unknown_leaf():
    _, params = _jax_discriminator(16)
    params = dict(params)
    params["DResBlock_0"] = dict(params["DResBlock_0"], ConvLayer_9={"bias": np.zeros(3)})
    with pytest.raises(ValueError, match="ConvLayer_9"):
        jax_params.discriminator_state_dict(params)


def test_discriminator_bridge_covers_every_port_parameter():
    """Strict loading: the bridge fills every port discriminator parameter."""
    _, params = _jax_discriminator(32)
    port = T.StyleGAN2Discriminator(size=32, width_scale=WIDTH, device="cpu")
    assert set(jax_params.discriminator_state_dict(params)) == set(port.state_dict())
