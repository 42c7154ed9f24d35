"""Port StyleGAN2 generator (diagan_tpu_torch.models.stylegan2) against JAX.

The same Flax params go to both sides, the port's through the weight bridge
(diagan_tpu_torch.utils.jax_params); the same numpy latents, mean latent and
per-layer noises go to both (the JAX noises are injected with
flax's intercept_methods, so the real `sample` method runs). Small models:
size 16/32, width_scale 1/16, style_dim 32, n_mlp 2. Tolerance atol 3e-4,
rtol 1e-3, as the existing torch-import parity tests use for StyleGAN2.
"""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diagan_tpu.models import stylegan2 as J  # noqa: E402
from diagan_tpu_torch.models import stylegan2 as T  # noqa: E402
from diagan_tpu_torch.utils import jax_params  # noqa: E402

STYLE_DIM, N_MLP, WIDTH = 32, 2, 1 / 16
ATOL, RTOL = 3e-4, 1e-3


def _randomize_zero_init(params, seed):
    """Give the zero- and one-initialised leaves (biases, noise weights,
    modulation biases) random values so that every one of them matters."""
    rng = np.random.default_rng(seed)

    def fix(path, leaf):
        leaf = np.asarray(leaf)
        name = path[-1].key
        if name in ("bias", "weight"):
            base = 1.0 if path[-2].key == "modulation" else 0.0
            return (base + 0.2 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(fix, jax.device_get(params))


@functools.cache
def _jax_generator(size, seed=0):
    gen = J.StyleGAN2Generator(size=size, style_dim=STYLE_DIM, n_mlp=N_MLP, width_scale=WIDTH)
    v = gen.init({"params": jax.random.key(seed), "noise": jax.random.key(1)},
                 jnp.zeros((2, STYLE_DIM)))
    return gen, _randomize_zero_init(v["params"], seed)


def _port_generator(size, params):
    g = T.StyleGAN2Generator(size=size, style_dim=STYLE_DIM, n_mlp=N_MLP,
                             width_scale=WIDTH, device="cpu")
    g.load_state_dict(jax_params.generator_state_dict(params))
    return g.eval()


def _noise_index(layer):
    if layer == "conv1":
        return 0
    kind, res = layer.rsplit("_", 1)
    return 2 * int(math.log2(int(res) // 8)) + (1 if kind == "conv_up" else 2)


def _jax_sample(gen, params, zs, cutoff, truncation, w_mean, noises):
    def inject(next_fun, args, kwargs, context):
        if isinstance(context.module, J.NoiseInjection) and context.method_name == "__call__":
            layer = context.module.scope.path[-2]
            return next_fun(args[0], jnp.asarray(noises[_noise_index(layer)]))
        return next_fun(*args, **kwargs)

    @jax.jit
    def sample(params, zs, w_mean):
        with nn.intercept_methods(inject):
            return gen.apply({"params": params}, zs, cutoff, truncation, w_mean,
                             method=J.StyleGAN2Generator.sample)

    return np.asarray(sample(params, [jnp.asarray(z) for z in zs],
                             None if w_mean is None else jnp.asarray(w_mean)))


@pytest.mark.parametrize("size,truncation,mixing", [
    (16, 1.0, None), (16, 0.7, None), (16, 0.7, 3), (32, 1.0, 5),
])
def test_generator_sample_matches_jax(size, truncation, mixing):
    gen, params = _jax_generator(size)
    port = _port_generator(size, params)
    rng = np.random.default_rng(size)
    n = 3
    zs = [rng.standard_normal((n, STYLE_DIM)).astype(np.float32)
          for _ in range(1 if mixing is None else 2)]
    w_mean = rng.standard_normal((1, STYLE_DIM)).astype(np.float32)
    noises = [rng.standard_normal(s).astype(np.float32)
              for s in port.synthesis.noise_shapes(n)]
    want = _jax_sample(gen, params, zs, mixing, truncation, w_mean, noises)
    with torch.no_grad():
        got = port.sample([torch.from_numpy(z) for z in zs], mixing, truncation,
                          torch.from_numpy(w_mean),
                          noises=[torch.from_numpy(t) for t in noises]).numpy()
    assert got.shape == want.shape == (n, size, size, 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_generator_draws_noise_from_its_generator():
    """Without injected noises, the noise comes from the torch.Generator: the
    same seed gives the same images, another seed other images."""
    _, params = _jax_generator(16)
    port = _port_generator(16, params)
    z = torch.from_numpy(np.random.default_rng(0).standard_normal((2, STYLE_DIM)).astype(np.float32))
    with torch.no_grad():
        a = port(z, generator=torch.Generator().manual_seed(5))
        b = port(z, generator=torch.Generator().manual_seed(5))
        c = port(z, generator=torch.Generator().manual_seed(6))
        w = port.mean_latent(64, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    assert w.shape == (1, STYLE_DIM) and torch.isfinite(w).all()


@pytest.mark.parametrize("upsample,kernel_size", [(True, 3), (False, 3), (False, 1)])
def test_modulated_conv_matches_jax(upsample, kernel_size):
    """The upsampling case holds the bridge's spatial flip: lax.conv_transpose
    correlates with the HWIO kernel as given, F.conv_transpose2d convolves."""
    rng = np.random.default_rng(3)
    n, cin, cout, s, h = 2, 8, 6, 16, 5
    demod = kernel_size == 3
    mod = J.ModulatedConv(features=cout, kernel_size=kernel_size, upsample=upsample,
                          demodulate=demod)
    x = rng.standard_normal((n, h, h, cin)).astype(np.float32)
    style = rng.standard_normal((n, s)).astype(np.float32)
    params = mod.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(style))["params"]
    params = _randomize_zero_init(params, 4)
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x), jnp.asarray(style)))
    port = T.ModulatedConv(cin, cout, s, kernel_size, demodulate=demod, upsample=upsample,
                           device="cpu")
    port.load_state_dict(jax_params.modulated_conv_state_dict(params, upsample=upsample))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(style))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    if upsample:  # the asymmetric random kernel must need the flip
        port.load_state_dict(jax_params.modulated_conv_state_dict(params, upsample=False))
        with torch.no_grad():
            unflipped = port(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(style))
        assert np.abs(unflipped.permute(0, 2, 3, 1).numpy() - want).max() > 1e-2


def test_generator_bridge_raises_on_unknown_leaf():
    _, params = _jax_generator(16)
    params = dict(params)
    params["mystery"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="mystery/kernel"):
        jax_params.generator_state_dict(params)


def test_generator_bridge_covers_every_port_parameter():
    """Strict loading: the bridge fills every port generator parameter."""
    _, params = _jax_generator(32)
    port = T.StyleGAN2Generator(size=32, style_dim=STYLE_DIM, n_mlp=N_MLP,
                                width_scale=WIDTH, device="cpu")
    assert set(jax_params.generator_state_dict(params)) == set(port.state_dict())


def test_generator_bf16_synthesis_tracks_fp32():
    """generate --bf16: the synthesis runs in bf16 (parameters, mapping and
    demodulation stay fp32) and lands within bf16 rounding of the fp32 images."""
    _, params = _jax_generator(16)
    g32 = _port_generator(16, params)
    g16 = T.StyleGAN2Generator(size=16, style_dim=STYLE_DIM, n_mlp=N_MLP, width_scale=WIDTH,
                               dtype=torch.bfloat16, device="cpu")
    g16.load_state_dict(jax_params.generator_state_dict(params))
    rng = np.random.default_rng(9)
    z = torch.from_numpy(rng.standard_normal((2, STYLE_DIM)).astype(np.float32))
    noises = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for s in g32.synthesis.noise_shapes(2)]
    with torch.no_grad():
        want = g32(z, noises)
        got = g16(z, noises)
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = (got - want).abs().max().item()
    assert 0 < err <= 0.05 * want.abs().max().item()
