"""Port ADA (diagan_tpu_torch.models.ada) against the JAX package's ADA.

The RNGs differ (JAX's threefry against torch's Philox), so nothing here
compares by seed: the resampling is held against the JAX functions on the
same injected matrices, drawn once with the JAX sampler and handed to both,
at 1e-5; the port's own samplers are checked by their distributions; the
AdaptiveAugment controller by its exact p sequence. Small images (16 px).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diagan_tpu.models import ada as J  # noqa: E402
from diagan_tpu_torch.models import ada as T  # noqa: E402

H = 16
TOL = dict(rtol=1e-5, atol=1e-5)
# jitted: eager JAX is slow on the CPU
jax_apply_affine = jax.jit(J.apply_affine, static_argnames=("pad_buckets",))
jax_apply_color = jax.jit(J.apply_color)


def _images(n, seed=0, h=H):
    return np.tanh(np.random.default_rng(seed).standard_normal((n, h, h, 3))).astype(np.float32)


def _jax_affine(n, p, seed):
    fn = jax.jit(J.sample_affine_matrices, static_argnums=(1, 2, 3, 4))
    return np.array(fn(jax.random.key(seed), n, p, H, H))


def _jax_color(n, p, seed):
    return np.array(jax.jit(J.sample_color_matrices, static_argnums=(1, 2))(
        jax.random.key(seed), n, p))


def _port_affine(x, G, **kw):
    return T.apply_affine(torch.from_numpy(x), torch.from_numpy(G), **kw).numpy()


@pytest.mark.parametrize("p,seed", [(1.0, 0), (0.5, 1)])
def test_apply_affine_matches_jax(p, seed):
    x, G = _images(4, seed), _jax_affine(4, p, seed)
    want = np.asarray(jax_apply_affine(jnp.asarray(x), jnp.asarray(G)))
    np.testing.assert_allclose(_port_affine(x, G), want, **TOL)


def test_apply_affine_buckets_match_jax_and_pick_by_extent():
    """With pad buckets each call takes the smallest reflect pad that covers
    its batch; a mild batch and a wild one pick different buckets, and both
    agree with the JAX switch and with the largest pad."""
    x = _images(2, 3)
    eye = np.tile(np.eye(3, dtype=np.float32), (2, 1, 1))
    wild = _jax_affine(2, 1.0, 4)
    needs = [T._needed_pad(torch.linalg.inv(torch.from_numpy(G)), H) for G in (eye, wild)]
    assert needs[0] < needs[1]
    for G in (eye, wild):
        want = np.asarray(jax_apply_affine(jnp.asarray(x), jnp.asarray(G), pad_buckets=(0.25, 0.5)))
        got = _port_affine(x, G, pad_buckets=(0.25, 0.5))
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got, _port_affine(x, G), **TOL)


def test_needed_pad_matches_jax():
    for seed in range(4):
        Ginv = np.linalg.inv(_jax_affine(8, 1.0, 10 + seed)).astype(np.float32)
        want = float(jax.jit(J._needed_pad, static_argnums=1)(jnp.asarray(Ginv), H))
        assert T._needed_pad(torch.from_numpy(Ginv), H) == pytest.approx(want, rel=1e-5)


def test_apply_color_matches_jax():
    x, C = _images(4, 5), _jax_color(4, 1.0, 5)
    want = np.asarray(jax_apply_color(jnp.asarray(x), jnp.asarray(C)))
    got = T.apply_color(torch.from_numpy(x), torch.from_numpy(C)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_augment_on_injected_draws_matches_jax_pipeline():
    """augment = apply_affine then apply_color on 3 channels, with the
    trainer's pad buckets."""
    x, G, C = _images(3, 6), _jax_affine(3, 0.8, 6), _jax_color(3, 0.8, 7)
    want = jax_apply_color(jax_apply_affine(jnp.asarray(x), jnp.asarray(G), pad_buckets=(0.25, 0.5)),
                         jnp.asarray(C))
    got = T.augment(torch.from_numpy(x), 0.8, torch.from_numpy(G), torch.from_numpy(C),
                    pad_buckets=T.pad_buckets_for(0.75))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_augment_at_p0_returns_the_input_and_identity_reconstructs():
    x = torch.from_numpy(_images(2, 8))
    assert T.augment(x, 0.0, None, None) is x
    G, C = T.sample_augment(64, 0.0, H, H, torch.Generator().manual_seed(0))
    torch.testing.assert_close(G, torch.eye(3).expand(64, 3, 3), rtol=0, atol=0)
    torch.testing.assert_close(C, torch.eye(4).expand(64, 4, 4), rtol=0, atol=0)
    # sym6 is orthonormal: the full resample at the identity gives x back
    out = T.augment(x, 1.0, G[:2], C[:2])
    torch.testing.assert_close(out, x, rtol=1e-5, atol=1e-5)


def test_affine_sampler_distribution():
    """x-flip (the only transform with a negative determinant) fires at
    p * 1/2; integer translation lands on the pixel grid."""
    n, p = 20000, 0.6
    G = T.sample_affine_matrices(n, p, H, H, torch.Generator().manual_seed(1)).numpy()
    flips = np.mean(np.linalg.det(G[:, :2, :2]) < 0)
    assert abs(flips - p / 2) < 4 * np.sqrt(p / 2 * (1 - p / 2) / n)
    # Integer translation: with width 2H and height H, a matrix that only
    # translates, by a non-zero amount on each axis's own pixel grid, comes
    # from the integer translate alone (the fractional one is continuous). Its
    # rate is p, times every other gate closed, times round(32 t) != 0 for
    # t ~ U(-1/8, 1/8); the two axes round the same scalar t.
    p = 0.25
    G = T.sample_affine_matrices(n, p, H, 2 * H, torch.Generator().manual_seed(2)).numpy()
    pure = np.all(G[:, :2, :2] == np.eye(2), axis=(1, 2))
    tx, ty = G[:, 0, 2], G[:, 1, 2]
    # k / 32 and k / 16 are exact in float32
    on_grid = (pure & (tx * 2 * H == np.round(tx * 2 * H)) & (ty * H == np.round(ty * H))
               & ((tx != 0) | (ty != 0)))
    p_rot = 1 - np.sqrt(1 - p)
    want = p * (1 - p / 2) ** 2 * (1 - p) ** 3 * (1 - p_rot) ** 2 * (1 - 1 / 8)
    assert abs(on_grid.mean() - want) < 4 * np.sqrt(want * (1 - want) / n)
    assert np.all(np.abs(tx[on_grid]) <= 0.125) and np.all(np.abs(tx - ty)[on_grid] <= 1 / 32)


def test_color_sampler_distribution():
    """Brightness fires at p: the translation column is non-zero exactly when
    brightness (and no luma flip or other mixing) moved it; at p = 1 every
    matrix is a proper colour transform with the homogeneous row kept."""
    n, p = 20000, 0.4
    C = T.sample_color_matrices(n, p, torch.Generator().manual_seed(3)).numpy()
    only_bright = np.all(np.abs(C[:, :3, :3] - np.eye(3)) == 0, axis=(1, 2))
    # P(only brightness among the five) = p (1-p)^3 (1 - p/2) (luma flip is p * 1/2)
    want = p * (1 - p) ** 3 * (1 - p / 2)
    got = np.mean(only_bright & np.any(C[:, :3, 3] != 0, axis=1))
    assert abs(got - want) < 4 * np.sqrt(want * (1 - want) / n)
    C1 = T.sample_color_matrices(64, 1.0, torch.Generator().manual_seed(4)).numpy()
    np.testing.assert_allclose(C1[:, 3, :3], 0, atol=1e-6)


def test_adaptive_augment_sequence_matches_jax():
    rng = np.random.default_rng(9)
    ours, theirs = T.AdaptiveAugment(update_every=64), J.AdaptiveAugment(update_every=64)
    got, want = [], []
    for _ in range(300):
        sign_sum, count = float(rng.integers(-16, 17)), 16
        got.append(ours.tune(sign_sum, count))
        want.append(theirs.tune(sign_sum, count))
    assert got == want
    assert ours.r_t_stat == theirs.r_t_stat and max(got) > 0
