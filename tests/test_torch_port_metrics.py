"""The port's FID / IS / KID / PR against the JAX package's, on identical
features, on the CPU.

normalize_images, the statistics, the Frechet distance (also on singular
covariances, and through the eps-jitter retry), the .npz statistics, FID and KID are
framework-free copies: exactly equal. The Inception Score's softmax runs in
torch float32 against jax.nn.softmax: the score within rtol 1e-6 (its spread
over the splits, a difference of numbers of the score's size, within 1e-6 of
the score). Precision, recall and partial recall are exactly equal on
features built with a margin: both packages compute the distances in float32
as ||x||^2 - 2 x.y + ||y||^2, but XLA and torch sum x.y in other orders, so
a distance within float32 round-off of a radius could fall on the other side
of the strict < in each package. The features lie on an integer grid: every
norm, product and distance is an integer below 2^24, exact in float32 on
both sides, so a distance either ties a radius exactly (and the strict <
rejects it on both sides) or lies at least 1 from it, above 1e-4 of the
largest radius (checked in float64).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diagan_tpu.eval import metrics as JM  # noqa: E402
from diagan_tpu_torch.eval import metrics as TM  # noqa: E402


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch in these tests: the suite runs test files
    in parallel processes, and torch's default of one thread per core makes
    the processes' small ops wait on each other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _features(n, d, seed, shift=0.0):
    return (np.random.default_rng(seed).standard_normal((n, d)) + shift).astype(np.float32)


def test_normalize_images_is_exact():
    x = np.random.default_rng(0).uniform(-1.5, 1.5, (6, 8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(TM.normalize_images(x), JM.normalize_images(x))


def test_statistics_drop_non_finite_rows_and_are_exact():
    f = _features(50, 16, 1).astype(np.float64)
    f[3, 2], f[7, 0] = np.nan, np.inf
    for got, want in zip(TM.activation_statistics(f), JM.activation_statistics(f)):
        np.testing.assert_array_equal(got, want)
    assert TM.activation_statistics(f)[1].shape == (16, 16)


@pytest.mark.parametrize("n_real,n_fake", [(300, 200), (40, 30)], ids=["full", "singular"])
def test_fid_is_exact(n_real, n_fake, tmp_path):
    """FID from features and from a saved statistics file; with fewer
    samples than dimensions the covariances are singular (scipy's sqrtm
    still returns a finite root: the eps-jitter retry is the next test's)."""
    real, fake = _features(n_real, 64, 2), _features(n_fake, 64, 3, shift=0.3)
    want = JM.fid_from_features(real, fake)
    assert np.isfinite(want)
    assert TM.fid_from_features(real, fake) == want
    mu, sigma = TM.activation_statistics(real)
    TM.save_stats(tmp_path / "s" / "stats.npz", mu, sigma)
    for a, b in zip(TM.load_stats(tmp_path / "s" / "stats.npz"), JM.load_stats(tmp_path / "s" / "stats.npz")):
        np.testing.assert_array_equal(a, b)
    assert TM.fid_from_features(fake_features=fake, stats_file=tmp_path / "s" / "stats.npz") == want
    m1, s1 = JM.activation_statistics(real)
    m2, s2 = JM.activation_statistics(fake)
    assert TM.frechet_distance(m1, s1, m2, s2) == JM.frechet_distance(m1, s1, m2, s2)


def test_fid_eps_jitter_retry_is_exact(monkeypatch):
    """When sqrtm's first root is not finite, both packages retry on the
    covariances plus eps * I (fid_utils.py:11-67): here sqrtm's first call
    returns NaNs, on each side."""
    from scipy import linalg

    sqrtm = linalg.sqrtm
    real, fake = _features(40, 64, 2), _features(30, 64, 3, shift=0.3)
    results, calls = [], []
    for fid in (JM.fid_from_features, TM.fid_from_features):
        def first_nan(a, *args, **kw):
            calls.append(a)
            return np.full_like(a, np.nan) if len(calls) % 2 == 1 else sqrtm(a, *args, **kw)
        monkeypatch.setattr(linalg, "sqrtm", first_nan)
        results.append(fid(real, fake))
    assert len(calls) == 4 and np.isfinite(results[0]) and results[0] == results[1]
    np.testing.assert_array_equal(calls[1], calls[3])  # the jittered product
    assert not np.array_equal(calls[0], calls[1])


def test_kid_is_exact():
    real, fake = _features(120, 32, 4), _features(90, 32, 5, shift=0.2)
    assert TM.kid_from_features(real, fake, subset_size=50, seed=3) == \
        JM.kid_from_features(real, fake, subset_size=50, seed=3)
    assert TM.kid_from_features(real, fake) == JM.kid_from_features(real, fake)


def test_inception_score_matches():
    logits = (3.0 * np.random.default_rng(6).standard_normal((250, 1008))).astype(np.float32)
    for splits, x in ((10, logits), (5, torch.from_numpy(logits))):
        (mean, std), (want_mean, want_std) = (TM.inception_score_from_logits(x, splits),
                                              JM.inception_score_from_logits(logits, splits))
        np.testing.assert_allclose(mean, want_mean, rtol=1e-6)
        assert abs(std - want_std) <= 1e-6 * want_mean


def _sq_dists64(x, y):
    x, y = x.astype(np.float64), y.astype(np.float64)
    return ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)


def _grid_features(n, d, seed, shift=0):
    return (np.random.default_rng(seed).integers(-3, 4, (n, d)) + shift).astype(np.float32)


def _margin(real, fake, k=3):
    """The smallest |distance - radius| over every comparison that precision
    and recall make, leaving out exact ties, relative to the largest radius,
    in float64."""
    def radii(f):
        return np.sort(_sq_dists64(f, f), axis=1)[:, k]
    rr, fr, d = radii(real), radii(fake), _sq_dists64(real, fake)
    gaps = np.concatenate([np.abs(d - rr[:, None]).ravel(), np.abs(d - fr[None, :]).ravel()])
    return gaps[gaps > 0].min() / max(rr.max(), fr.max())


@pytest.mark.parametrize("seed", [7, 8])
def test_precision_recall_and_partial_recall_are_exact(seed):
    real = _grid_features(160, 64, seed)
    fake = _grid_features(140, 64, seed + 100)
    fake[:70, :8] += 1  # half the fakes off the reals' manifold
    assert max(np.abs(real).max(), np.abs(fake).max()) ** 2 * 64 * 4 < 2**24
    assert _margin(real, fake) > 1e-4  # see the module docstring
    want = JM.compute_pr(real, fake, nearest_k=3)
    assert 0.0 < want["precision"] < 1.0 and 0.0 < want["recall"] < 1.0
    assert TM.compute_pr(real, fake, nearest_k=3) == want
    assert TM.compute_pr(torch.from_numpy(real), torch.from_numpy(fake)) == want
    part = real[:40]
    assert TM.compute_partial_recall(part, fake) == JM.compute_partial_recall(part, fake)


def test_radii_take_the_k_plus_first_smallest_including_self():
    f = _features(30, 8, 9)
    got = TM._knn_radii(torch.from_numpy(f), 3).numpy()
    np.testing.assert_array_equal(got, np.asarray(JM._knn_radii(f, 3)))
    np.testing.assert_allclose(got, np.sort(_sq_dists64(f, f), axis=1)[:, 3], rtol=1e-4)
