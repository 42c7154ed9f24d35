"""The port's FID InceptionV3 and its featurizer against the JAX package's, on
the CPU.

Weights: the Flax variable tree comes from jax.eval_shape (no eager init:
an eager InceptionV3().init takes ~38 s here) and every leaf is filled with
seeded numpy values the way tests/test_inception_parity.py:_randomized
randomises its torch oracle, BatchNorm running statistics included; the
port takes them through utils/jax_params.py inception_state_dict. Each
block InceptionA-E (both E variants) runs at its real channel width on a
small input (tolerance 1e-5 x max(1, max|out|)); the full-depth, full-width
network runs at 75 px, torchvision's smallest size, where every stride still
works (pool3 and logits within 1e-3 of max|out|, the JAX test's own gate).

The resize is held against jax.image.resize (jitted, as the JAX featurizer
runs it): 8 -> 64 and 299 -> 299 bit for bit, 32/64/256 -> 299 within 4e-7
(XLA's and torch's matmuls sum in other orders), 320 -> 299 (the antialiased
shrink) within 4e-7 as well. The random-weight probe is exact against JAX's
draws (the noise and the smooth images; the linspace ramps and flats
within two ulps); its affine agrees with the JAX featurizer's at rtol 1e-12. The weight
file loader and a slow end-to-end featurizer test at 299 close the file.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diagan_tpu.eval import inception as JI  # noqa: E402
from diagan_tpu_torch.eval import inception as TI  # noqa: E402
from diagan_tpu_torch.utils.jax_params import inception_state_dict  # noqa: E402


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch in these tests: the suite runs test files
    in parallel processes, and torch's default of one thread per core makes
    the processes' small ops wait on each other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fill(shapes, rng):
    """A Flax InceptionV3 (or block) variable tree of ShapeDtypeStructs ->
    numpy values drawn as _randomized draws its torch oracle's."""
    def leaf(path, s):
        name = path[-1]
        if name == "kernel" and len(s.shape) == 4:
            return rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:3]))
        if name == "kernel":
            return rng.standard_normal(s.shape) / np.sqrt(s.shape[0])
        if name == "scale":
            return 0.8 + 0.4 * rng.uniform(size=s.shape)
        if name == "bias" and "Dense_0" in path:
            return 0.01 * rng.standard_normal(s.shape)
        if name in ("bias", "mean"):
            return 0.1 * rng.standard_normal(s.shape)
        assert name == "var", path
        return 0.5 + rng.uniform(size=s.shape)

    def walk(tree, path):
        return {k: walk(v, path + (k,)) if hasattr(v, "items")
                else leaf(path + (k,), v).astype(np.float32) for k, v in tree.items()}
    return walk(shapes, ())


def _flax_variables(module, x_shape, seed):
    shapes = jax.eval_shape(module.init, jax.random.key(0), jnp.zeros(x_shape))
    return _fill(shapes, np.random.default_rng(seed))


@pytest.fixture(scope="module")
def full_net():
    """(Flax variables, the port's InceptionV3 with the same weights)."""
    variables = _flax_variables(JI.InceptionV3(), (1, 75, 75, 3), seed=0)
    model = TI.InceptionV3()
    model.load_state_dict(inception_state_dict(variables))
    return variables, model.eval()


def _max_rel(got, want):
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


BLOCKS = {
    "A": (lambda: JI.InceptionA(32), lambda: TI.InceptionA(192, 32), (2, 7, 7, 192)),
    "B": (lambda: JI.InceptionB(), lambda: TI.InceptionB(288), (2, 9, 9, 288)),
    "C": (lambda: JI.InceptionC(160), lambda: TI.InceptionC(768, 160), (2, 7, 7, 768)),
    "D": (lambda: JI.InceptionD(), lambda: TI.InceptionD(768), (2, 9, 9, 768)),
    "E_avg": (lambda: JI.InceptionE(), lambda: TI.InceptionE(1280), (2, 5, 5, 1280)),
    "E_max": (lambda: JI.InceptionE(pool_kind="max"), lambda: TI.InceptionE(2048, pool="max"),
              (2, 5, 5, 2048)),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_blocks_match_jax(name):
    """Each block at its real channel width; the avg pools exclude the padded
    zeros and Mixed_7c's E max-pools, on both sides."""
    make_j, make_t, shape = BLOCKS[name]
    variables = _flax_variables(make_j(), shape, seed=1)
    block = make_t()
    block.load_state_dict(inception_state_dict(variables, block))
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax.jit(make_j().apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = block.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert _max_rel(got, want) < 1e-5


def test_full_network_matches_jax_at_75px(full_net):
    """The full-depth, full-width network, batch 2 at 75 px: pool3 and
    logits within 1e-3 of max|out|."""
    variables, model = full_net
    x = np.random.default_rng(3).uniform(-1, 1, (2, 75, 75, 3)).astype(np.float32)
    j_pool, j_logits = jax.jit(JI.InceptionV3().apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        t_pool, t_logits = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for got, want in ((t_pool.numpy(), np.asarray(j_pool)), (t_logits.numpy(), np.asarray(j_logits))):
        assert np.abs(want).max() > 1e-3  # the activations did not die
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-3


def test_bridge_raises_on_a_leaf_it_does_not_consume(full_net):
    variables = copy.deepcopy(full_net[0])
    variables["params"]["Dense_0"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="no rule"):
        inception_state_dict(variables)


_jax_resize = jax.jit(lambda x, n: jax.image.resize(x, (x.shape[0], n, n, x.shape[-1]),
                                                    "bilinear"), static_argnums=1)


@pytest.mark.parametrize("size,out,tol", [(8, 64, 0.0), (299, 299, 0.0), (32, 299, 4e-7),
                                          (64, 299, 4e-7), (256, 299, 4e-7), (320, 299, 4e-7)])
@pytest.mark.parametrize("channels", [3, 1])
def test_resize_matches_jax_image_resize(size, out, tol, channels):
    """resize_bilinear against jax.image.resize(..., "bilinear") under jit:
    half-pixel centres, and the antialiased shrink at 320 px."""
    x = np.random.default_rng(size).uniform(-1, 1, (2, size, size, channels)).astype(np.float32)
    want = np.asarray(_jax_resize(jnp.asarray(x), out))
    got = TI.resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), out).permute(0, 2, 3, 1)
    assert np.abs(got.numpy() - want).max() <= tol


@pytest.fixture(scope="module")
def stub_jax_featurizer():
    """The JAX InceptionFeaturizer with random weights and its model stubbed
    out as the identity: its _fwd returns the network's input as the JAX
    featurizer prepares it, and its probe affine is computed on the resized
    probe itself."""
    class Identity:
        def init(self, key, x):
            return {}

        def apply(self, variables, x):
            return x, x

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JI, "InceptionV3", Identity)
        mp.delenv("DIAGAN_TPU_INCEPTION_WEIGHTS", raising=False)
        feat = JI.InceptionFeaturizer(batch_size=4)
    assert feat.weights_kind == "random"
    return feat


@pytest.mark.parametrize("size,dtype,channels", [(32, "uint8", 3), (64, "float32", 3),
                                                 (32, "uint8", 1), (320, "float32", 3)])
def test_inception_input_matches_the_jax_featurizer(stub_jax_featurizer, size, dtype, channels):
    """uint8 becomes x / 127.5 - 1 (exactly), the resize, and one channel
    repeated to three, against the JAX featurizer's own preprocessing."""
    feat = stub_jax_featurizer
    rng = np.random.default_rng(size + channels)
    if dtype == "uint8":
        x = rng.integers(0, 256, (3, size, size, channels)).astype(np.uint8)
    else:
        x = rng.uniform(-1, 1, (3, size, size, channels)).astype(np.float32)
    want = np.asarray(feat._fwd(jnp.asarray(x))[0])
    got = TI.inception_input(x, "cpu").permute(0, 2, 3, 1).numpy()
    assert got.shape == (3, 299, 299, 3)
    assert np.abs(got - want).max() <= 4e-7


def test_probe_and_affine_match_jax(stub_jax_featurizer):
    """make_probe on jax.random.key(1)'s draws against the JAX probe
    (diagan_tpu/eval/inception.py:214-228): the noise and smooth images bit
    for bit; the ramps and flats within two float32 ulps of 1 (2.4e-7: a
ramp is the product of two linspace values, each one ulp off at most), as
    jnp.linspace's values come from XLA's compiled float32 arithmetic, which
    the port (torch.linspace) does not reproduce bit for bit. The standardising
    affine of the JAX featurizer's own probe features (the stub's resized
    probe) equals standardizing_affine's at rtol 1e-12."""
    feat = stub_jax_featurizer
    k1, k2 = jax.random.split(jax.random.key(1))
    noise_u = np.asarray(jax.random.uniform(k1, (16, 64, 64, 3)))
    coarse_u = np.asarray(jax.random.uniform(k2, (16, 8, 8, 3)))
    # the JAX package's probe, as its featurizer builds it
    noise = jax.random.uniform(k1, (16, 64, 64, 3), minval=-1, maxval=1)
    smooth = jax.image.resize(jax.random.uniform(k2, (16, 8, 8, 3), minval=-1, maxval=1),
                              (16, 64, 64, 3), "bilinear")
    yy = jnp.linspace(-1, 1, 64)[None, :, None, None]
    ramps = jnp.tile(yy, (8, 1, 64, 3)) * jnp.linspace(0.25, 1, 8)[:, None, None, None]
    flat = jnp.ones((8, 64, 64, 3)) * jnp.linspace(-1, 1, 8)[:, None, None, None]
    want = np.asarray(jnp.concatenate([noise, smooth, ramps, flat]))
    probe = TI.make_probe(noise_u, coarse_u).numpy()
    np.testing.assert_array_equal(probe[:32], want[:32])
    assert np.abs(probe[32:] - want[32:]).max() <= 2.0**-22

    pf = np.asarray(feat._fwd(jnp.asarray(want))[0]).reshape(48, -1)  # resized to 299
    assert pf.shape == (48, 299 * 299 * 3)
    shift, scale = TI.standardizing_affine(pf)
    np.testing.assert_allclose(shift, np.asarray(feat._feat_shift).reshape(-1), rtol=1e-12)
    np.testing.assert_allclose(scale, np.asarray(feat._feat_scale).reshape(-1), rtol=1e-12)


def _pt_inception_file(model, path, extra=True):
    """The port model's weights as a pytorch-fid-shaped state_dict file:
    torchvision's names, AuxLogits entries (dropped by both loaders) and
    BatchNorm's num_batches_tracked."""
    sd = dict(model.state_dict())
    if extra:
        sd["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
        sd["AuxLogits.fc.weight"] = torch.zeros(1000, 768)
    torch.save(sd, path)
    return sd


class _TemplateModel:
    """Stands for the Flax InceptionV3 in the JAX loader: its init gives the
    variable tree's structure (a copy of the fixture's), which the loader
    overwrites leaf by leaf."""

    def __init__(self, variables):
        self.variables = variables

    def init(self, key, x):
        return copy.deepcopy(self.variables)


def test_file_loader_matches_the_jax_loader(full_net, tmp_path):
    """The same pt_inception-shaped file through both loaders gives the same
    weights; a file with one conv fewer raises on both sides."""
    variables, model = full_net
    other = TI.random_init_(TI.InceptionV3(), seed=5)
    for m in other.modules():  # non-trivial BatchNorm statistics
        if isinstance(m, torch.nn.BatchNorm2d):
            with torch.no_grad():
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    path = tmp_path / "pt_inception.pth"
    sd = _pt_inception_file(other, path)
    jax_vars = JI.load_torch_weights(_TemplateModel(variables), str(path))
    want = inception_state_dict(jax.device_get(jax_vars))
    got = TI.load_torch_weights(TI.InceptionV3(), path).state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["fc.weight"], sd["fc.weight"])

    del sd["Mixed_6b.branch7x7_2.conv.weight"]
    torch.save(sd, path)
    with pytest.raises(ValueError, match="conv count mismatch"):
        JI.load_torch_weights(_TemplateModel(variables), str(path))
    with pytest.raises(ValueError, match="conv count mismatch"):
        TI.load_torch_weights(TI.InceptionV3(), path)


def test_random_weights_are_seeded_and_the_same_on_every_call():
    a = TI.random_init_(TI.InceptionV3(), seed=0).state_dict()
    b = TI.random_init_(TI.InceptionV3(), seed=0).state_dict()
    c = TI.random_init_(TI.InceptionV3(), seed=1).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["Conv2d_1a_3x3.conv.weight"], c["Conv2d_1a_3x3.conv.weight"])
    w = a["Mixed_7c.branch_pool.conv.weight"]
    assert abs(w.std().item() * np.sqrt(2048) - 1.0) < 0.05  # lecun-normal scale


@pytest.mark.slow
def test_featurizer_end_to_end_parity_at_299(full_net, tmp_path):
    """Both featurizers with loaded weights from one file, 8 uint8 64 px
    images: resize to 299, the network, batches of 3 (a short last batch):
    pool3 within 1e-3 of max|out|, logits likewise."""
    _, model = full_net
    path = tmp_path / "w.pth"
    _pt_inception_file(model, path, extra=False)
    x = np.random.default_rng(4).integers(0, 256, (8, 64, 64, 3)).astype(np.uint8)
    jf = JI.InceptionFeaturizer(weights_path=str(path), batch_size=3)
    tf = TI.InceptionFeaturizer(weights_path=str(path), batch_size=3, device="cpu")
    assert jf.weights_kind == tf.weights_kind == "loaded"
    for got, want in zip(tf.features_and_logits(x), jf.features_and_logits(x)):
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-3


def test_featurizer_pipeline_on_the_cpu(monkeypatch):
    """The random-weight featurizer end to end at a small cost: batches, the
    short last batch, the affine applied to the features and not the
    logits, and no cross-talk between rows."""
    monkeypatch.delenv("DIAGAN_TPU_INCEPTION_WEIGHTS", raising=False)
    monkeypatch.setattr(TI, "INCEPTION_SIZE", 75)
    feat = TI.InceptionFeaturizer(batch_size=3, device="cpu")
    assert feat.weights_kind == "random" and feat._feat_scale.shape == (2048,)
    x = np.random.default_rng(5).integers(0, 256, (5, 32, 32, 3)).astype(np.uint8)
    f, lg = feat.features_and_logits(x)
    assert f.shape == (5, 2048) and f.dtype == np.float64 and lg.shape == (5, 1008)
    raw, raw_logits = (t[0].numpy() for t in feat._forward(x[3:4]))
    # the affine's scale amplifies float noise: compare before it
    unscaled = f[3] / feat._feat_scale + feat._feat_shift
    assert np.abs(unscaled - raw).max() <= 1e-5 * max(1.0, np.abs(raw).max())
    assert np.abs(lg[3] - raw_logits).max() <= 1e-5 * max(1.0, np.abs(raw_logits).max())
    np.testing.assert_array_equal(feat.features(x), f)

