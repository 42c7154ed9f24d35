"""Port SNGAN layers and models (diagan_tpu_torch.models.{layers,sngan})
against the JAX package's Flax modules.

The same Flax variables go to both sides, the port's through the weight
bridge (diagan_tpu_torch.utils.jax_params), with every zero- or
one-initialised leaf (biases, BatchNorm scale/bias/statistics) made random so
that each matters; the same numpy inputs go to both. Small widths (16-32
channels), batch 4. The JAX side is jitted. Tolerances (fp32): outputs at
atol 1e-5 x max(1, max|out|); the spectral norm's u and sigma and the
BatchNorm running statistics at 1e-6.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diagan_tpu.models import layers as JL  # noqa: E402
from diagan_tpu.models import sngan as J  # noqa: E402
from diagan_tpu.utils import mimicry_import as MI  # noqa: E402
from diagan_tpu_torch.models import layers as TL  # noqa: E402
from diagan_tpu_torch.models import sngan as T  # noqa: E402
from diagan_tpu_torch.utils import jax_params  # noqa: E402

NZ, BS = 128, 4
STAT_TOL = 1e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch in these tests: the suite runs test files
    in parallel processes, and torch's default of one thread per core makes
    the processes' small ops wait on each other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what):
    want = np.asarray(want)
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol, err_msg=what)


def randomize(variables, seed):
    """Random biases, BatchNorm scales/biases and running statistics."""
    rng = np.random.default_rng(seed)

    def fix(path, leaf):
        leaf = np.asarray(leaf, np.float32)
        name = path[-1].key
        if name in ("bias", "mean"):
            return (0.2 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if name in ("scale", "var"):
            return (1.0 + 0.3 * rng.uniform(-1, 1, leaf.shape)).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(fix, jax.device_get(variables))


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _spectral_leaves(spectral):
    """{layer path: (u (out,), sigma)} of a Flax 'spectral' collection."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax.device_get(spectral))[0]:
        keys = tuple(p.key for p in path)
        layer, var = keys[:-1] + (keys[-1].rsplit("/", 1)[0],), keys[-1].rsplit("/", 1)[1]
        out.setdefault(layer, {})[var] = np.asarray(leaf)
    return out


# --- the spectral-norm layers ---------------------------------------------

SN_CASES = {
    "conv3x3": (JL.SNConv(16, gain=JL._SQRT2), (BS, 8, 8, 8), "SNConv_0"),
    "conv1x1": (JL.SNConv(16, (1, 1), padding="VALID"), (BS, 8, 8, 8), "SNConv_2"),
    "dense": (JL.SNDense(1), (BS, 16), None),
}


@functools.cache
def _sn_case(name):
    mod, shape, _ = SN_CASES[name]
    v = jax.jit(lambda k: mod.init({"params": k}, jnp.zeros(shape)))(jax.random.key(3))
    return mod, randomize(v, 3), _normal(4, *shape)


def _port_sn_layer(name, v):
    """The port layer with the Flax layer's variables, through the bridge."""
    _, shape, snconv = SN_CASES[name]
    if snconv is None:  # SNDense: the discriminator head
        tree = {k: {"SNDense_0": v[k]} for k in ("params", "spectral")}
        layer = TL.SNLinear(shape[1], 1, device="cpu")
        prefix = "l2."
    else:
        tree = {k: {"DBlock_0": {snconv: v[k]}} for k in ("params", "spectral")}
        ksize = v["params"]["Conv_0"]["kernel"].shape[0]
        layer = TL.SNConv2d(shape[-1], 16, ksize, device="cpu")
        prefix = f"block2.{('c1', 'c2', 'c_sc')[int(snconv[-1])]}."
    sd = jax_params.sngan_discriminator_state_dict(
        {"params": tree["params"], "spectral": tree["spectral"]})
    layer.load_state_dict(_strip(sd, prefix))
    return layer


@pytest.mark.parametrize("update_stats", [True, False], ids=["update", "no_update"])
@pytest.mark.parametrize("name", sorted(SN_CASES))
def test_spectral_norm_layer_matches_flax(name, update_stats):
    """Forward, sigma and the stored u after one power iteration; u moves
    only with update_stats, though every forward iterates once."""
    mod, v, x = _sn_case(name)
    out, new = jax.jit(lambda v, x: mod.apply(v, x, update_stats=update_stats,
                                              mutable=["spectral"]))(v, x)
    (want,) = _spectral_leaves(new["spectral"]).values()
    (before,) = _spectral_leaves(v["spectral"]).values()
    layer = _port_sn_layer(name, v)
    u0 = layer.weight_u.clone()
    np.testing.assert_array_equal(u0.numpy(), before["u"].reshape(-1))
    with torch.no_grad():
        _, sigma = layer.power_iteration()
    xt = torch.from_numpy(x) if x.ndim == 2 else _nchw(x)
    got = layer(xt, update_stats=update_stats)
    _close(got.detach().numpy() if x.ndim == 2 else _nhwc(got), out, f"{name} forward")
    if update_stats:
        np.testing.assert_allclose(sigma.item(), float(want["sigma"]), rtol=STAT_TOL)
        np.testing.assert_allclose(layer.weight_u.numpy(), want["u"].reshape(-1), atol=STAT_TOL)
    else:
        assert torch.equal(layer.weight_u, u0)
        np.testing.assert_array_equal(want["u"], before["u"])


def test_spectral_norm_gradient_flows_through_sigma():
    """d(sum out)/dW of the port layer matches jax.grad through Flax's
    SpectralNorm (sigma depends on W; u and v do not carry gradient)."""
    mod, v, x = _sn_case("conv3x3")

    def f(params):
        out, _ = mod.apply({"params": params, "spectral": v["spectral"]}, x,
                           update_stats=True, mutable=["spectral"])
        return jnp.sum(jnp.sin(out))

    want = jax.jit(jax.grad(f))(v["params"])["Conv_0"]["kernel"]
    layer = _port_sn_layer("conv3x3", v)
    torch.sin(layer(_nchw(x), update_stats=True)).sum().backward()
    got = layer.weight.grad.numpy().transpose(2, 3, 1, 0)
    _close(got, want, "dW")


# --- BatchNorm --------------------------------------------------------------

def test_batchnorm_matches_flax():
    """Train mode: batch statistics, running statistics moved by momentum
    0.99 with the biased variance (update_stats) or left alone; eval mode:
    the running statistics."""
    import flax.linen as nn

    bn = nn.BatchNorm()
    x = 1.5 + 2.0 * _normal(5, BS, 6, 6, 8)
    v = randomize(jax.jit(lambda k: bn.init({"params": k}, jnp.zeros((2, 6, 6, 8)),
                                            use_running_average=False))(jax.random.key(0)), 5)
    out, new = jax.jit(lambda v, x: bn.apply(v, x, use_running_average=False,
                                             mutable=["batch_stats"]))(v, x)
    out_eval = jax.jit(lambda v, x: bn.apply(v, x, use_running_average=True))(v, x)
    layer = TL.BatchNorm(8, device="cpu")
    layer.load_state_dict({
        "weight": torch.from_numpy(v["params"]["scale"]),
        "bias": torch.from_numpy(v["params"]["bias"]),
        "running_mean": torch.from_numpy(v["batch_stats"]["mean"]),
        "running_var": torch.from_numpy(v["batch_stats"]["var"]),
        "num_batches_tracked": torch.tensor(0)})
    with torch.no_grad():
        layer.eval()
        _close(_nhwc(layer(_nchw(x))), out_eval, "eval")
        layer.train()
        stats = [t.clone() for t in (layer.running_mean, layer.running_var)]
        _close(_nhwc(layer(_nchw(x))), out, "train, no update")
        assert all(torch.equal(a, b) for a, b in
                   zip(stats, (layer.running_mean, layer.running_var)))
        _close(_nhwc(layer(_nchw(x), update_stats=True)), out, "train, update")
    np.testing.assert_allclose(layer.running_mean.numpy(), new["batch_stats"]["mean"],
                               atol=STAT_TOL)
    np.testing.assert_allclose(layer.running_var.numpy(), new["batch_stats"]["var"],
                               atol=STAT_TOL)
    assert int(layer.num_batches_tracked) == 1


# --- blocks -----------------------------------------------------------------

BLOCKS = {
    "gblock_up": (lambda: JL.GBlock(16, upsample=True),
                  lambda: TL.GBlock(8, 16, True, device="cpu"), (BS, 4, 4, 8)),
    "gblock_same": (lambda: JL.GBlock(8), lambda: TL.GBlock(8, 8, device="cpu"), (BS, 4, 4, 8)),
    "dblock_down": (lambda: JL.DBlock(16, downsample=True),
                    lambda: TL.DBlock(8, 16, True, device="cpu"), (BS, 8, 8, 8)),
    "dblock_same": (lambda: JL.DBlock(8), lambda: TL.DBlock(8, 8, device="cpu"), (BS, 8, 8, 8)),
    "dblock_optimized": (lambda: JL.DBlockOptimized(16),
                         lambda: TL.DBlockOptimized(3, 16, device="cpu"), (BS, 8, 8, 3)),
}


def _port_block(name, v, port_cls):
    if name.startswith("gblock"):
        sd = jax_params.sngan_generator_state_dict(
            {"params": {"GBlock_0": v["params"]}, "batch_stats": {"GBlock_0": v["batch_stats"]}})
        prefix = "block2."
    else:
        head = "DBlockOptimized_0" if name == "dblock_optimized" else "DBlock_0"
        sd = jax_params.sngan_discriminator_state_dict(
            {"params": {head: v["params"]}, "spectral": {head: v["spectral"]}})
        prefix = "block1." if head == "DBlockOptimized_0" else "block2."
    block = port_cls()
    block.load_state_dict(_strip(sd, prefix))
    return block


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_flax(name):
    jax_cls, port_cls, shape = BLOCKS[name]
    mod = jax_cls()
    x = _normal(6, *shape)
    if name.startswith("gblock"):
        v = randomize(jax.jit(lambda k: mod.init({"params": k}, jnp.zeros(shape), train=True))(
            jax.random.key(1)), 1)
        out, new = jax.jit(lambda v, x: mod.apply(v, x, train=True, mutable=["batch_stats"]))(v, x)
        out_eval = jax.jit(lambda v, x: mod.apply(v, x, train=False))(v, x)
        block = _port_block(name, v, port_cls)
        with torch.no_grad():
            block.eval()
            _close(_nhwc(block(_nchw(x))), out_eval, f"{name} eval")
            block.train()
            _close(_nhwc(block(_nchw(x), update_stats=True)), out, f"{name} train")
        want = new["batch_stats"]
        for bn, key in ((block.b1, "BatchNorm_0"), (block.b2, "BatchNorm_1")):
            np.testing.assert_allclose(bn.running_mean.numpy(), want[key]["mean"], atol=STAT_TOL)
            np.testing.assert_allclose(bn.running_var.numpy(), want[key]["var"], atol=STAT_TOL)
    else:
        v = randomize(jax.jit(lambda k: mod.init({"params": k}, jnp.zeros(shape)))(
            jax.random.key(1)), 1)
        out, new = jax.jit(lambda v, x: mod.apply(v, x, update_stats=True,
                                                  mutable=["spectral"]))(v, x)
        block = _port_block(name, v, port_cls)
        with torch.no_grad():
            _close(_nhwc(block(_nchw(x), update_stats=True)), out, name)
        want = _spectral_leaves(new["spectral"])
        got = {k: t.numpy() for k, t in block.state_dict().items() if k.endswith("weight_u")}
        assert len(got) == len(want)
        for (layer, var), u in zip(sorted(want.items()), sorted(got.items())):
            np.testing.assert_allclose(u[1], var["u"].reshape(-1), atol=STAT_TOL, err_msg=layer)


# --- whole models -------------------------------------------------------------

MODELS = {
    "32": (functools.partial(J.SNGANGenerator32, ngf=32),
           functools.partial(T.SNGANGenerator32, ngf=32),
           functools.partial(J.SNGANDiscriminator32, ndf=32),
           functools.partial(T.SNGANDiscriminator32, ndf=32), 32),
    "64": (functools.partial(J.SNGANGenerator64, ngf=32),
           functools.partial(T.SNGANGenerator64, ngf=32),
           functools.partial(J.SNGANDiscriminator64, ndf=32),
           functools.partial(T.SNGANDiscriminator64, ndf=32), 64),
}


@functools.cache
def jax_generator(size):
    gen = MODELS[size][0]()
    v = jax.jit(lambda k: gen.init({"params": k}, jnp.zeros((2, NZ)), train=True))(
        jax.random.key(2))
    return gen, randomize(v, 2)


@functools.cache
def jax_discriminator(size, seed=3):
    disc = MODELS[size][2]()
    res = MODELS[size][4]
    v = jax.jit(lambda k: disc.init({"params": k}, jnp.zeros((2, res, res, 3))))(
        jax.random.key(seed))
    return disc, randomize(v, seed)


def port_generator(size, v):
    g = MODELS[size][1](device="cpu")
    g.load_state_dict(jax_params.sngan_generator_state_dict(v))
    return g


def port_discriminator(size, v):
    d = MODELS[size][3](device="cpu")
    d.load_state_dict(jax_params.sngan_discriminator_state_dict(v))
    return d


@pytest.mark.parametrize("size", sorted(MODELS))
def test_generator_matches_flax(size):
    """Eval mode, then train mode with the running statistics moved by one
    forward (momentum 0.99, biased variance), as the G update does."""
    gen, v = jax_generator(size)
    z = _normal(7, BS, NZ)
    out_eval = jax.jit(lambda v, z: gen.apply(v, z, train=False))(v, z)
    out, new = jax.jit(lambda v, z: gen.apply(v, z, train=True, mutable=["batch_stats"]))(v, z)
    g = port_generator(size, v)
    with torch.no_grad():
        g.eval()
        got = g(torch.from_numpy(z))
        assert got.shape == (BS, int(size), int(size), 3)
        _close(got.numpy(), out_eval, "G eval")
        g.train()
        _close(g(torch.from_numpy(z), update_stats=True).numpy(), out, "G train")
    _, stats = MI.import_mimicry_generator({k: t.numpy() for k, t in g.state_dict().items()})
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(new["batch_stats"])[0],
                                 jax.tree_util.tree_leaves(stats["batch_stats"])):
        np.testing.assert_allclose(got, want, atol=STAT_TOL, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("size", sorted(MODELS))
def test_discriminator_matches_flax(size):
    """Logits, pooled features and the local map; u after one forward with
    update_stats, and unchanged without (eval closures and logit sweeps)."""
    disc, v = jax_discriminator(size)
    res = MODELS[size][4]
    x = np.tanh(_normal(8, BS, res, res, 3))
    (logits, aux), new = jax.jit(lambda v, x: disc.apply(v, x, update_stats=True,
                                                         mutable=["spectral"]))(v, x)
    logits_eval, _ = jax.jit(lambda v, x: disc.apply(v, x, update_stats=False, train=False))(v, x)
    d = port_discriminator(size, v)
    u0 = {k: t.clone() for k, t in d.state_dict().items() if k.endswith("weight_u")}
    with torch.no_grad():
        d.eval()
        got_eval, _ = d(torch.from_numpy(x))
        assert all(torch.equal(t, d.state_dict()[k]) for k, t in u0.items())
        d.train()
        got, got_aux = d(torch.from_numpy(x), update_stats=True)
    _close(got_eval.numpy(), logits_eval, "D eval")
    _close(got.numpy(), logits, "D logits")
    _close(got_aux["features"].numpy(), aux["features"], "D features")
    _close(got_aux["local"].numpy(), aux["local"], "D local")
    _, spectral = MI.import_mimicry_discriminator({k: t.numpy() for k, t in d.state_dict().items()})
    want = _spectral_leaves(new["spectral"])
    got_u = _spectral_leaves(spectral["spectral"])
    assert sorted(want) == sorted(got_u)
    for layer in want:
        np.testing.assert_allclose(got_u[layer]["u"], want[layer]["u"], atol=STAT_TOL,
                                   err_msg=str(layer))


# --- the bridge, both ways ----------------------------------------------------

@pytest.mark.parametrize("size", sorted(MODELS))
def test_bridge_round_trip_through_mimicry_import(size):
    """JAX -> port state_dict -> the JAX package's torch-mimicry importer ->
    JAX: every leaf equal; sigma, which the port does not store, is the
    importer's recomputation from (W, u) on both sides."""
    for (_, jax_var), (bridge, importer, coll) in (
            (jax_generator(size), (jax_params.sngan_generator_state_dict,
                                   MI.import_mimicry_generator, "batch_stats")),
            (jax_discriminator(size), (jax_params.sngan_discriminator_state_dict,
                                       MI.import_mimicry_discriminator, "spectral"))):
        sd = {k: t.numpy() for k, t in bridge(jax_var).items()}
        params, colls = importer(sd)
        for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(jax_var["params"])[0],
                                     jax.tree_util.tree_leaves(params)):
            np.testing.assert_array_equal(got, want, err_msg=jax.tree_util.keystr(path))
        if coll == "batch_stats":
            for want, got in zip(jax.tree_util.tree_leaves(jax_var[coll]),
                                 jax.tree_util.tree_leaves(colls[coll])):
                np.testing.assert_array_equal(got, want)
            continue
        want_sn, got_sn = _spectral_leaves(jax_var[coll]), _spectral_leaves(colls[coll])
        for layer, w in want_sn.items():
            np.testing.assert_array_equal(got_sn[layer]["u"], w["u"])
            # sigma recomputed from the same (W, u) by the importer
            again = _spectral_leaves(importer(sd)[1][coll])[layer]["sigma"]
            np.testing.assert_array_equal(got_sn[layer]["sigma"], again)


def test_bridge_raises_on_unknown_leaves():
    _, v = jax_discriminator("32")
    bad = {"params": {**v["params"], "Extra_0": {"kernel": np.zeros((2, 2), np.float32)}},
           "spectral": v["spectral"]}
    with pytest.raises(ValueError, match="Extra_0"):
        jax_params.sngan_discriminator_state_dict(bad)
    _, gv = jax_generator("32")
    bad = {"params": gv["params"], "batch_stats": {**gv["batch_stats"],
                                                   "BatchNorm_0": {"mean": np.zeros(3),
                                                                   "scale": np.zeros(3)}}}
    with pytest.raises(ValueError, match="scale"):
        jax_params.sngan_generator_state_dict(bad)
