"""The port's MNIST DCGAN and toy MLPs (diagan_tpu_torch.models.{mnist_dcgan,
toy}) against the JAX package's Flax modules, on the CPU, at their own
widths (G 384/192/96/48, D 16-512; the toy's 256).

The same Flax variables go to both sides, the port's through the weight
bridge (utils/jax_params.py), with biases, BatchNorm scales/biases and
running statistics made random so that each matters; the same numpy inputs
go to both. D's dropout: the JAX side's six keep masks are recorded from
jax.random.bernoulli while the train-mode apply is traced, and handed to the
port's D (NHWC -> NCHW). Cases: G and D in train and eval mode, D with
num_pack 1 and 2 and use_sn off and on, nc 3 (Colored-MNIST) and 1
(MNIST-FMNIST); the toy G and D, use_sn off and on. Tolerances (fp32):
outputs within 1e-5 x max(1, max|out|); BatchNorm running statistics and the
spectral norm's u after one train-mode forward (update_stats) within 1e-6.
The bridge: a port state_dict -> the JAX package's torch importer
(utils/torch_import.py import_mnist_dcgan_*) -> Flax -> the bridge gives the
same tensors back, bit for bit.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_port_sngan_models import randomize  # noqa: E402

from diagan_tpu.models import mnist_dcgan as J  # noqa: E402
from diagan_tpu.models import toy as JT  # noqa: E402
from diagan_tpu.utils import torch_import as TI  # noqa: E402
from diagan_tpu_torch.models import mnist_dcgan as T  # noqa: E402
from diagan_tpu_torch.models import toy as TT  # noqa: E402
from diagan_tpu_torch.utils import jax_params  # noqa: E402

NZ, BS = 100, 4
STAT_TOL = 1e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch (see test_torch_port_sngan_models.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, what, tol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())), err_msg=what)


def normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def recording_masks(fn, *args):
    """(fn(*args), [keep masks]) with fn jitted: every jax.random.bernoulli
    draw made while fn is traced, in call order, as numpy arrays."""
    seen, bernoulli = [], jax.random.bernoulli

    def record(*a, **k):
        seen.append(bernoulli(*a, **k))
        return seen[-1]

    def wrapped(*args):
        seen.clear()
        out = fn(*args)
        return out, list(seen)

    jax.random.bernoulli = record
    try:
        out, masks = jax.jit(wrapped)(*args)
    finally:
        jax.random.bernoulli = bernoulli
    return jax.device_get(out), [np.asarray(m) for m in masks]


def nchw_masks(masks):
    return [torch.from_numpy(np.ascontiguousarray(m.transpose(0, 3, 1, 2))) for m in masks]


def flax_variables(module, seed, *example, **kwargs):
    """Seeded numpy variables in the shapes module.init gives (taken with
    jax.eval_shape: no compile): kernels N(0, 0.02) as the JAX package's init
    (Xavier-like 1 / sqrt(fan_in) for SN kernels, as their init scales), u
    N(0, 1), sigma 1; then randomize's biases, scales and statistics."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(0)}, *example, **kwargs))

    def fill(path, leaf):
        keys = [str(getattr(p, "key", p)) for p in path]
        if keys[-1] == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            std = 1 / np.sqrt(fan_in) if any(k.startswith("SN") for k in keys) else 0.02
            return (std * rng.standard_normal(leaf.shape)).astype(np.float32)
        if keys[-1].endswith("/sigma"):
            return np.ones(leaf.shape, np.float32)
        return rng.standard_normal(leaf.shape).astype(np.float32)

    return randomize(jax.tree_util.tree_map_with_path(fill, shapes), seed)


@functools.cache
def jax_dcgan_g(nc=3, seed=2):
    gen = J.MNISTDCGANGenerator(nc=nc)
    return gen, flax_variables(gen, seed, jnp.zeros((2, NZ)), train=True)


@functools.cache
def jax_dcgan_d(nc=3, num_pack=1, use_sn=False, seed=3):
    disc = J.MNISTDCGANDiscriminator(nc=nc, num_pack=num_pack, use_sn=use_sn)
    return disc, flax_variables(disc, seed, jnp.zeros((2 * num_pack, 32, 32, nc)))


def port_dcgan_g(v, nc=3):
    g = T.MNISTDCGANGenerator(nc=nc, device="cpu")
    g.load_state_dict(jax_params.mnist_dcgan_generator_state_dict(v))
    return g


def port_dcgan_d(v, nc=3, num_pack=1, use_sn=False):
    d = T.MNISTDCGANDiscriminator(nc=nc, num_pack=num_pack, use_sn=use_sn, device="cpu")
    d.load_state_dict(jax_params.mnist_dcgan_discriminator_state_dict(v))
    return d


def stats(sd, keys=("running_mean", "running_var", "weight_u")):
    return {k: t.detach().numpy().copy() for k, t in sd.items() if k.endswith(keys)}


@pytest.mark.parametrize("nc", [3, 1])
def test_generator_matches_flax(nc):
    """Eval mode, then train mode with the running statistics moved by one
    forward (the G update's), and a train-mode forward that moves nothing
    (the fakes of a D update)."""
    gen, v = jax_dcgan_g(nc)
    z = normal(7, BS, NZ)
    out_eval = jax.jit(lambda v, z: gen.apply(v, z, train=False))(v, z)
    out, new = jax.jit(lambda v, z: gen.apply(v, z, train=True, mutable=["batch_stats"]))(v, z)
    g = port_dcgan_g(v, nc)
    before = stats(g.state_dict())
    with torch.no_grad():
        got_eval = g.eval()(torch.from_numpy(z))
        g.train()
        got_fakes = g(torch.from_numpy(z))
        assert all(np.array_equal(t, before[k]) for k, t in stats(g.state_dict()).items())
        got = g(torch.from_numpy(z), update_stats=True)
    assert got.shape == (BS, 32, 32, nc)
    close(got_eval.numpy(), out_eval, "G eval")
    close(got_fakes.numpy(), out, "G train (fakes)")
    close(got.numpy(), out, "G train")
    want = {k: t.numpy() for k, t in
            jax_params.mnist_dcgan_generator_state_dict({**v, **jax.device_get(new)}).items()}
    for k, t in stats(g.state_dict()).items():
        np.testing.assert_allclose(t, want[k], atol=STAT_TOL, err_msg=k)


D_CASES = {"colour": (3, 1, False), "colour_pack2": (3, 2, False), "colour_sn": (3, 1, True),
           "gray_pack2_sn": (1, 2, True)}


@pytest.mark.parametrize("case", sorted(D_CASES))
def test_discriminator_matches_flax(case):
    """Eval mode; train mode with the JAX masks injected: logits, features
    (NHWC flatten on the JAX side, NCHW on the port's) and, after the
    update_stats forward, the running statistics and u; a train-mode forward
    without update_stats (the logit sweep's) moves nothing."""
    nc, num_pack, use_sn = D_CASES[case]
    disc, v = jax_dcgan_d(nc, num_pack, use_sn)
    n = BS * num_pack
    x = np.tanh(normal(8, n, 32, 32, nc))
    colls = ["batch_stats"] + (["spectral"] if use_sn else [])
    logits_eval, _ = jax.jit(lambda v, x: disc.apply(v, x, update_stats=False, train=False))(v, x)
    ((logits, aux), new), masks = recording_masks(
        lambda v, x: disc.apply(v, x, update_stats=True, train=True, mutable=colls,
                                rngs={"dropout": jax.random.key(5)}), v, x)
    d = port_dcgan_d(v, nc, num_pack, use_sn)
    shapes = d.dropout_shapes(n)
    assert [m.shape for m in nchw_masks(masks)] == [torch.Size(s) for s in shapes]
    before = stats(d.state_dict())
    with torch.no_grad():
        got_eval, _ = d.eval()(torch.from_numpy(x))
        d.train()
        got_sweep, _ = d(torch.from_numpy(x), dropout_masks=nchw_masks(masks))
        assert all(np.array_equal(t, before[k]) for k, t in stats(d.state_dict()).items())
        got, got_aux = d(torch.from_numpy(x), update_stats=True, dropout_masks=nchw_masks(masks))
    assert got.shape == (BS,)
    close(got_eval.numpy(), logits_eval, f"{case} D eval")
    close(got_sweep.numpy(), logits, f"{case} D train, no update")
    close(got.numpy(), logits, f"{case} D train")
    feat = aux["features"].reshape(BS, 4, 4, 512).transpose(0, 3, 1, 2).reshape(BS, -1)
    close(got_aux["features"].numpy(), feat, f"{case} D features")
    want = {k: t.numpy() for k, t in
            jax_params.mnist_dcgan_discriminator_state_dict({**v, **jax.device_get(new)}).items()}
    after = stats(d.state_dict())
    assert len(after) == (10 + (6 if use_sn else 0))
    for k, t in after.items():
        np.testing.assert_allclose(t, want[k], atol=STAT_TOL, err_msg=f"{case} {k}")


@pytest.mark.parametrize("use_sn", [False, True], ids=["plain", "sn"])
def test_toy_models_match_flax(use_sn):
    gen, disc = JT.ToyGenerator(), JT.ToyDiscriminator(use_sn=use_sn)
    gv, dv = flax_variables(gen, 0, jnp.zeros((2, 2))), flax_variables(disc, 1, jnp.zeros((2, 2)))
    z, x = normal(2, 16, 2), normal(3, 16, 2)
    pts = jax.jit(lambda v, z: gen.apply(v, z))(gv, z)
    (logits, aux), new = jax.jit(lambda v, x: disc.apply(
        v, x, update_stats=True, mutable=["spectral"] if use_sn else []))(dv, x)
    g = TT.ToyGenerator(device="cpu")
    g.load_state_dict(jax_params.toy_generator_state_dict(gv))
    d = TT.ToyDiscriminator(use_sn=use_sn, device="cpu")
    d.load_state_dict(jax_params.toy_discriminator_state_dict(dv))
    with torch.no_grad():
        got_pts = g(torch.from_numpy(z))
        got, got_aux = d(torch.from_numpy(x), update_stats=True)
    close(got_pts.numpy(), pts, "toy G")
    close(got.numpy(), logits, "toy D")
    close(got_aux["features"].numpy(), aux["features"], "toy D features")
    if use_sn:
        want = jax_params.toy_discriminator_state_dict({**dv, **jax.device_get(new)})
        for k, t in stats(d.state_dict()).items():
            np.testing.assert_allclose(t, want[k].numpy(), atol=STAT_TOL, err_msg=k)
    assert sorted(g.state_dict()) == [f"fc{i}.{p}" for i in range(4) for p in ("bias", "weight")]


def reference_layout(sd):
    """The port D's state_dict in the reference's layout: torch's
    spectral_norm stores weight_orig, weight_u and weight_v per SN conv (v =
    l2n(W^T u), what the next power iteration starts from)."""
    out = {}
    for k, t in sd.items():
        a = t.numpy()
        if k.endswith(".weight_u"):
            stem = k[:-len(".weight_u")]
            w = sd[f"{stem}.weight"].numpy().reshape(a.shape[0], -1)
            v = a @ w
            out[f"{stem}.weight_v"] = v / np.sqrt((v * v).sum() + 1e-12)
            out[k] = a
        elif k.endswith(".weight") and f"{k[:-len('.weight')]}.weight_u" in sd:
            out[f"{k}_orig"] = a
        else:
            out[k] = a
    return out


@pytest.mark.parametrize("nc,num_pack,use_sn", [(3, 1, False), (1, 2, True)])
def test_bridge_round_trip_through_torch_import(nc, num_pack, use_sn):
    """port state_dict -> import_mnist_dcgan_* -> Flax -> the bridge: the same
    tensors, bit for bit (sigma, which the port does not store, is dropped)."""
    torch.manual_seed(4)
    for port, importer, bridge in (
            (T.MNISTDCGANGenerator(nc=nc, device="cpu"), TI.import_mnist_dcgan_generator,
             jax_params.mnist_dcgan_generator_state_dict),
            (T.MNISTDCGANDiscriminator(nc=nc, num_pack=num_pack, use_sn=use_sn, device="cpu"),
             TI.import_mnist_dcgan_discriminator,
             jax_params.mnist_dcgan_discriminator_state_dict)):
        with torch.no_grad():  # move the running statistics off their init
            for k, t in port.state_dict().items():
                if k.endswith(("running_mean", "running_var")):
                    t.add_(torch.rand(t.shape))
        sd = port.state_dict()
        params, colls = importer(reference_layout(sd))
        back = bridge({"params": params, **colls})
        assert sorted(back) == sorted(sd)
        for k, t in sd.items():
            assert back[k].dtype == t.dtype and torch.equal(back[k], t), k


def test_bridge_raises_on_unknown_leaves():
    _, v = jax_dcgan_d()
    bad = {**v, "params": {**v["params"], "Extra_0": {"kernel": np.zeros((2, 2), np.float32)}}}
    with pytest.raises(ValueError, match="Extra_0"):
        jax_params.mnist_dcgan_discriminator_state_dict(bad)
    _, gv = jax_dcgan_g()
    bad = {**gv, "params": {**gv["params"], "ConvTranspose_4": {"kernel": np.zeros((4, 4, 1, 1))}}}
    with pytest.raises(ValueError, match="ConvTranspose_4"):
        jax_params.mnist_dcgan_generator_state_dict(bad)


# --- the train-mode logit sweep -----------------------------------------------

def test_train_mode_sweep_matches_the_jax_recorder():
    """The phase-1 sweep of the MNIST scripts (save_eval_logits=False), at
    batch 64 (the trainer's is 256) on 100 images: a full batch and one of
    36, padded to 64 with copies of image 0: the JAX recorder through the JAX trainer's own sweep forward
    (LogTrainer._get_record_fwd: batch statistics, running ones untouched,
    dropout keyed fold_in(fold_in(key(seed + 2), step), batch)) against the
    port's recorder with each batch's JAX masks (recorded from a D apply
    with that batch's key), within 1e-5 x max(1, max|logit|). D's state does
    not move; the same sweep without the padding gives other logits in the
    last batch."""
    from types import SimpleNamespace

    from diagan_tpu.train.logit_recorder import LogitRecorder as JaxRecorder
    from diagan_tpu.train.trainer import LogTrainer as JaxTrainer
    from diagan_tpu_torch.data.arrays import ArrayDataset
    from diagan_tpu_torch.data.pipeline import DeviceDataSource
    from diagan_tpu_torch.data.synthetic import synthetic_natural
    from diagan_tpu_torch.train.logit_recorder import LogitRecorder

    n, bs, seed, step = 100, 64, 1, 40
    images = synthetic_natural(n, 32, seed=12)[0]
    disc, v = jax_dcgan_d()
    fake = SimpleNamespace(train_drs=False, bundle=SimpleNamespace(disc=disc),
                           save_eval_logits=False, _record_fwd=None)
    fwd = JaxTrainer._get_record_fwd(fake)
    assert fake._record_name == "netD_train"
    key = JaxTrainer._sweep_key(SimpleNamespace(seed=seed), step)
    state = {k: v[k] for k in v if k != "params"}
    jrec = JaxRecorder(n, 2, batch_size=bs)
    jrec.record(fwd, v["params"], state, jnp.asarray(images), step, key=key)
    want = np.asarray(jrec.buffer[0])

    x = images.astype(np.float32) / 127.5 - 1.0
    batches = [x[:bs], np.concatenate([x[bs:], np.repeat(x[:1], 2 * bs - n, 0)])]
    masks = [recording_masks(lambda v, xb, k: fwd(v["params"], state, xb, k), v, xb,
                             jax.random.fold_in(key, b))[1] for b, xb in enumerate(batches)]
    d = port_dcgan_d(v)
    before = {k: t.clone() for k, t in d.state_dict().items()}
    rec = LogitRecorder(n, 2, batch_size=bs, device="cpu")
    source = DeviceDataSource(ArrayDataset.from_images(images), device="cpu")
    rec.record(d, source, step, train=True, dropout_masks=lambda b, shapes: nchw_masks(masks[b]))
    close(rec.buffer[0].numpy(), want, "train-mode sweep")
    assert all(torch.equal(t, d.state_dict()[k]) for k, t in before.items())
    assert d.training  # the sweep restores the module's mode
    with torch.no_grad():  # the last batch unpadded: other batch statistics
        short, _ = d(torch.from_numpy(x[bs:]), dropout_masks=[m[:n - bs] for m in
                                                             nchw_masks(masks[1])])
    assert np.abs(short.numpy() - want[bs:]).max() > 1e-3
