"""The port's Inclusive GAN (diagan_tpu_torch.train.inclusive, the fused
step's g_aux_loss hook, eval.inception.pool3_with_grad and
cli.train_mimicry_inclusive) against the JAX package's, on the CPU, with the
MNIST DCGAN at its own widths (Colored-MNIST, nc 3).

The featurizer is a stand-in: a Flax network of two strided convs and a
mean after the 299 px resize, and its port twin on the same (bridged)
weights; the FID InceptionV3 at 299 is too slow for this tier. Its
`features` returns one fixed numpy array in both packages (the real
features, standardised under random Inception weights). The JAX
InclusiveTrainer runs with LogTrainer.__init__ replaced by one that sets
the attributes it reads, so the JAX package's own refresh, hook and fused
step run unchanged.

  - The refresh with injected latents: at construction (one chunk of 500)
    and with chunks of 50, the chosen latents equal and the squared
    distances within 1e-5 relative.
  - Two fused steps (n_dis 1, batch 4, lr 0, the same injected draws in
    both: index, latent, the hook's two index, two noise and one uniform
    draw, the dropout masks), the JAX steps in the trainer's scanned chunk
    (make_train_chunk): errD, errG, D(x), D(G(z)) at rtol 1e-4; reconsG,
    itpG and every update's G and D gradients within 1e-5 x max(1, max|g|)
    + rtol 1e-3. Every ReLU / LeakyReLU decision, G's, D's and the stand-in's,
    comes from one float64 run of the port.
  - Which G state the hook's forwards read: G's running statistics move on
    every G update, yet the second step's reconsG and itpG equal the first's
    in both packages, and the JAX hook gives the same loss with a G state
    whose running statistics are garbage: gen_fwd applies G in train mode
    (diagan_tpu/train/steps.py:85-97), on batch statistics, so the state the
    JAX jit captures when it traces the hook (inclusive.py:81-91) is read by
    nothing. The port's hook forwards move no running statistic.
  - pool3_with_grad against _resize_for_inception + apply: features and
    their gradients with respect to the image (nc 1 and 3).
  - cli.train_mimicry_inclusive for 4 steps with the refresh hit once (at
    step 3: refresh_multiplier 1, 24 images, batch 8), then
    cli.train_cae_inclusive on its checkpoint; the CLI's stand-in
    featurizer runs at 75 px.
"""
import functools
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen  # noqa: E402
import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_port_cae import run_cae_cli  # noqa: E402
from test_torch_port_dcgan import jax_dcgan_d, jax_dcgan_g, port_dcgan_d, port_dcgan_g  # noqa: E402
from test_torch_port_dcgan_step import ActMasks  # noqa: E402
from test_torch_port_mnist_cli import mnist_dir  # noqa: E402,F401
from test_torch_port_sngan_step import recording  # noqa: E402

from diagan_tpu.train import inclusive as JI  # noqa: E402
from diagan_tpu.train import steps as JS  # noqa: E402
from diagan_tpu.train import trainer as JT  # noqa: E402
from diagan_tpu.train.state import NetState as JNetState  # noqa: E402
from diagan_tpu_torch.cli import train_cae_inclusive, train_mimicry_inclusive  # noqa: E402
from diagan_tpu_torch.data.arrays import ArrayDataset  # noqa: E402
from diagan_tpu_torch.data.pipeline import DeviceDataSource  # noqa: E402
from diagan_tpu_torch.eval import inception as TI  # noqa: E402
from diagan_tpu_torch.models.mnist_dcgan import MNISTDCGANDiscriminator  # noqa: E402
from diagan_tpu_torch.models.registry import OptSpec  # noqa: E402
from diagan_tpu_torch.train import inclusive as TINC  # noqa: E402
from diagan_tpu_torch.train.state import NetState  # noqa: E402
from diagan_tpu_torch.train.steps import StepConfig, make_fused_step  # noqa: E402
from diagan_tpu_torch.utils import plot as TPL  # noqa: E402

N_DATA, BS, NZ, NC, FEAT = 16, 4, 100, 3, 16
LATENT_FACTOR = 10


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch (see test_torch_port_sngan_models.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FlaxStandin(nn.Module):
    """(pool3, logits) of an NHWC image at the network's size."""

    @nn.compact
    def __call__(self, x):
        h = nn.relu(nn.Conv(8, (8, 8), strides=(8, 8), padding="VALID")(x))
        h = nn.relu(nn.Conv(FEAT, (3, 3), strides=(2, 2), padding="VALID")(h))
        pool3 = jnp.mean(h, axis=(1, 2))
        return pool3, nn.Dense(4)(pool3)


class TorchStandin(torch.nn.Module):
    """FlaxStandin in NCHW (eval/inception.py's network interface)."""

    def __init__(self):
        super().__init__()
        self.conv0 = torch.nn.Conv2d(3, 8, 8, stride=8)
        self.conv1 = torch.nn.Conv2d(8, FEAT, 3, stride=2)
        self.fc = torch.nn.Linear(FEAT, 4)

    def forward(self, x):
        F = torch.nn.functional
        h = F.relu(self.conv1(F.relu(self.conv0(x))))
        pool3 = h.mean(dim=(2, 3))
        return pool3, self.fc(pool3)


@functools.cache
def standin_variables(seed=3):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: FlaxStandin().init(jax.random.key(0),
                                                       jnp.zeros((1, 299, 299, 3))))
    return jax.tree.map(lambda s: (0.2 * rng.standard_normal(s.shape)).astype(np.float32),
                        shapes)


def torch_standin(dtype=torch.float32):
    p = standin_variables()["params"]
    m = TorchStandin()
    with torch.no_grad():
        for i, conv in enumerate((m.conv0, m.conv1)):
            conv.weight.copy_(torch.from_numpy(p[f"Conv_{i}"]["kernel"].transpose(3, 2, 0, 1)))
            conv.bias.copy_(torch.from_numpy(p[f"Conv_{i}"]["bias"]))
        m.fc.weight.copy_(torch.from_numpy(p["Dense_0"]["kernel"].T))
        m.fc.bias.copy_(torch.from_numpy(p["Dense_0"]["bias"]))
    return m.to(dtype).requires_grad_(False)


TRAIN_FEATS = np.random.default_rng(4).standard_normal((N_DATA, FEAT)) * 0.3 + 0.5


class JaxFeaturizer:
    model = FlaxStandin()

    def __init__(self):
        self.variables = standin_variables()

    def features(self, images):
        return TRAIN_FEATS


def data():
    from diagan_tpu_torch.data.synthetic import synthetic_natural

    return synthetic_natural(N_DATA, 32, seed=9)[0]


def latent_chunks(rng, n, chunk):
    return [rng.standard_normal((min(chunk, n - s), NZ)).astype(np.float32)
            for s in range(0, n, chunk)]


def feeding(arrays):
    """A stand-in for a jax.random draw returning `arrays` in turn."""
    it = iter(arrays)

    def draw(*a, **k):
        return jnp.asarray(next(it))
    draw.left = it
    return draw


def jax_trainer(monkeypatch, construction_latents):
    """The JAX InclusiveTrainer on the test's G, D, data and featurizer, its
    construction refresh fed `construction_latents`."""
    gen, gv = jax_dcgan_g(NC)
    disc, dv = jax_dcgan_d(NC)
    cfg = JS.StepConfig(n_dis=1, batch_size=BS, nz=NZ, loss_type="ns", drs_loss_type="ns",
                        model="dcgan", gold=False, gold_step=0, topk=False, epoch_steps=4,
                        use_drs=False, quantized=True)
    tx_g = recording(JT._make_tx(0.0, (0.5, 0.9), 10, None, 1), 2)
    tx_d = recording(JT._make_tx(0.0, (0.5, 0.9), 10, None, 1), 2)
    images = data()

    def state(v, tx):
        colls = {k: v[k] for k in v if k != "params"}
        return JNetState(v["params"], colls, tx.init(v["params"]), jnp.zeros((), jnp.int32))

    def base_init(self, *a, **k):
        self.num_data, self.batch_size = N_DATA, BS
        self.source = types.SimpleNamespace(dataset=types.SimpleNamespace(images=images))
        self.bundle = types.SimpleNamespace(nz=NZ, gen=gen)
        self.key, self.global_step = jax.random.key(0), 0
        self.g_state, self.d_state = state(gv, tx_g), state(dv, tx_d)
        self._make_fused_step = lambda g_aux_loss=None: JS.make_fused_step(
            gen, disc, None, tx_g, tx_d, None, cfg, N_DATA, 1, g_aux_loss=g_aux_loss)

    with monkeypatch.context() as mp:
        mp.setattr(JT.LogTrainer, "__init__", base_init)
        mp.setattr(jax.random, "normal", feeding(construction_latents))
        tr = JI.InclusiveTrainer(featurizer=JaxFeaturizer(), latent_factor=LATENT_FACTOR)
    tr.images = images
    return tr


def port_nets(dtype=torch.float32):
    g = port_dcgan_g(jax_dcgan_g(NC)[1], NC).to(dtype)
    d = port_dcgan_d(jax_dcgan_d(NC)[1], NC).to(dtype)
    return g, d


def running_min(chunks):
    """The JAX refresh's host-side running minimum over recorded (d, idx)."""
    best = np.full(N_DATA, np.inf, np.float32)
    for d, _ in chunks:
        best = np.where(d < best, d, best)
    return best


@pytest.mark.parametrize("chunk", [500, 50])
def test_refresh_matches_jax(monkeypatch, chunk):
    """The JAX refresh (its jitted score_chunk recorded) against the port's
    nearest_latents on the same latents."""
    rng = np.random.default_rng(12)
    n = LATENT_FACTOR * N_DATA
    first = latent_chunks(rng, n, 500)
    tr = jax_trainer(monkeypatch, first)
    lat = first if chunk == 500 else latent_chunks(rng, n, chunk)
    seen, score = [], tr._refresh_jit

    def recorded(*a):
        out = score(*a)
        seen.append(jax.device_get(out))
        return out

    with monkeypatch.context() as mp:
        mp.setattr(tr, "_refresh_jit", recorded)
        mp.setattr(jax.random, "normal", feeding(lat))
        tr._refresh_nearest_latents(chunk=chunk)
    want = np.asarray(tr.nearest_latent)
    g, _ = port_nets()
    it = iter(lat)
    got, dist = TINC.nearest_latents(g.train(), torch_standin(),
                                     torch.tensor(TRAIN_FEATS, dtype=torch.float32), n,
                                     lambda k: torch.from_numpy(next(it)), chunk=chunk)
    assert g.training and next(it, None) is None
    assert len(seen) == math.ceil(n / chunk)
    np.testing.assert_array_equal(got.numpy(), want)
    best = running_min(seen)
    np.testing.assert_allclose(dist.numpy(), best, rtol=1e-5)
    if chunk == 50:  # the running minimum kept latents of several chunks
        origin = {min(c for c, (d, _) in enumerate(seen) if d[j] == best[j])
                  for j in range(N_DATA)}
        assert len(origin) > 1


class Draws:
    """The port step's draws object returning the test's arrays; the same
    arrays every step, as the JAX scan's traced draws."""

    def __init__(self, d, dtype):
        self.d, self.dtype = d, dtype
        self.kinds = []

    def dropout_masks(self, i, shapes, device):
        return [torch.from_numpy(m) for m in self.d["masks"]]

    def indices(self, kind, i, source, n):
        self.kinds.append(kind)
        return torch.from_numpy(self.d[kind]).long()

    def normal(self, kind, i, n, nz, device):
        self.kinds.append(kind)
        return torch.from_numpy(self.d[kind]).to(self.dtype)

    def uniform(self, kind, i, n, device):
        self.kinds.append(kind)
        return torch.from_numpy(self.d[kind]).to(self.dtype)


def make_draws(rng):
    shapes = MNISTDCGANDiscriminator(nc=NC, device="meta").dropout_shapes(BS)
    return {"real": rng.integers(0, N_DATA, BS), "z": rng.standard_normal((BS, NZ)),
            "g_z": rng.standard_normal((BS, NZ)),
            "inclusive_idx1": rng.integers(0, N_DATA, BS),
            "inclusive_idx2": rng.integers(0, N_DATA, BS),
            "inclusive_z1": rng.standard_normal((BS, NZ)),
            "inclusive_z2": rng.standard_normal((BS, NZ)),
            "inclusive_alpha": rng.random(BS),
            "masks": [rng.random(s) < 0.5 for s in shapes]}


def port_steps(draws, nearest, dtype, n_steps=2):
    g_m, d_m = port_nets(dtype)
    spec = OptSpec(0.0, (0.5, 0.9))
    g, d = NetState(g_m, spec, 10, None, 1), NetState(d_m, spec, 10, None, 1)
    grads, g_stats = {}, []
    for name, net in (("g", g), ("d", d)):
        named = list(net.module.named_parameters())
        net.optim.register_step_pre_hook(
            lambda opt, args, kwargs, name=name, named=named: grads.setdefault(name, []).append(
                {k: p.grad.detach().clone() for k, p in named}))
    images = data()
    ds = ArrayDataset.from_images(images)
    source = DeviceDataSource(ds, device="cpu")
    source.gather = (lambda gather: lambda idx: gather(idx).to(dtype))(source.gather)
    hook = TINC.InclusiveLoss(torch_standin(dtype), torch.tensor(TRAIN_FEATS, dtype=dtype), BS,
                              NZ)
    hook.nearest_latent = torch.tensor(nearest, dtype=dtype)
    cfg = StepConfig(n_dis=1, batch_size=BS, nz=NZ, loss_type="ns", drs_loss_type="ns",
                     model="dcgan", gold=False, gold_step=0, topk=False, epoch_steps=4,
                     use_drs=False)
    fused = make_fused_step(g, d, None, cfg, source, g_aux_loss=hook)
    metrics, injected = [], Draws(draws, dtype)
    for step in range(n_steps):
        metrics.append(fused(step, injected))
        g_stats.append({k: t.clone() for k, t in g.module.state_dict().items()
                        if "running" in k or "num_batches" in k})
    return metrics, grads, g_stats, injected


def jax_steps(tr, draws, acts, monkeypatch):
    f32 = {k: np.asarray(v, np.float32) if np.asarray(v).dtype == np.float64 else v
           for k, v in draws.items() if k != "masks"}
    masks = [m.transpose(0, 2, 3, 1) for m in draws["masks"]] * 3  # D(real), D(fake), G's D
    with monkeypatch.context() as mp:
        mp.setattr(JS, "_sample_idx", feeding([f32["real"].astype(np.int32)]))
        mp.setattr(jax.random, "normal", feeding([f32[k] for k in (
            "z", "g_z", "inclusive_z1", "inclusive_z2")]))
        mp.setattr(jax.random, "randint", feeding([f32["inclusive_idx1"].astype(np.int32),
                                                   f32["inclusive_idx2"].astype(np.int32)]))
        mp.setattr(jax.random, "uniform", feeding([f32["inclusive_alpha"]]))
        mp.setattr(jax.random, "bernoulli", feeding(masks))
        mp.setattr(flax.linen, "relu", acts.jax_relu)
        mp.setattr(flax.linen, "leaky_relu", acts.jax_leaky)
        chunk = JS.make_train_chunk(tr.fused_step, 2, donate=False)
        images = jnp.asarray(tr.images)
        out = chunk(tr.g_state, tr.d_state, None, images, images, None, jax.random.key(1),
                    jnp.asarray(0, jnp.int32), tr.aux)
        return jax.device_get(out)


@functools.cache
def two_steps():
    """(port fp32 run, JAX run, the port float64 run's activation sides per
    step) of two hooked steps on the same draws and nearest latents."""
    mp = pytest.MonkeyPatch()
    try:
        rng = np.random.default_rng(21)
        tr = jax_trainer(mp, latent_chunks(rng, LATENT_FACTOR * N_DATA, 500))
        nearest = np.asarray(tr.nearest_latent)
        draws = make_draws(rng)
        acts = ActMasks()
        F = torch.nn.functional
        with pytest.MonkeyPatch.context() as p:
            p.setattr(F, "relu", acts.record(F.relu))
            p.setattr(F, "leaky_relu", acts.record(F.leaky_relu))
            port_steps(draws, nearest, torch.float64)
        per_step = len(acts.masks) // 2
        sides = (acts.masks[:per_step], acts.masks[per_step:])
        with pytest.MonkeyPatch.context() as p:
            p.setattr(F, "relu", acts.torch_relu)
            p.setattr(F, "leaky_relu", acts.torch_leaky)
            ours = port_steps(draws, nearest, torch.float32)
        assert acts.used == len(acts.masks)
        jacts = ActMasks()
        jacts.masks = list(sides[0])  # the scan traces its body once
        theirs = jax_steps(tr, draws, jacts, mp)
        assert jacts.used == len(jacts.masks)
        return ours, theirs, sides, tr
    finally:
        mp.undo()


def close(got, want, what, atol=1e-5, rtol=1e-3):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol * max(1.0, float(np.abs(want).max())), err_msg=what)


def test_hooked_steps_match_jax():
    (metrics, grads, _, injected), (g_j, d_j, _, m_j), _, _ = two_steps()
    assert injected.kinds[:7] == ["real", "z", "g_z", "inclusive_idx1", "inclusive_idx2",
                                  "inclusive_z1", "inclusive_z2"]
    assert injected.kinds[7] == "inclusive_alpha"
    for step in range(2):
        assert set(metrics[step]) == set(m_j)
        for k in ("errD", "errG", "D(x)", "D(G(z))"):
            np.testing.assert_allclose(float(metrics[step][k]), float(m_j[k][step]), rtol=1e-4,
                                       err_msg=f"step {step} {k}")
        for k in ("reconsG", "itpG"):
            close(float(metrics[step][k]), float(m_j[k][step]), f"step {step} {k}")
    from diagan_tpu_torch.utils import jax_params as JP

    for name, js, bridge in (("g", g_j, JP.mnist_dcgan_generator_state_dict),
                             ("d", d_j, JP.mnist_dcgan_discriminator_state_dict)):
        rec = js.opt_state[0]
        assert len(grads[name]) == 2 == int(js.opt_state[1])
        for k in range(2):
            want = {key: t.numpy() for key, t in bridge(
                {"params": jax.tree.map(lambda r: r[k], rec), **js.state}).items()}
            for key, got in grads[name][k].items():
                close(got.numpy(), want[key], f"{name} update {k} grad {key}")


def test_the_hook_reads_no_g_running_statistics(monkeypatch):
    (metrics, _, g_stats, _), (g_j, _, _, m_j), sides, tr = two_steps()
    # G's running statistics moved on each G update, and only there
    before = {k: t for k, t in port_dcgan_g(jax_dcgan_g(NC)[1], NC).state_dict().items()
              if k in g_stats[0]}
    for k, t in g_stats[1].items():
        if "num_batches" in k:
            assert int(t) == 2, k
        else:
            assert not torch.equal(t, g_stats[0][k]) and not torch.equal(g_stats[0][k],
                                                                         before[k]), k
    # ... yet nothing the step computes reads them
    assert len(sides[0]) == len(sides[1])
    assert all(torch.equal(a, b) for a, b in zip(*sides))
    for k in ("reconsG", "itpG", "errG"):
        assert float(metrics[0][k]) == float(metrics[1][k]), k
        assert m_j[k][0] == m_j[k][1], k

    # the JAX hook on its own, with the trainer's G state as captured and
    # with garbage running statistics: the same loss
    gen_fwd = JS.make_apply_fns(tr.bundle.gen, None, None)[0]
    rng = np.random.default_rng(3)
    draws = [rng.integers(0, N_DATA, BS).astype(np.int32) for _ in range(2)]
    noise = [rng.standard_normal((BS, NZ)).astype(np.float32) for _ in range(2)]
    alpha = rng.random(BS).astype(np.float32)
    losses, st = [], tr.g_state.state
    for scale in (0.0, 1.0):
        tr.g_state = JNetState(tr.g_state.params, jax.tree.map(
            lambda a: a + scale * (100.0 + 50.0 * np.abs(a)), st), tr.g_state.opt_state,
            tr.g_state.step)
        with monkeypatch.context() as mp:
            mp.setattr(jax.random, "randint", feeding(draws))
            mp.setattr(jax.random, "normal", feeding(noise))
            mp.setattr(jax.random, "uniform", feeding([alpha]))
            # traced anew: the hook captures tr.g_state.state as it is now
            loss = jax.jit(lambda p: tr.g_aux_loss(p, gen_fwd, jax.random.key(0), tr.aux, {}))(
                tr.g_state.params)
        losses.append(float(loss))
    tr.g_state = JNetState(tr.g_state.params, st, tr.g_state.opt_state, tr.g_state.step)
    assert losses[0] == losses[1]

    # the port's hook moves no running statistic
    g, _ = port_nets()
    hook = TINC.InclusiveLoss(torch_standin(), torch.tensor(TRAIN_FEATS, dtype=torch.float32),
                              BS, NZ)
    hook.nearest_latent = torch.tensor(np.asarray(tr.nearest_latent))
    injected = Draws({"inclusive_idx1": draws[0], "inclusive_idx2": draws[1],
                      "inclusive_z1": noise[0], "inclusive_z2": noise[1],
                      "inclusive_alpha": alpha}, torch.float32)
    sd = {k: t.clone() for k, t in g.state_dict().items()}
    m = {}
    got = hook(g.train(), injected, 0, m)
    assert all(torch.equal(t, sd[k]) for k, t in g.state_dict().items())
    close(float(got.detach()), losses[0], "the hook's loss")
    assert set(m) == {"reconsG", "itpG"}


@pytest.mark.parametrize("nc", [1, 3])
def test_pool3_with_grad_matches_jax(nc):
    x = np.tanh(np.random.default_rng(nc).standard_normal((2, 32, 32, nc))).astype(np.float32)
    w = np.random.default_rng(5).standard_normal((2, FEAT)).astype(np.float32)
    v = standin_variables()

    def f(x):
        pool3, _ = FlaxStandin().apply(v, JI._resize_for_inception(x))
        return jnp.sum(pool3 * w), pool3

    (_, want), want_grad = jax.jit(jax.value_and_grad(f, has_aux=True))(x)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    got = TI.pool3_with_grad(torch_standin(), xt)
    (got * torch.from_numpy(w)).sum().backward()
    close(got.detach().numpy(), want, "pool3")
    close(xt.grad.numpy().transpose(0, 2, 3, 1), want_grad, "d pool3 / d x")


def test_simultaneous_g_with_a_hook_raises():
    cfg = StepConfig(n_dis=1, batch_size=BS, nz=NZ, loss_type="ns", drs_loss_type="ns",
                     model="dcgan", gold=False, gold_step=0, topk=False, epoch_steps=4,
                     use_drs=False, simultaneous_g=True)
    with pytest.raises(ValueError, match="simultaneous_g is incompatible"):
        make_fused_step(None, None, None, cfg, None, g_aux_loss=lambda *a: 0.0)


class CliFeaturizer:
    """The CLI test's featurizer: TorchStandin, features an affine of its
    pool3 (as the random-weight fallback standardises)."""

    def __init__(self, device="cpu"):
        self.model = torch_standin()

    def features(self, images):
        with torch.no_grad():
            return self.model(TI.inception_input(images, "cpu"))[0].numpy() * 2.0 - 1.0


def _small_inclusive_cli(monkeypatch):
    """The Inclusive CLI with the stand-in featurizer at 75 px, a refresh
    every epoch and 100 colour samples."""
    monkeypatch.setattr(TI, "INCEPTION_SIZE", 75)
    monkeypatch.setattr(TINC, "InceptionFeaturizer", CliFeaturizer)
    monkeypatch.setattr(train_mimicry_inclusive, "InclusiveTrainer", functools.partial(
        TINC.InclusiveTrainer, refresh_multiplier=1))
    monkeypatch.setattr(train_mimicry_inclusive, "plot_color_mnist_generator",
                        functools.partial(TPL.plot_color_mnist_generator, num_images=100))


def test_inclusive_cli_then_train_cae_inclusive(mnist_dir, monkeypatch):
    _small_inclusive_cli(monkeypatch)
    refreshed = []
    refresh = TINC.InclusiveTrainer.refresh_nearest_latents
    monkeypatch.setattr(TINC.InclusiveTrainer, "refresh_nearest_latents",
                        lambda self, step: refreshed.append(step) or refresh(self, step))
    tr = train_mimicry_inclusive.main(["--device", "cpu", "--num_data", "24", "--batch_size",
                                       "8", "--num_steps", "4", "--logit_save_steps", "2",
                                       "--seed", "3", "--exp_name", "incl"])
    assert tr.refresh_every == 3 and refreshed == [0, 3] and tr.global_step == 4
    m = {k: float(v) for k, v in tr.metrics.items()}
    assert {"reconsG", "itpG", "errG", "errD"} <= set(m) and all(map(math.isfinite, m.values()))
    assert tr.inclusive.nearest_latent.shape == (24, NZ)
    assert sum(tr.channel_counts) == 100
    run = mnist_dir / "exp_results" / "incl"
    assert (run / "logits_netD_train.pkl").is_file()
    assert (run / "eval_inclusive_channel_counts.png").is_file()
    re, used = run_cae_cli(train_cae_inclusive, [
        "-d", "color_mnist", "-r", "dataset/colour_mnist", "--device", "cpu", "--exp_name",
        "incl", "--netG_step", "4", "--epochs", "2", "--batch_size", "32", "--num_data", "24",
        "--seed", "3"], monkeypatch)
    assert used == ["Sampler"] and re.shape == (24, 2) and np.isfinite(re).all()


def test_inclusive_cli_data_parallel_changes_nothing(mnist_dir, monkeypatch):
    """--data_parallel is accepted and changes nothing, as in the root
    train_mimicry_inclusive.py, which never reads it: no process group, and
    the plain run's weights, Adam state, counts and logit rows, bit for bit."""
    _small_inclusive_cli(monkeypatch)
    argv = ["--device", "cpu", "--num_data", "24", "--batch_size", "8", "--num_steps", "4",
            "--logit_save_steps", "2", "--seed", "3"]
    runs = {name: train_mimicry_inclusive.main(argv + ["--exp_name", name] + extra)
            for name, extra in (("plain", []), ("dp", ["--data_parallel"]))}
    state = {}
    for name, tr in runs.items():
        assert tr.dp is None and tr.world == 1
        nets = (tr.g, tr.d)
        state[name] = ([t for n in nets for t in n.module.state_dict().values()]
                       + [t for n in nets for st in n.optim.state.values() for t in st.values()]
                       + [torch.tensor([n.count, n.step]) for n in nets]
                       + [tr.recorder.buffer[:tr.recorder.count], tr.inclusive.nearest_latent])
    assert len(state["plain"]) == len(state["dp"]) > 10
    assert all(torch.equal(a, b) for a, b in zip(state["plain"], state["dp"]))


@pytest.mark.parametrize("entry", [
    lambda: train_mimicry_inclusive.main(["--work_dir", "unused"]),
    lambda: TINC.InclusiveTrainer("unused", None, None, 1),
], ids=["train_mimicry_inclusive_cli", "inclusive_trainer"])
def test_entry_points_without_device_raise_when_no_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
