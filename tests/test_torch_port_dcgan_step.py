"""The port's fused train step on the MNIST DCGAN and the toy MLPs
(diagan_tpu_torch/train/steps.py) against the JAX package's
(diagan_tpu/train/steps.py make_fused_step), on the CPU, at the models' own
widths.

One fused step (n_dis 2, batch 4) on the same Flax weights (bridged), the
same data and the same injected draws: the JAX step's index and latent draws
and its dropout masks (jax.random.bernoulli) are patched while it traces to
return numpy arrays that the port's step takes through its draws object. The
cases: phase 1 (ns loss); phase 2 with the twin DRS D and GOLD active
(MNIST-FMNIST's one channel); top-k (hinge); PacGAN (num_pack 2); and the
toy's phase-1 and phase-2 steps (the latter with the twin DRS D) on
25-Gaussians points. Each Adam update's gradients are recorded
on both sides (an optax wrapper that keeps them; an optimizer pre-hook).

Both packages take every ReLU and LeakyReLU decision of the step, in call
order, from one float64 run of the port (patched torch F.relu /
F.leaky_relu and flax.linen.relu / leaky_relu): a pre-activation within fp32
round-off of zero would otherwise take a different side in each package.

The step runs at lr 0 for the gradient check, and at the scripts' lr 1e-4
for the parameters. Adam's first update moves a weight by about lr whatever
the size of its gradient, so a gradient that is zero up to round-off takes
that step in either direction in each package; at lr 1e-4 the weights of
D's second update and of G's update then differ by 2e-4 in such entries,
and their gradients by up to 1e-4 of their max (seen here: netD's second
update, conv.15; G after two D updates, tconv.0). At lr 0 every update's
gradients come from the same weights on both sides.

Tolerances (fp32): losses and metrics rtol 1e-4; every update's gradients
atol 1e-5 x max(1, max|g|) + rtol 1e-3; BatchNorm running statistics after
the step at 1e-6; at lr 1e-4, the first D update's gradients as above and
the parameters after the step at atol 1e-6 wherever every update's |g|
exceeds 1e-4 x max|g| of its tensor (elsewhere a round-off-sized gradient
takes Adam's first step either way).

Two rules of the JAX step are held on their own: every D forward of an
iteration (D(real), D(fake), both of the DRS D and the G step's) sees the
same six dropout masks, recorded from the JAX step, which differ between
iterations; and D's BatchNorm running statistics move on the G step's
D(G(z)) too: 2 n_dis + 1 moves on netD, 2 n_dis on netD_drs.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_port_dcgan import (  # noqa: E402
    flax_variables,
    jax_dcgan_d,
    jax_dcgan_g,
    port_dcgan_d,
    port_dcgan_g,
    recording_masks,
)
from test_torch_port_sngan_step import ReluMasks, recording  # noqa: E402

from diagan_tpu.models import toy as JT  # noqa: E402
from diagan_tpu.train import steps as JS  # noqa: E402
from diagan_tpu.train.state import NetState as JNetState  # noqa: E402
from diagan_tpu.train.trainer import _make_tx  # noqa: E402
from diagan_tpu_torch.data.arrays import ArrayDataset  # noqa: E402
from diagan_tpu_torch.data.gaussian import GaussianDataset  # noqa: E402
from diagan_tpu_torch.data.gaussian import build_25gaussian  # noqa: E402
from diagan_tpu_torch.data.pipeline import DeviceDataSource  # noqa: E402
from diagan_tpu_torch.data.synthetic import synthetic_natural  # noqa: E402
from diagan_tpu_torch.models import toy as TT  # noqa: E402
from diagan_tpu_torch.models.mnist_dcgan import MNISTDCGANDiscriminator  # noqa: E402
from diagan_tpu_torch.models.registry import OptSpec  # noqa: E402
from diagan_tpu_torch.train.state import NetState  # noqa: E402
from diagan_tpu_torch.train.steps import StepConfig, make_fused_step  # noqa: E402
from diagan_tpu_torch.utils import jax_params  # noqa: E402

N_DIS, BS, N_DATA, NUM_STEPS = 2, 4, 16, 20
LR = 1e-4  # the MNIST and toy bundles' lr
GOLD_STEP, EPOCH_STEPS = 3, 2  # GOLD on at step 7; top-k rate 0.99 ** 2 -> k = 3 of 4

CASES = {
    # name: (model, nc, loss_type, use_drs, gold, topk, num_pack, global_step)
    "phase1": ("dcgan", 3, "ns", False, False, False, 1, 0),
    "phase2_drs_gold": ("dcgan", 1, "ns", True, True, False, 1, 7),
    "topk": ("dcgan", 3, "hinge", False, False, True, 1, 5),
    "pacgan": ("dcgan", 3, "ns", False, False, False, 2, 0),
    "toy": ("toy", 2, "ns", False, False, False, 1, 0),
    "toy_phase2_drs": ("toy", 2, "ns", True, False, False, 1, 0),
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch (see test_torch_port_sngan_models.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class ActMasks(ReluMasks):
    """ReluMasks for ReLU and LeakyReLU(0.2): records x > 0 of every call in
    order and applies the recorded sides on both packages."""

    def record(self, orig):
        def act(x, *a, **k):
            self.masks.append(x.detach() > 0)
            return orig(x, *a, **k)
        return act

    def torch_leaky(self, x, negative_slope=0.01, inplace=False):
        m = self._next()
        assert m.shape == x.shape, (m.shape, x.shape)
        return torch.where(m, x, negative_slope * x)

    def jax_leaky(self, x, negative_slope=0.01):
        m = self._next().numpy()
        m = m.transpose(0, 2, 3, 1) if m.ndim == 4 else m
        assert m.shape == x.shape, (m.shape, x.shape)
        return jnp.where(m, x, negative_slope * x)


def spec(model, lr):
    return OptSpec(lr, (0.5, 0.9) if model == "dcgan" else (0.5, 0.999))


@functools.cache
def jax_toy(seed):
    gen, disc = JT.ToyGenerator(), JT.ToyDiscriminator()
    x = jnp.zeros((2, 2))
    return gen, flax_variables(gen, seed, x), disc, flax_variables(disc, seed + 1, x)


def jax_nets(case):
    model, nc, *_, num_pack, _ = CASES[case]
    if model == "toy":
        gen, gv, disc, dv = jax_toy(0)
        return gen, gv, disc, dv, jax_toy(4)[3]
    gen, gv = jax_dcgan_g(nc)
    disc, dv = jax_dcgan_d(nc, num_pack)
    return gen, gv, disc, dv, jax_dcgan_d(nc, num_pack, seed=4)[1]


def port_nets(case, variables, dtype):
    model, nc, *_, num_pack, _ = CASES[case]
    gv, dv, drs_v = variables
    if model == "toy":
        g, d, dd = TT.ToyGenerator(device="cpu"), TT.ToyDiscriminator(device="cpu"), \
            TT.ToyDiscriminator(device="cpu")
        g.load_state_dict(jax_params.toy_generator_state_dict(gv))
        d.load_state_dict(jax_params.toy_discriminator_state_dict(dv))
        dd.load_state_dict(jax_params.toy_discriminator_state_dict(drs_v))
    else:
        g, d, dd = (port_dcgan_g(gv, nc), port_dcgan_d(dv, nc, num_pack),
                    port_dcgan_d(drs_v, nc, num_pack))
    return [m.to(dtype) for m in (g, d, dd)]


def data(case):
    model, nc, *_ = CASES[case]
    if model == "toy":
        return build_25gaussian(N_DATA * 25, seed=2)[0][:N_DATA]
    imgs = synthetic_natural(N_DATA, 32, seed=9)[0]
    return imgs if nc == 3 else imgs[..., :1].copy()


def make_draws(case, rng):
    model, nc, _, use_drs, *_, num_pack, _ = CASES[case]
    nz = 2 if model == "toy" else 100
    d = {"real": [rng.integers(0, N_DATA, BS) for _ in range(N_DIS)],
         "z": [rng.standard_normal((BS, nz)).astype(np.float32) for _ in range(N_DIS)],
         "g_z": {N_DIS - 1: rng.standard_normal((BS, nz)).astype(np.float32)},
         "masks": [[]] * N_DIS}
    if use_drs:
        d["drs"] = [rng.integers(0, N_DATA, BS) for _ in range(N_DIS)]
        d["drs_z"] = [rng.standard_normal((BS, nz)).astype(np.float32) for _ in range(N_DIS)]
    if model == "dcgan":
        shapes = MNISTDCGANDiscriminator(nc=nc, num_pack=num_pack, device="meta"
                                         ).dropout_shapes(BS)
        d["masks"] = [[rng.random(s) < 0.5 for s in shapes] for _ in range(N_DIS)]
    return d


class InjectedDraws:
    """The port step's draws object, returning the test's arrays."""

    def __init__(self, draws, dtype=torch.float32):
        self.draws, self.dtype = draws, dtype
        self.mask_calls = []

    def dropout_masks(self, i, shapes, device):
        self.mask_calls.append(i)
        masks = [torch.from_numpy(m) for m in self.draws["masks"][i]]
        assert [tuple(m.shape) for m in masks] == [tuple(s) for s in shapes]
        return masks

    def indices(self, kind, i, source, n):
        return torch.from_numpy(self.draws[kind][i]).long()

    def normal(self, kind, i, n, nz, device):
        return torch.from_numpy(self.draws[kind][i]).to(self.dtype)


class Source(DeviceDataSource):
    def __init__(self, *a, dtype=torch.float32, **k):
        super().__init__(*a, **k)
        self.dtype = dtype

    def gather(self, idx):
        return super().gather(idx).to(self.dtype)


def jax_bernoulli_feed(case, draws):
    """The JAX step's dropout draws in call order: per iteration D(real),
    D(fake), [DRS D(real), DRS D(fake)], [the G step's D], six each."""
    model, _, _, use_drs, *_ = CASES[case]
    if model != "dcgan":
        return iter(())
    feed = []
    for i in range(N_DIS):
        n_fwd = 2 + 2 * use_drs + (i == N_DIS - 1)
        feed += [m.transpose(0, 2, 3, 1) for m in draws["masks"][i]] * n_fwd
    return iter(feed)


def jax_step(case, draws, images, monkeypatch, acts, lr, bernoulli=None):
    model, nc, loss_type, use_drs, gold, topk, num_pack, step = CASES[case]
    gen, gv, disc, dv, drs_v = jax_nets(case)
    betas = spec(model, lr).betas
    cfg = JS.StepConfig(n_dis=N_DIS, batch_size=BS, nz=2 if model == "toy" else 100,
                        loss_type=loss_type, drs_loss_type="ns", model=model, gold=gold,
                        gold_step=GOLD_STEP, topk=topk, epoch_steps=EPOCH_STEPS,
                        use_drs=use_drs, quantized=model != "toy")
    tx_g = recording(_make_tx(lr, betas, NUM_STEPS, None, 1), 1)
    tx_d = recording(_make_tx(lr, betas, NUM_STEPS, None, N_DIS), N_DIS)
    tx_dd = recording(_make_tx(lr, betas, NUM_STEPS, None, N_DIS), N_DIS)

    def state(v, tx):
        colls = {k: v[k] for k in v if k != "params"}
        return JNetState(v["params"], colls, tx.init(v["params"]), jnp.zeros((), jnp.int32))

    g_state, d_state = state(gv, tx_g), state(dv, tx_d)
    dd_state = state(drs_v, tx_dd) if use_drs else None
    real, drs, normals = iter(draws["real"]), iter(draws.get("drs", [])), []
    for i in range(N_DIS):
        normals.append(draws["z"][i])
        if use_drs:
            normals.append(draws["drs_z"][i])
    normals = iter(normals + [draws["g_z"][N_DIS - 1]])
    feed = jax_bernoulli_feed(case, draws)

    def fed_bernoulli(key, p=0.5, shape=None):
        m = next(feed)
        assert m.shape == tuple(shape), (m.shape, shape)
        return jnp.asarray(m)

    monkeypatch.setattr(JS, "_sample_idx", lambda *a: jnp.asarray(next(real), jnp.int32))
    monkeypatch.setattr(JS, "sample_uniform_indices", lambda *a: jnp.asarray(next(drs), jnp.int32))
    monkeypatch.setattr(jax.random, "normal", lambda *a, **k: jnp.asarray(next(normals)))
    if bernoulli != "real":
        monkeypatch.setattr(jax.random, "bernoulli", fed_bernoulli)
    if acts is not None:
        monkeypatch.setattr(flax.linen, "relu", acts.jax_relu)
        monkeypatch.setattr(flax.linen, "leaky_relu", acts.jax_leaky)
    fused = JS.make_fused_step(gen, disc, disc if use_drs else None, tx_g, tx_d,
                               tx_dd if use_drs else None, cfg, N_DATA, N_DATA)
    images_j = jnp.asarray(images)
    args = (g_state, d_state, dd_state, images_j, images_j,
            jnp.zeros(N_DATA) if use_drs else None, jax.random.key(0),
            jnp.asarray(step, jnp.int32))
    if bernoulli == "real":
        out, masks = recording_masks(fused, *args)
    else:
        out, masks = jax.device_get(jax.jit(fused)(*args)), None
        assert next(feed, None) is None  # every fed mask was drawn
    monkeypatch.undo()
    return out, masks


def port_step(case, draws, images, variables, lr, dtype=torch.float32):
    model, nc, loss_type, use_drs, gold, topk, num_pack, step = CASES[case]
    g_m, d_m, dd_m = port_nets(case, variables, dtype)
    g = NetState(g_m, spec(model, lr), NUM_STEPS, None, 1)
    d = NetState(d_m, spec(model, lr), NUM_STEPS, None, N_DIS)
    dd = NetState(dd_m, spec(model, lr), NUM_STEPS, None, N_DIS) if use_drs else None
    grads = {}
    for name, net in (("g", g), ("d", d), ("dd", dd)):
        if net is None:
            continue
        named = list(net.module.named_parameters())
        net.optim.register_step_pre_hook(
            lambda opt, args, kwargs, name=name, named=named: grads.setdefault(name, []).append(
                {k: p.grad.detach().clone() for k, p in named}))
    # D's running statistics at each of its updates (after its two forwards)
    d.optim.register_step_pre_hook(lambda opt, args, kwargs: grads.setdefault("d_stats", []).append(
        {k: t.clone() for k, t in d.module.state_dict().items() if "running" in k}))
    kind = ArrayDataset if model == "dcgan" else GaussianDataset
    ds = kind(images, np.zeros(N_DATA, np.int64), np.zeros(N_DATA, np.int64), np.ones(N_DATA))
    source = Source(ds, weights=np.linspace(0.1, 1.0, N_DATA), device="cpu", dtype=dtype)
    cfg = StepConfig(n_dis=N_DIS, batch_size=BS, nz=2 if model == "toy" else 100,
                     loss_type=loss_type, drs_loss_type="ns", model=model, gold=gold,
                     gold_step=GOLD_STEP, topk=topk, epoch_steps=EPOCH_STEPS, use_drs=use_drs)
    fused = make_fused_step(g, d, dd, cfg, source, Source(ds, device="cpu", dtype=dtype))
    injected = InjectedDraws(draws, dtype)
    metrics = fused(step, injected)
    return metrics, (g, d, dd), grads, injected


def bridges(case):
    if CASES[case][0] == "toy":
        return jax_params.toy_generator_state_dict, jax_params.toy_discriminator_state_dict
    return (jax_params.mnist_dcgan_generator_state_dict,
            jax_params.mnist_dcgan_discriminator_state_dict)


@functools.cache
def run(case, lr):
    """The port's step (its activation sides from a float64 run of its own)
    and the JAX step on the same weights, data, draws and sides."""
    images = data(case)
    draws = make_draws(case, np.random.default_rng(11))
    _, gv, _, dv, drs_v = jax_nets(case)
    variables = (gv, dv, drs_v)
    acts = ActMasks()
    F = torch.nn.functional
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(F, "relu", acts.record(F.relu))
        mp.setattr(F, "leaky_relu", acts.record(F.leaky_relu))
        port_step(case, draws, images, variables, lr, torch.float64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(F, "relu", acts.torch_relu)
        mp.setattr(F, "leaky_relu", acts.torch_leaky)
        ours = port_step(case, draws, images, variables, lr)
    assert acts.used == len(acts.masks)
    acts.used = 0
    with pytest.MonkeyPatch.context() as mp:
        (g_j, d_j, dd_j, m_j), _ = jax_step(case, draws, images, mp, acts, lr)
    assert acts.used == len(acts.masks)
    return ours, (g_j, d_j, dd_j, m_j)


def net_triples(case, ours, theirs):
    (_, (g, d, dd), grads, _), (g_j, d_j, dd_j, _) = ours, theirs
    g_bridge, d_bridge = bridges(case)
    nets = [("g", g, g_j, g_bridge), ("d", d, d_j, d_bridge)]
    if dd is not None:
        nets.append(("dd", dd, dd_j, d_bridge))
    return nets, grads


def check_grads(case, name, net, js, bridge, grads, updates):
    """Each update's gradients (`updates` of them) against the JAX ones;
    returns per tensor where every update's |g| is large."""
    rec = js.opt_state[0]
    assert len(grads[name]) == (1 if name == "g" else N_DIS) == int(js.opt_state[1]) == net.count
    large = {}
    for k in range(len(grads[name])):
        want = {key: t.numpy() for key, t in bridge(
            {"params": jax.tree.map(lambda r: r[k], rec), **js.state}).items()}
        got = grads[name][k]
        want = {key: w for key, w in want.items() if key in got}
        assert len(want) == len(got)
        for key, w in want.items():
            scale = max(1.0, float(np.abs(w).max()))
            if k < updates:
                np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-3, atol=1e-5 * scale,
                                           err_msg=f"{case} {name} update {k} grad {key}")
            big = np.abs(w) > max(1e-4 * np.abs(w).max(), 1e-5 * scale)
            large[key] = large.get(key, True) & big
    return large


def state_after(net, js, bridge):
    want = {k: t.numpy() for k, t in bridge({"params": js.params, **js.state}).items()}
    return {k: t.detach().numpy() for k, t in net.module.state_dict().items()}, want


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_step_matches_jax(case):
    """At lr 0: the metrics, every update's gradients and the running
    statistics after the step."""
    ours, theirs = run(case, 0.0)
    m_t, m_j = ours[0], theirs[3]
    if CASES[case][0] == "dcgan":
        assert ours[3].mask_calls == list(range(N_DIS))  # one mask draw an iteration
    assert set(m_t) == set(m_j), (sorted(m_t), sorted(m_j))
    for k in m_j:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    nets, grads = net_triples(case, ours, theirs)
    for name, net, js, bridge in nets:
        check_grads(case, name, net, js, bridge, grads, updates=N_DIS)
        got, want = state_after(net, js, bridge)
        for key, w in want.items():
            if key.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got[key], w, atol=1e-6, err_msg=f"{name} {key}")


def test_parameters_after_a_step_at_the_scripts_lr():
    """At lr 1e-4: the first D update's gradients, and every parameter entry
    whose gradients are large in every update (see the module docstring)."""
    case = "phase1"
    ours, theirs = run(case, LR)
    nets, grads = net_triples(case, ours, theirs)
    left_out, total = 0, 0
    for name, net, js, bridge in nets:
        large = check_grads(case, name, net, js, bridge, grads, updates=int(name != "g"))
        got, want = state_after(net, js, bridge)
        for key, m in large.items():
            np.testing.assert_allclose(got[key][m], want[key][m], rtol=0, atol=1e-6,
                                       err_msg=f"{name} param {key} after the step")
            left_out, total = left_out + int((~m).sum()), total + m.size
    assert left_out < 0.01 * total, (left_out, total)


def test_every_d_forward_of_an_iteration_shares_its_dropout_masks(monkeypatch):
    """The JAX step's own dropout draws (jax.random.bernoulli, recorded while
    the step traces): in each iteration D(real), D(fake), the DRS D's two
    forwards and the G step's D forward draw the same six masks; the two
    iterations' masks differ. The port's step asks its draws object once an
    iteration and hands those masks to all of these forwards."""
    case = "phase2_drs_gold"
    images = data(case)
    draws = make_draws(case, np.random.default_rng(11))
    _, masks = jax_step(case, draws, images, monkeypatch, None, 0.0, bernoulli="real")
    per_iter = [2 + 2 + (i == N_DIS - 1) for i in range(N_DIS)]
    assert len(masks) == 6 * sum(per_iter)
    it = iter(masks)
    iters = [[[next(it) for _ in range(6)] for _ in range(n)] for n in per_iter]
    for fwds in iters:
        for other in fwds[1:]:
            assert all(np.array_equal(a, b) for a, b in zip(fwds[0], other))
    assert not any(np.array_equal(a, b) for a, b in zip(iters[0][0], iters[1][0]))

    seen = []
    orig = MNISTDCGANDiscriminator.forward

    def spy(self, x, update_stats=False, dropout_masks=None):
        seen.append((id(self), dropout_masks))
        return orig(self, x, update_stats, dropout_masks)

    monkeypatch.setattr(MNISTDCGANDiscriminator, "forward", spy)
    _, gv, _, dv, drs_v = jax_nets(case)
    _, (g, d, dd), _, _ = port_step(case, draws, images, (gv, dv, drs_v), 0.0)
    assert len(seen) == sum(per_iter)
    start = 0
    for i, n in enumerate(per_iter):
        group = seen[start:start + n]
        start += n
        assert all(m is group[0][1] for _, m in group)  # one list of masks, all forwards
        assert all(torch.equal(a, torch.from_numpy(b))
                   for a, b in zip(group[0][1], draws["masks"][i]))
    ids = [who for who, _ in seen]
    assert ids[:4] == [id(d.module)] * 2 + [id(dd.module)] * 2 and ids[-1] == id(d.module)


def test_the_g_step_moves_d_batchnorm_statistics():
    """D's BatchNorm running statistics move on D(real), D(fake) and the G
    step's D(G(z)) (the JAX step keeps new_d_state, steps.py:202,231): 2 n_dis
    + 1 moves on netD, 2 n_dis on netD_drs. After the step they equal the
    JAX step's, and every one of them differs from what it was after the last
    D update, before the G step."""
    case = "phase2_drs_gold"
    ours, theirs = run(case, 0.0)
    _, (g, d, dd), grads, _ = ours
    tracked = {k: int(t) for k, t in d.module.state_dict().items()
               if k.endswith("num_batches_tracked")}
    assert len(tracked) == 5 and set(tracked.values()) == {2 * N_DIS + 1}
    assert {int(t) for k, t in dd.module.state_dict().items()
            if k.endswith("num_batches_tracked")} == {2 * N_DIS}
    got, want = state_after(d, theirs[1], bridges(case)[1])
    before_g = grads["d_stats"][-1]  # after the last D update, before the G step
    assert len(before_g) == 10
    for key, t in before_g.items():
        np.testing.assert_allclose(got[key], want[key], atol=1e-6, err_msg=key)
        assert np.abs(t.numpy() - want[key]).max() > 1e-4, key
