"""The port's SNGAN fused train step and lr schedule
(diagan_tpu_torch.train.{steps,state}) against the JAX package's
(diagan_tpu/train/steps.py make_fused_step, trainer.py _make_tx).

One fused step (n_dis 2, batch 4, SNGAN-32 at width 32) on the same Flax
weights (bridged), the same uint8 images and the same injected draws: the
JAX step's index and latent draws (`steps._sample_idx`,
`steps.sample_uniform_indices`, `jax.random.normal`) are patched while it
traces to return numpy arrays that the port's step takes through its draws
object. No file of the JAX package changes; the RNGs are never compared.
Each Adam update's gradients are recorded on both sides (an optax wrapper
that keeps them in its state; an optimizer step pre-hook).

Both packages take every ReLU decision of the step (G's and the
discriminators', in call order) from one float64 run of the port: a
pre-activation within fp32 round-off of zero (one at 1.4e-8 turned up on
these inputs) would otherwise take a different side in each package and move
D's input gradient at that unit by ~1%, and with it G's gradients by ~1e-3
of their max. The ReLUs are patched (flax.linen.relu, torch's F.relu) to
apply the recorded masks; a missing or extra ReLU on either side would
misalign the masks and fail.

Tolerances (fp32): losses and metrics rtol 1e-4; gradients atol 1e-5 x
max(1, max|g|) + rtol 1e-3; D's spectral-norm u after the step's 2 n_dis + 1
power iterations and G's running statistics at 1e-6; parameters after the
step at atol 1e-6 wherever every update's |g| exceeds 1e-4 x max|g| of its
tensor and the gradient check's atol (elsewhere a round-off-sized gradient
may take Adam's first step, about lr x sign(g) at b1 = 0, either way: the
bias of a conv that a BatchNorm follows has a zero gradient up to round-off;
the test prints how many entries the rule leaves out).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import flax.linen  # noqa: E402
import optax  # noqa: E402
from test_torch_port_sngan_models import (  # noqa: E402
    jax_discriminator,
    jax_generator,
    port_discriminator,
    port_generator,
)

from diagan_tpu.train import steps as JS  # noqa: E402
from diagan_tpu.train.state import NetState as JNetState  # noqa: E402
from diagan_tpu.train.trainer import _make_tx  # noqa: E402
from diagan_tpu_torch.data.arrays import ArrayDataset  # noqa: E402
from diagan_tpu_torch.data.pipeline import DeviceDataSource  # noqa: E402
from diagan_tpu_torch.data.synthetic import synthetic_natural  # noqa: E402
from diagan_tpu_torch.models.registry import OptSpec  # noqa: E402
from diagan_tpu_torch.train import checkpoint  # noqa: E402
from diagan_tpu_torch.train.state import NetState  # noqa: E402
from diagan_tpu_torch.train.steps import StepConfig, make_fused_step  # noqa: E402
from diagan_tpu_torch.utils import jax_params  # noqa: E402

N_DIS, BS, NZ, N_DATA, NUM_STEPS = 2, 4, 128, 16, 20
LR, BETAS = 2e-4, (0.0, 0.9)

CASES = {
    # name: (loss_type, use_drs, gold, topk, global_step)
    "phase1": ("hinge", False, False, False, 0),
    "phase2": ("hinge", True, False, False, 7),
    "phase2_gold_topk": ("ns", True, True, True, 5),
}
GOLD_STEP, EPOCH_STEPS = 3, 2  # GOLD on at step 5; top-k rate 0.99 ** 2 -> k = 3 of 4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch in these tests: the suite runs test files
    in parallel processes, and torch's default of one thread per core makes
    the processes' small ops wait on each other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def recording(tx, n):
    """tx that also keeps the gradients of its first n updates, stacked."""
    def init(params):
        rec = jax.tree.map(lambda p: jnp.zeros((n,) + p.shape, p.dtype), params)
        return rec, jnp.zeros((), jnp.int32), tx.init(params)

    def update(grads, state, params=None):
        rec, i, inner = state
        rec = jax.tree.map(lambda r, g: r.at[i].set(g), rec, grads)
        updates, inner = tx.update(grads, inner, params)
        return updates, (rec, i + 1, inner)

    return optax.GradientTransformation(init, update)


def _draws(case, rng):
    _, use_drs, *_ = CASES[case]
    d = {"real": [rng.integers(0, N_DATA, BS) for _ in range(N_DIS)],
         "z": [rng.standard_normal((BS, NZ)).astype(np.float32) for _ in range(N_DIS)],
         "g_z": {N_DIS - 1: rng.standard_normal((BS, NZ)).astype(np.float32)}}
    if use_drs:
        d["drs"] = [rng.integers(0, N_DATA, BS) for _ in range(N_DIS)]
        d["drs_z"] = [rng.standard_normal((BS, NZ)).astype(np.float32) for _ in range(N_DIS)]
    return d


class InjectedDraws:
    """The port step's draws object, returning the test's arrays."""

    def __init__(self, draws):
        self.draws = draws

    def indices(self, kind, i, source, n):
        return torch.from_numpy(self.draws[kind][i]).long()

    def normal(self, kind, i, n, nz, device):
        return torch.from_numpy(self.draws[kind][i])


class ReluMasks:
    """Record the ReLU masks of a run (`record`), or apply recorded ones in
    the same call order (`torch_relu`, `jax_relu`, the latter NHWC)."""

    def __init__(self):
        self.masks, self.used = [], 0

    def record(self, orig):
        def relu(x, *a, **k):
            self.masks.append(x.detach() > 0)
            return orig(x)
        return relu

    def _next(self):
        self.used += 1
        return self.masks[self.used - 1]

    def torch_relu(self, x, *a, **k):
        m = self._next()
        assert m.shape == x.shape, (m.shape, x.shape)
        return torch.where(m, x, torch.zeros((), dtype=x.dtype))

    def jax_relu(self, x):
        m = self._next().numpy()
        m = m.transpose(0, 2, 3, 1) if m.ndim == 4 else m
        assert m.shape == x.shape, (m.shape, x.shape)
        return jnp.where(m, x, 0.0)


def _jax_step(case, draws, images, monkeypatch, relu):
    loss_type, use_drs, gold, topk, step = CASES[case]
    gen, gv = jax_generator("32")
    disc, dv = jax_discriminator("32")
    _, drs_v = jax_discriminator("32", seed=4)
    cfg = JS.StepConfig(n_dis=N_DIS, batch_size=BS, nz=NZ, loss_type=loss_type,
                        drs_loss_type="ns", model="sngan", gold=gold, gold_step=GOLD_STEP,
                        topk=topk, epoch_steps=EPOCH_STEPS, use_drs=use_drs, quantized=True)
    tx_g = recording(_make_tx(LR, BETAS, NUM_STEPS, "linear", 1), 1)
    tx_d = recording(_make_tx(LR, BETAS, NUM_STEPS, "linear", N_DIS), N_DIS)
    tx_dd = recording(_make_tx(LR, BETAS, NUM_STEPS, "linear", N_DIS), N_DIS)

    def state(v, tx, coll):
        return JNetState(v["params"], {coll: v[coll]}, tx.init(v["params"]),
                         jnp.zeros((), jnp.int32))

    g_state = state(gv, tx_g, "batch_stats")
    d_state = state(dv, tx_d, "spectral")
    dd_state = state(drs_v, tx_dd, "spectral") if use_drs else None

    real, drs, normals = iter(draws["real"]), iter(draws.get("drs", [])), []
    for i in range(N_DIS):
        normals.append(draws["z"][i])
        if use_drs:
            normals.append(draws["drs_z"][i])
    normals = iter(normals + [draws["g_z"][N_DIS - 1]])
    monkeypatch.setattr(JS, "_sample_idx", lambda *a: jnp.asarray(next(real), jnp.int32))
    monkeypatch.setattr(JS, "sample_uniform_indices", lambda *a: jnp.asarray(next(drs), jnp.int32))
    monkeypatch.setattr(jax.random, "normal", lambda *a, **k: jnp.asarray(next(normals)))
    monkeypatch.setattr(flax.linen, "relu", relu)
    fused = JS.make_fused_step(gen, disc, disc if use_drs else None, tx_g, tx_d,
                               tx_dd if use_drs else None, cfg, N_DATA, N_DATA)
    images_j = jnp.asarray(images)
    out = jax.jit(fused)(g_state, d_state, dd_state, images_j, images_j,
                         jnp.zeros(N_DATA) if use_drs else None, jax.random.key(0),
                         jnp.asarray(step, jnp.int32))
    monkeypatch.undo()
    return jax.device_get(out)


class Source64(DeviceDataSource):
    def gather(self, idx):
        return super().gather(idx).double()


class InjectedDraws64(InjectedDraws):
    def normal(self, kind, i, n, nz, device):
        return super().normal(kind, i, n, nz, device).double()


def _port_step(case, draws, images, variables, dtype=torch.float32):
    loss_type, use_drs, gold, topk, step = CASES[case]
    gv, dv, drs_v = variables
    spec = OptSpec(LR, BETAS)
    g = NetState(port_generator("32", gv).to(dtype), spec, NUM_STEPS, "linear", 1)
    d = NetState(port_discriminator("32", dv).to(dtype), spec, NUM_STEPS, "linear", N_DIS)
    dd = (NetState(port_discriminator("32", drs_v).to(dtype), spec, NUM_STEPS, "linear", N_DIS)
          if use_drs else None)
    grads = {}
    for name, net in (("g", g), ("d", d), ("dd", dd)):
        if net is None:
            continue
        named = list(net.module.named_parameters())
        net.optim.register_step_pre_hook(
            lambda opt, args, kwargs, name=name, named=named: grads.setdefault(name, []).append(
                {k: p.grad.detach().clone() for k, p in named}))
    ds = ArrayDataset.from_images(images)
    src, injected = ((DeviceDataSource, InjectedDraws) if dtype == torch.float32
                     else (Source64, InjectedDraws64))
    source = src(ds, weights=np.linspace(0.1, 1.0, N_DATA), device="cpu")
    cfg = StepConfig(n_dis=N_DIS, batch_size=BS, nz=NZ, loss_type=loss_type,
                     drs_loss_type="ns", model="sngan", gold=gold, gold_step=GOLD_STEP,
                     topk=topk, epoch_steps=EPOCH_STEPS, use_drs=use_drs)
    fused = make_fused_step(g, d, dd, cfg, source, src(ds, device="cpu"))
    metrics = fused(step, injected(draws))
    return metrics, (g, d, dd), grads


def _grad_tree(bridge, params_grad, other):
    return {k: t.numpy() for k, t in bridge({"params": params_grad, **other}).items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_step_matches_jax(case, monkeypatch):
    images = synthetic_natural(N_DATA, 32, seed=9)[0]
    draws = _draws(case, np.random.default_rng(11))
    variables = (jax_generator("32")[1], jax_discriminator("32")[1],
                 jax_discriminator("32", seed=4)[1])
    relu = ReluMasks()
    with monkeypatch.context() as mp:
        mp.setattr(torch.nn.functional, "relu", relu.record(torch.nn.functional.relu))
        _port_step(case, draws, images, variables, torch.float64)
    with monkeypatch.context() as mp:
        mp.setattr(torch.nn.functional, "relu", relu.torch_relu)
        m_t, (g, d, dd), grads = _port_step(case, draws, images, variables)
    assert relu.used == len(relu.masks)
    relu.used = 0
    g_j, d_j, dd_j, m_j = _jax_step(case, draws, images, monkeypatch, relu.jax_relu)
    assert relu.used == len(relu.masks)

    # losses and metrics
    assert set(m_t) == set(m_j), (sorted(m_t), sorted(m_j))
    for k in m_j:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-4, atol=1e-7, err_msg=k)

    excluded = {}
    nets = [("g", g, g_j, jax_params.sngan_generator_state_dict, "batch_stats"),
            ("d", d, d_j, jax_params.sngan_discriminator_state_dict, "spectral")]
    if dd is not None:
        nets.append(("dd", dd, dd_j, jax_params.sngan_discriminator_state_dict, "spectral"))
    for name, net, js, bridge, coll in nets:
        rec = js.opt_state[0]
        n_up = len(grads[name])
        assert n_up == (1 if name == "g" else N_DIS) == int(js.opt_state[1]) == net.count
        masks = {}
        for k in range(n_up):
            want = _grad_tree(bridge, jax.tree.map(lambda r: r[k], rec), {coll: js.state[coll]})
            got = grads[name][k]
            want = {key: w for key, w in want.items() if key in got}
            assert len(want) == len(got)
            for key, w in want.items():
                scale = max(1.0, float(np.abs(w).max()))
                np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-3, atol=1e-5 * scale,
                                           err_msg=f"{name} update {k} grad {key}")
                big = np.abs(w) > max(1e-4 * np.abs(w).max(), 1e-5 * scale)
                masks[key] = masks.get(key, True) & big
        # state after the step: u (D) and running statistics (G)
        after = {k: t.numpy() for k, t in bridge({"params": js.params, coll: js.state[coll]}).items()}
        ours = {k: t.detach().numpy() for k, t in net.module.state_dict().items()}
        for key, w in after.items():
            if key.endswith(("weight_u", "running_mean", "running_var")):
                np.testing.assert_allclose(ours[key], w, atol=1e-6, err_msg=f"{name} {key}")
            elif key in masks:
                m = masks[key]
                excluded[f"{name}.{key}"] = int((~m).sum())
                np.testing.assert_allclose(ours[key][m], w[m], rtol=0, atol=1e-6,
                                           err_msg=f"{name} param {key} after the step")
    print(f"{case}: parameter entries left out by the |g| rule: {sum(excluded.values())} of "
          f"{sum(p.numel() for n in (g, d, dd) if n is not None for p in n.module.parameters())}")


# --- the lr schedule ----------------------------------------------------------

def _optax_lrs(tx, n, state=None):
    """The lr of each of n updates of tx: with b1 = 0 and a constant unit
    gradient, Adam's update is -lr / (1 + eps)."""
    p = {"w": jnp.zeros(())}
    state = tx.init(p) if state is None else state
    lrs = []
    for _ in range(n):
        upd, state = tx.update({"w": jnp.ones(())}, state, p)
        lrs.append(-float(upd["w"]) * (1 + 1e-8))
    return lrs, state


def _port_lrs(net, n):
    lrs = []
    for _ in range(n):
        before = net.module.weight.detach().clone()
        net.module.weight.grad = torch.ones_like(before)
        net.apply_update()
        lrs.append(float((before - net.module.weight.detach()).double().item()) * (1 + 1e-8))
    return lrs


def _net(updates_per_step):
    module = torch.nn.Linear(1, 1, bias=False, dtype=torch.float64)
    torch.nn.init.zeros_(module.weight)
    return NetState(module, OptSpec(LR, BETAS), NUM_STEPS, "linear", updates_per_step)


def test_lr_schedule_matches_optax_and_survives_a_restore(tmp_path):
    """Per-update lr of G (1 update per step) and D (n_dis per step) over
    n_dis x k updates; then D and a netD_drs cloned from D's file continue
    from the checkpoint's update count, as optax continues from its state."""
    k = 4
    for ups in (1, N_DIS):
        want, _ = _optax_lrs(_make_tx(LR, BETAS, NUM_STEPS, "linear", ups), N_DIS * k)
        got = _port_lrs(_net(ups), N_DIS * k)
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert want[1] < want[0]  # D's lr moves by 1/n_dis of a step per update

    tx = _make_tx(LR, BETAS, NUM_STEPS, "linear", N_DIS)
    first, state = _optax_lrs(tx, N_DIS * k)
    rest, _ = _optax_lrs(tx, N_DIS * k, state)
    d = _net(N_DIS)
    _port_lrs(d, N_DIS * k)
    path = checkpoint.save_net(d, tmp_path, "netD", k)
    for resumed in (_net(N_DIS), _net(N_DIS)):  # netD, then netD_drs from netD's file
        assert checkpoint.restore_net(resumed, path) == k and resumed.count == N_DIS * k
        np.testing.assert_allclose(_port_lrs(resumed, N_DIS * k), rest, rtol=1e-6)
    # without decay the lr stays put
    flat = NetState(torch.nn.Linear(1, 1, bias=False), OptSpec(LR, BETAS), NUM_STEPS, None)
    assert {flat.schedule(c) for c in range(50)} == {LR}
