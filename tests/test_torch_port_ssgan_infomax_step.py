"""The port's fused step for SSGAN and InfoMax-GAN and under the step
fusions (diagan_tpu_torch.train.steps) against the JAX package's
make_fused_step (diagan_tpu/train/steps.py).

The harness of tests/test_torch_port_sngan_step.py: one fused step (n_dis 2,
batch 4, 32 px, ndf / ngf 32, nrkhs 32) on the same Flax weights (bridged),
the same uint8 images and the same injected draws (the JAX step's index and
latent draws patched while it traces); each Adam update's gradients recorded
on both sides; every ReLU decision (G's, the discriminators' and InfoMax's
global head's) taken from one float64 port run. The cases: SSGAN and
InfoMax, each with and without the twin DRS D; InfoMax with top-k (its
InfoNCE over all N fakes, the JAX package's choice); SSGAN with GOLD; SNGAN
and SSGAN under simultaneous_g; InfoMax under concat_d; SNGAN under fuse_g
with the twin D.

Under simultaneous_g the JAX gd_step runs D on the fakes twice from the
same state (D's update on them detached, G's with D's parameters held),
which XLA merges; the port runs that forward once and takes each net's
gradients from it. Both forwards see the same pre-activations, so the JAX
side's masks repeat that forward's.

The Flax variables come from jax.eval_shape filled with seeded numpy, and the
JAX step is compiled at XLA's backend optimisation level 0 (about 60% of the
default's compile time on the CPU; its results move by round-off only). The
tolerances are test_torch_port_sngan_step.py's: losses and metrics rtol
1e-4; gradients atol 1e-5 x max(1, max|g|) + rtol 1e-3; u and G's running
statistics 1e-6; parameters after the step 1e-6 where every update's |g| is
above its round-off.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import flax.linen  # noqa: E402
from test_torch_port_sngan_step import (  # noqa: E402
    BETAS,
    LR,
    NUM_STEPS,
    InjectedDraws,
    ReluMasks,
    _grad_tree,
    recording,
)
from test_torch_port_ssgan_infomax import flax_variables  # noqa: E402

from diagan_tpu.models import infomax as JI  # noqa: E402
from diagan_tpu.models import sngan as JSN  # noqa: E402
from diagan_tpu.models import ssgan as JSS  # noqa: E402
from diagan_tpu.train import steps as JS  # noqa: E402
from diagan_tpu.train.state import NetState as JNetState  # noqa: E402
from diagan_tpu.train.trainer import _make_tx  # noqa: E402
from diagan_tpu_torch.data.arrays import ArrayDataset  # noqa: E402
from diagan_tpu_torch.data.pipeline import DeviceDataSource  # noqa: E402
from diagan_tpu_torch.data.synthetic import synthetic_natural  # noqa: E402
from diagan_tpu_torch.models import infomax, sngan, ssgan  # noqa: E402
from diagan_tpu_torch.models.registry import OptSpec  # noqa: E402
from diagan_tpu_torch.train.state import NetState  # noqa: E402
from diagan_tpu_torch.train.steps import StepConfig, make_fused_step  # noqa: E402
from diagan_tpu_torch.utils import jax_params  # noqa: E402

N_DIS, BS, NZ, N_DATA, WIDTH, NRKHS = 2, 4, 128, 16, 32, 32
GOLD_STEP, EPOCH_STEPS = 3, 2  # GOLD on at step 5; top-k rate 0.99 ** 2 -> k = 3 of 4

# model -> (JAX D, port D, the bridge)
DISCS = {
    "sngan": (functools.partial(JSN.SNGANDiscriminator32, ndf=WIDTH),
              functools.partial(sngan.SNGANDiscriminator32, ndf=WIDTH),
              jax_params.sngan_discriminator_state_dict),
    "ssgan": (functools.partial(JSS.SSGANDiscriminator32, ndf=WIDTH),
              functools.partial(ssgan.SSGANDiscriminator32, ndf=WIDTH),
              jax_params.ssgan_discriminator_state_dict),
    "infomax_gan": (functools.partial(JI.InfoMaxGANDiscriminator32, ndf=WIDTH, nrkhs=NRKHS),
                    functools.partial(infomax.InfoMaxGANDiscriminator32, ndf=WIDTH, nrkhs=NRKHS),
                    jax_params.infomax_discriminator_state_dict),
}

CASES = {
    # name: (model, loss_type, use_drs, gold, topk, step fusions, global_step)
    "ssgan_phase1": ("ssgan", "hinge", False, False, False, {}, 0),
    "ssgan_phase2": ("ssgan", "hinge", True, False, False, {}, 7),
    "ssgan_gold": ("ssgan", "hinge", True, True, False, {}, 5),
    "infomax_phase1": ("infomax_gan", "hinge", False, False, False, {}, 0),
    "infomax_phase2": ("infomax_gan", "hinge", True, False, False, {}, 7),
    "infomax_topk": ("infomax_gan", "ns", True, False, True, {}, 5),
    "sngan_simultaneous_g": ("sngan", "hinge", True, False, False, {"simultaneous_g": True}, 7),
    "ssgan_simultaneous_g": ("ssgan", "hinge", False, False, False, {"simultaneous_g": True}, 0),
    "infomax_concat_d": ("infomax_gan", "hinge", True, False, False, {"concat_d": True}, 7),
    "sngan_fuse_g": ("sngan", "hinge", True, False, False, {"fuse_g": True}, 7),
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch in these tests: the suite runs test files
    in parallel processes, and torch's default of one thread per core makes
    the processes' small ops wait on each other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def jax_generator():
    gen = JSN.SNGANGenerator32(ngf=WIDTH)
    return gen, flax_variables(gen, 2, jnp.zeros((2, NZ)), train=True)


@functools.cache
def jax_discriminator(model, seed=3):
    disc = DISCS[model][0]()
    return disc, flax_variables(disc, seed, jnp.zeros((2, 32, 32, 3)))


def _draws(case, rng):
    _, _, use_drs, _, _, fusions, _ = CASES[case]
    normal = lambda n: rng.standard_normal((n, NZ)).astype(np.float32)  # noqa: E731
    d = {"real": [rng.integers(0, N_DATA, BS) for _ in range(N_DIS)]}
    if use_drs:
        d["drs"] = [rng.integers(0, N_DATA, BS) for _ in range(N_DIS)]
    if fusions.get("fuse_g"):
        d["z_all"] = [normal(N_DIS * BS * (2 if use_drs else 1))]
    else:
        d["z"] = [normal(BS) for _ in range(N_DIS)]
        if use_drs:
            d["drs_z"] = [normal(BS) for _ in range(N_DIS)]
    if not fusions.get("simultaneous_g"):
        d["g_z"] = {N_DIS - 1: normal(BS)}
    return d


def _normal_order(case, draws):
    """The latent draws in the order the JAX step takes them."""
    _, _, use_drs, _, _, fusions, _ = CASES[case]
    out = list(draws.get("z_all", []))
    for i in range(N_DIS):
        if "z" in draws:
            out.append(draws["z"][i])
            if use_drs:
                out.append(draws["drs_z"][i])
    return out + ([draws["g_z"][N_DIS - 1]] if "g_z" in draws else [])


def _jax_step(case, draws, images, monkeypatch, relu):
    model, loss_type, use_drs, gold, topk, fusions, step = CASES[case]
    gen, gv = jax_generator()
    disc, dv = jax_discriminator(model)
    _, drs_v = jax_discriminator(model, seed=4)
    cfg = JS.StepConfig(n_dis=N_DIS, batch_size=BS, nz=NZ, loss_type=loss_type,
                        drs_loss_type="ns", model=model, gold=gold, gold_step=GOLD_STEP,
                        topk=topk, epoch_steps=EPOCH_STEPS, use_drs=use_drs, quantized=True,
                        **fusions)
    tx_g = recording(_make_tx(LR, BETAS, NUM_STEPS, "linear", 1), 1)
    tx_d = recording(_make_tx(LR, BETAS, NUM_STEPS, "linear", N_DIS), N_DIS)
    tx_dd = recording(_make_tx(LR, BETAS, NUM_STEPS, "linear", N_DIS), N_DIS)

    def state(v, tx, coll):
        return JNetState(v["params"], {coll: v[coll]}, tx.init(v["params"]),
                         jnp.zeros((), jnp.int32))

    g_state = state(gv, tx_g, "batch_stats")
    d_state = state(dv, tx_d, "spectral")
    dd_state = state(drs_v, tx_dd, "spectral") if use_drs else None

    real, drs = iter(draws["real"]), iter(draws.get("drs", []))
    normals = iter(_normal_order(case, draws))
    monkeypatch.setattr(JS, "_sample_idx", lambda *a: jnp.asarray(next(real), jnp.int32))
    monkeypatch.setattr(JS, "sample_uniform_indices", lambda *a: jnp.asarray(next(drs), jnp.int32))
    monkeypatch.setattr(jax.random, "normal", lambda *a, **k: jnp.asarray(next(normals)))
    monkeypatch.setattr(flax.linen, "relu", relu)
    fused = JS.make_fused_step(gen, disc, disc if use_drs else None, tx_g, tx_d,
                               tx_dd if use_drs else None, cfg, N_DATA, N_DATA)
    images_j = jnp.asarray(images)
    args = (g_state, d_state, dd_state, images_j, images_j,
            jnp.zeros(N_DATA) if use_drs else None, jax.random.key(0),
            jnp.asarray(step, jnp.int32))
    compiled = jax.jit(fused).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    monkeypatch.undo()
    return jax.device_get(compiled(*args))


class Source64(DeviceDataSource):
    def gather(self, idx):
        return super().gather(idx).double()


class InjectedDraws64(InjectedDraws):
    def normal(self, kind, i, n, nz, device):
        return super().normal(kind, i, n, nz, device).double()


def port_nets(model, variables, dtype=torch.float32):
    gv, dv, drs_v = variables
    make_d, bridge = DISCS[model][1], DISCS[model][2]
    g = sngan.SNGANGenerator32(ngf=WIDTH, device="cpu")
    g.load_state_dict(jax_params.sngan_generator_state_dict(gv))
    ds = []
    for v in (dv, drs_v):
        d = make_d(device="cpu")
        d.load_state_dict(bridge(v))
        ds.append(d.to(dtype))
    return g.to(dtype), *ds


def _port_step(case, draws, images, variables, dtype=torch.float32):
    model, loss_type, use_drs, gold, topk, fusions, step = CASES[case]
    g_mod, d_mod, dd_mod = port_nets(model, variables, dtype)
    spec = OptSpec(LR, BETAS)
    g = NetState(g_mod, spec, NUM_STEPS, "linear", 1)
    d = NetState(d_mod, spec, NUM_STEPS, "linear", N_DIS)
    dd = NetState(dd_mod, spec, NUM_STEPS, "linear", N_DIS) if use_drs else None
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
                     drs_loss_type="ns", model=model, gold=gold, gold_step=GOLD_STEP,
                     topk=topk, epoch_steps=EPOCH_STEPS, use_drs=use_drs, **fusions)
    fused = make_fused_step(g, d, dd, cfg, source, src(ds, device="cpu"))
    metrics = fused(step, injected(draws))
    return metrics, (g, d, dd), grads


def relus_per_forward(module, x):
    """The ReLU calls of one forward of a port module."""
    count = []
    F = torch.nn.functional
    orig = F.relu
    F.relu = lambda t, *a, **k: count.append(1) or orig(t)
    try:
        with torch.no_grad():
            module(x)
    finally:
        F.relu = orig
    return len(count)


def _duplicate_gd_fake_forward(case, masks, variables):
    """The JAX gd_step's masks from the port's: its second D(fakes) forward
    repeats the first (the module docstring)."""
    model, _, use_drs, *_ = CASES[case]
    g, d, _ = port_nets(model, variables)
    k_g = relus_per_forward(g, torch.zeros(BS, NZ))
    k_d = relus_per_forward(d, torch.zeros(BS, 32, 32, 3))
    update = k_g + (3 if model == "ssgan" else 2) * k_d  # G, D(real), D(fake), rotation
    start = (N_DIS - 1) * update * (2 if use_drs else 1) + k_g + k_d
    return masks[:start + k_d] + masks[start:]


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_step_matches_jax(case, monkeypatch):
    model, _, use_drs, *_ = CASES[case]
    bridge = DISCS[model][2]
    images = synthetic_natural(N_DATA, 32, seed=9)[0]
    draws = _draws(case, np.random.default_rng(11))
    variables = (jax_generator()[1], jax_discriminator(model)[1],
                 jax_discriminator(model, seed=4)[1])
    relu = ReluMasks()
    with monkeypatch.context() as mp:
        mp.setattr(torch.nn.functional, "relu", relu.record(torch.nn.functional.relu))
        _port_step(case, draws, images, variables, torch.float64)
    with monkeypatch.context() as mp:
        mp.setattr(torch.nn.functional, "relu", relu.torch_relu)
        m_t, (g, d, dd), grads = _port_step(case, draws, images, variables)
    assert relu.used == len(relu.masks)
    if CASES[case][5].get("simultaneous_g"):
        relu.masks = _duplicate_gd_fake_forward(case, relu.masks, variables)
    relu.used = 0
    g_j, d_j, dd_j, m_j = _jax_step(case, draws, images, monkeypatch, relu.jax_relu)
    assert relu.used == len(relu.masks)

    assert set(m_t) == set(m_j), (sorted(m_t), sorted(m_j))
    for k in m_j:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-4, atol=1e-7, err_msg=k)

    nets = [("g", g, g_j, jax_params.sngan_generator_state_dict, "batch_stats"),
            ("d", d, d_j, bridge, "spectral")]
    if use_drs:
        nets.append(("dd", dd, dd_j, bridge, "spectral"))
    for name, net, js, net_bridge, coll in nets:
        rec = js.opt_state[0]
        n_up = len(grads[name])
        assert n_up == (1 if name == "g" else N_DIS) == int(js.opt_state[1]) == net.count
        masks = {}
        for k in range(n_up):
            want = _grad_tree(net_bridge, jax.tree.map(lambda r: r[k], rec),
                              {coll: js.state[coll]})
            got = grads[name][k]
            want = {key: w for key, w in want.items() if key in got}
            assert len(want) == len(got)
            for key, w in want.items():
                scale = max(1.0, float(np.abs(w).max()))
                np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-3, atol=1e-5 * scale,
                                           err_msg=f"{name} update {k} grad {key}")
                big = np.abs(w) > max(1e-4 * np.abs(w).max(), 1e-5 * scale)
                masks[key] = masks.get(key, True) & big
        after = {k: t.numpy() for k, t in
                 net_bridge({"params": js.params, coll: js.state[coll]}).items()}
        ours = {k: t.detach().numpy() for k, t in net.module.state_dict().items()}
        for key, w in after.items():
            if key.endswith(("weight_u", "running_mean", "running_var")):
                np.testing.assert_allclose(ours[key], w, atol=1e-6, err_msg=f"{name} {key}")
            elif key in masks:
                m = masks[key]
                np.testing.assert_allclose(ours[key][m], w[m], rtol=0, atol=1e-6,
                                           err_msg=f"{name} param {key} after the step")
