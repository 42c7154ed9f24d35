"""A JAX-package or reference mimicry run carried into the port: the port's
train/checkpoint.py restore_net and load_weights, LogTrainer's resume,
eval/evaluate.py load_eval_models, train/classifier.py load_classifier and
eval/cae_protocol.py load_cae against the JAX package on the files it (or
the reference) writes under the same names.

- restore_net on a Flax msgpack NetState written by the JAX package's
  save_net, for every mimicry net (SNGAN-32 G and D at width 32, SSGAN and
  InfoMax D, the MNIST DCGAN G and D with spectral norm, the toy G and D),
  with the optax state of the JAX trainer's _make_tx under linear decay and
  at a constant lr: eval forwards within 1e-5 x max(1, max|out|), Adam
  moments equal, the update count and step the file's;
- LogTrainer resumed from JAX phase-1 files and from the reference's
  torch-mimicry files: the global step and each net's lr as the JAX
  LogTrainer's, then one phase-2 step (n_dis 2, the twin DRS D cloned from
  netD's file) from injected draws as the JAX fused step from its resumed
  states: gradients within 1e-5 x max(1, max|g|) + rtol 1e-3, parameters
  after the step within 1e-6 where the gradient is well above round-off
  (the harness of test_torch_port_sngan_step.py, ReLU sides from one
  float64 port run);
- the reference's files (torch-mimicry's wrapper with stock spectral-norm
  names, and a bare state_dict): weights, buffers, step and lr as the JAX
  package's import_torch_net gives them;
- load_eval_models on JAX files: G(z) and netD_drs(x) as the JAX loader's
  at 1e-5; cli.common.latest_ckpt_step (--auto_resume) finds them;
- load_classifier on {attr}.pth and ckpt_{epoch}.pt in the JAX package's
  form: logits at 1e-5, and cli.count_attr_celeba's count on a JAX SNGAN-64
  G file is the JAX classifier's count on the same images;
- load_cae on the JAX train_cae's cae_epoch-{e}.pth: reconstruction errors
  at 1e-5.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import flax.linen  # noqa: E402
from flax import serialization  # noqa: E402
from test_torch_port_cae import cae_variables, jit_dequantized  # noqa: E402
from test_torch_port_dcgan import flax_variables  # noqa: E402
from test_torch_port_sngan_models import MODELS, jax_discriminator, jax_generator  # noqa: E402
from test_torch_port_sngan_step import (  # noqa: E402
    BETAS,
    BS,
    LR,
    N_DATA,
    N_DIS,
    NUM_STEPS,
    InjectedDraws,
    ReluMasks,
    _draws,
    _port_step,
    recording,
)
from test_torch_port_ssgan_infomax import shaped_net_state  # noqa: E402

from diagan_tpu.data.arrays import ArrayDataset as JArrayDataset  # noqa: E402
from diagan_tpu.eval import cae_protocol as JCP  # noqa: E402
from diagan_tpu.eval import evaluate as JE  # noqa: E402
from diagan_tpu.models import convnets as JCN  # noqa: E402
from diagan_tpu.models import infomax as JI  # noqa: E402
from diagan_tpu.models import mnist_dcgan as JD  # noqa: E402
from diagan_tpu.models import sngan as JSN  # noqa: E402
from diagan_tpu.models import ssgan as JSS  # noqa: E402
from diagan_tpu.models import toy as JTOY  # noqa: E402
from diagan_tpu.models.registry import get_gan_model as jax_get_gan_model  # noqa: E402
from diagan_tpu.train import checkpoint as JC  # noqa: E402
from diagan_tpu.train import steps as JS  # noqa: E402
from diagan_tpu.train import trainer as JTR  # noqa: E402
from diagan_tpu.train.logger import Logger as JLogger  # noqa: E402
from diagan_tpu.train.state import NetState as JNetState  # noqa: E402
from diagan_tpu.train.state import linear_decay_schedule  # noqa: E402
from diagan_tpu.utils import torch_import as TI  # noqa: E402
from diagan_tpu_torch.cli import count_attr_celeba  # noqa: E402
from diagan_tpu_torch.cli.common import latest_ckpt_step  # noqa: E402
from diagan_tpu_torch.data.arrays import ArrayDataset  # noqa: E402
from diagan_tpu_torch.data.synthetic import synthetic_natural  # noqa: E402
from diagan_tpu_torch.eval import cae_protocol as TCP  # noqa: E402
from diagan_tpu_torch.eval import evaluate as TE  # noqa: E402
from diagan_tpu_torch.models import (  # noqa: E402
    cae,
    convnets,
    infomax,
    mnist_dcgan,
    registry,
    sngan,
    ssgan,
    toy,
)
from diagan_tpu_torch.models.registry import OptSpec  # noqa: E402
from diagan_tpu_torch.train import checkpoint as TC  # noqa: E402
from diagan_tpu_torch.train import classifier as TCL  # noqa: E402
from diagan_tpu_torch.train import trainer as TT  # noqa: E402
from diagan_tpu_torch.train.logger import Logger  # noqa: E402
from diagan_tpu_torch.train.state import NetState  # noqa: E402
from diagan_tpu_torch.utils import jax_params  # noqa: E402

W, P1 = 32, 6  # model width; the phase-1 step of the resumed files
COUNT = 9  # the update count and step of the reader test's files

# name: (JAX module, port module, input kind, its width, updates per step)
NETS = {
    "sngan_g": (functools.partial(JSN.SNGANGenerator32, ngf=W),
                functools.partial(sngan.SNGANGenerator32, ngf=W), "z", 128, 1),
    "sngan_d": (functools.partial(JSN.SNGANDiscriminator32, ndf=W),
                functools.partial(sngan.SNGANDiscriminator32, ndf=W), "img", 3, N_DIS),
    "ssgan_d": (functools.partial(JSS.SSGANDiscriminator32, ndf=W),
                functools.partial(ssgan.SSGANDiscriminator32, ndf=W), "img", 3, N_DIS),
    "infomax_d": (functools.partial(JI.InfoMaxGANDiscriminator32, ndf=W, nrkhs=W),
                  functools.partial(infomax.InfoMaxGANDiscriminator32, ndf=W, nrkhs=W),
                  "img", 3, N_DIS),
    "dcgan_g": (functools.partial(JD.MNISTDCGANGenerator, nc=3),
                functools.partial(mnist_dcgan.MNISTDCGANGenerator, nc=3), "z", 100, 1),
    "dcgan_d": (functools.partial(JD.MNISTDCGANDiscriminator, nc=3, use_sn=True),
                functools.partial(mnist_dcgan.MNISTDCGANDiscriminator, nc=3, use_sn=True),
                "img", 3, 1),
    "toy_g": (JTOY.ToyGenerator, toy.ToyGenerator, "z", 2, 1),
    "toy_d": (functools.partial(JTOY.ToyDiscriminator, use_sn=True),
              functools.partial(toy.ToyDiscriminator, use_sn=True), "pts", 2, 1),
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


def close(got, want, what, tol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())), err_msg=what)


def example(kind, width, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "img":
        return np.tanh(rng.standard_normal((n, 32, 32, width))).astype(np.float32)
    return rng.standard_normal((n, width)).astype(np.float32)


@functools.cache
def jax_variables(name, seed=1):
    jmod, _, kind, width, _ = NETS[name]
    module = jmod()
    kwargs = {"train": True} if kind == "z" else {}
    return module, flax_variables(module, seed, example(kind, width, 2, 0), **kwargs)


def jax_netstate(variables, decay, updates_per_step, count, seed):
    """A NetState as the JAX trainer keeps it after `count` updates: optax's
    state of _make_tx with random moments (nu > 0), its counts and the step
    at `count`."""
    rng = np.random.default_rng(seed)
    params = variables["params"]
    adam, sched = JTR._make_tx(LR, BETAS, NUM_STEPS, decay, updates_per_step).init(params)

    def fill(lo):
        return lambda x: jnp.asarray(lo + 0.02 * rng.random(x.shape).astype(np.float32))

    adam = adam._replace(count=jnp.asarray(count, jnp.int32),
                         mu=jax.tree.map(fill(-0.01), adam.mu),
                         nu=jax.tree.map(fill(1e-3), adam.nu))
    if "count" in sched._fields:
        sched = sched._replace(count=jnp.asarray(count, jnp.int32))
    state = {k: v for k, v in variables.items() if k != "params"}
    return JNetState(params, state, (adam, sched), jnp.asarray(count, jnp.int32))


@functools.cache
def jax_forward(name):
    """The JAX net's jitted eval forward and its output on the reader test's
    input."""
    module, v = jax_variables(name)
    _, _, kind, width, _ = NETS[name]
    x = example(kind, width, 4, 3)
    if kind == "z":
        return x, np.asarray(jax.jit(lambda v, z: module.apply(v, z, train=False))(v, x))
    return x, np.asarray(jax.jit(
        lambda v, x: module.apply(v, x, update_stats=False, train=False)[0])(v, x))


def port_forward(module, kind, x):
    module.eval()
    with torch.no_grad():
        out = module(torch.from_numpy(x))
    return (out if kind == "z" else out[0]).numpy()


# --- the msgpack NetState reader -------------------------------------------

@pytest.mark.parametrize("decay", ["linear", None], ids=["linear", "constant"])
@pytest.mark.parametrize("name", sorted(NETS))
def test_restore_net_reads_a_jax_netstate(name, decay, tmp_path):
    _, tmod, kind, _, ups = NETS[name]
    v = jax_variables(name)[1]
    path = JC.save_net(jax_netstate(v, decay, ups, COUNT, 2), tmp_path, "net", COUNT)
    net = NetState(tmod(device="cpu"), OptSpec(LR, BETAS), NUM_STEPS, decay, ups)
    assert TC.restore_net(net, path) == COUNT
    assert net.count == net.step == COUNT
    x, want = jax_forward(name)
    close(port_forward(net.module, kind, x), want, name)
    bridge = TC.bridge_for(net.module)
    adam = jax.device_get(JC.restore_net(jax_netstate(v, decay, ups, 0, 2), path).opt_state[0])
    mu, nu = bridge({"params": adam.mu}), bridge({"params": adam.nu})
    params = dict(net.module.named_parameters())
    assert set(mu) == set(params)
    for key, p in params.items():
        state = net.optim.state[p]
        assert int(state["step"]) == COUNT
        assert torch.equal(state["exp_avg"], mu[key]) and torch.equal(state["exp_avg_sq"],
                                                                      nu[key]), key
    # the eval path reads the weights and buffers alone
    fresh = tmod(device="cpu")
    raw = TC.load_weights(fresh, path)
    assert raw["format"] == "jax" and raw["step"] == COUNT
    for key, t in net.module.state_dict().items():
        assert torch.equal(fresh.state_dict()[key], t), key


def test_an_unknown_class_or_optimizer_state_raises(tmp_path):
    module, v = jax_variables("toy_g")
    path = JC.save_net(jax_netstate(v, "linear", 1, 1, 0), tmp_path, "net", 1)
    with pytest.raises(ValueError, match="no JAX-package bridge"):
        TC.load_weights(torch.nn.Linear(2, 2), path)
    with pytest.raises(ValueError, match="not an optax.adam state"):
        jax_params.optax_adam_moments({"0": {"count": 1, "mu": {}, "nu": {}},
                                       "1": {"count": 1, "hyperparams": {}}}, dict)


# --- reference (torch-mimicry) files ---------------------------------------

def stock_spectral_names(sd):
    """A port state_dict as torch.nn.utils.spectral_norm saves it:
    weight_orig, weight_u and weight_v."""
    out = {}
    for key, t in sd.items():
        prefix = key[: -len(".weight_u")] if key.endswith(".weight_u") else None
        if prefix is not None:
            w = sd[prefix + ".weight"].reshape(len(t), -1)
            v = w.t() @ t
            out[prefix + ".weight_v"] = v / v.norm()
            out[key] = t
        elif key.endswith(".weight") and key[: -len("weight")] + "weight_u" in sd:
            out[key + "_orig"] = t
        else:
            out[key] = t
    return out


def reference_files(run, variables, step, wrapper=True):
    """Phase-1 netG and netD as the reference writes them: torch-mimicry's
    wrapper (stock spectral-norm names, an optimizer state, global_step) or,
    with wrapper=False, bare state_dicts."""
    gv, dv = variables
    g = MODELS["32"][1](device="cpu")
    g.load_state_dict(jax_params.sngan_generator_state_dict(gv))
    d = MODELS["32"][3](device="cpu")
    d.load_state_dict(jax_params.sngan_discriminator_state_dict(dv))
    paths = []
    for name, module in (("netG", g), ("netD", d)):
        sd = stock_spectral_names(module.state_dict())
        payload = sd
        if wrapper:
            opt = torch.optim.Adam(module.parameters(), lr=LR, betas=BETAS)
            payload = {"model_state_dict": sd, "optimizer_state_dict": opt.state_dict(),
                       "global_step": step}
        path = TC.ckpt_path(run / "checkpoints", name, step)
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save(payload, path)
        paths.append(path)
    return paths


def jax_files(run, variables, step):
    """Phase-1 netG and netD as the JAX trainer writes them (random moments)."""
    gv, dv = variables
    return [JC.save_net(jax_netstate(v, "linear", ups, step * ups, seed), run / "checkpoints",
                        name, step)
            for name, v, ups, seed in (("netG", gv, 1, 5), ("netD", dv, N_DIS, 6))]


@pytest.mark.parametrize("wrapper", [True, False], ids=["wrapper", "bare"])
def test_reference_files_follow_import_torch_net(wrapper, tmp_path):
    """The repaired reader: the port read torch-mimicry's wrapper only if it
    had the port's own "update_count" key. Weights, buffers and step as the
    JAX package's import_torch_net; Adam fresh, so the lr is lr0."""
    variables = (jax_generator("32")[1], jax_discriminator("32")[1])
    paths = reference_files(tmp_path, variables, 7, wrapper)
    step = 7 if wrapper else 0
    for path, (jmod, tmod, bridge, coll, ups) in zip(paths, (
            (MODELS["32"][0], MODELS["32"][1], jax_params.sngan_generator_state_dict,
             "batch_stats", 1),
            (MODELS["32"][2], MODELS["32"][3], jax_params.sngan_discriminator_state_dict,
             "spectral", N_DIS))):
        v = jax_generator("32")[1] if coll == "batch_stats" else jax_discriminator("32")[1]
        tx = JTR._make_tx(LR, BETAS, NUM_STEPS, "linear", ups)
        template = JNetState(v["params"], {coll: v[coll]}, tx.init(v["params"]),
                             jnp.asarray(3, jnp.int32))
        want = TI.import_torch_net(template, path)
        net = NetState(tmod(device="cpu"), OptSpec(LR, BETAS), NUM_STEPS, "linear", ups)
        net.apply_update()  # a count and moments that the restore must drop
        assert TC.restore_net(net, path) == step
        assert net.step == int(want.step) == step
        assert net.count == int(want.opt_state[1].count) == 0 and not net.optim.state
        assert net.schedule(net.count) == LR
        np.testing.assert_allclose(float(linear_decay_schedule(LR, NUM_STEPS)(0)), LR, rtol=1e-7)
        wanted = bridge(jax.device_get({"params": want.params, **want.state}))
        got = net.module.state_dict()
        assert set(got) == set(wanted)
        for key, t in wanted.items():
            np.testing.assert_array_equal(got[key].numpy(), t.numpy(), err_msg=key)


# --- LogTrainer resumed from JAX or reference phase-1 files ----------------

def jax_trainer(run, images, paths, monkeypatch):
    monkeypatch.setattr(JTR, "create_net_state", shaped_net_state)
    monkeypatch.setattr(JTR, "Logger", functools.partial(JLogger, use_tensorboard=False))
    bundle = dataclasses.replace(
        jax_get_gan_model("cifar10", model="sngan", loss_type="hinge", drs=True),
        gen=MODELS["32"][0](), disc=MODELS["32"][2](), disc_drs=MODELS["32"][2]())
    return JTR.LogTrainer(run, bundle, JArrayDataset.from_images(images), NUM_STEPS,
                          sample_weights=np.linspace(0.1, 1.0, N_DATA), n_dis=N_DIS,
                          lr_decay="linear", batch_size=BS, netG_ckpt_file=paths[0],
                          netD_ckpt_file=paths[1], netD_drs_ckpt_file=paths[1],
                          save_logits=False)


def port_trainer(run, images, paths, monkeypatch):
    monkeypatch.setattr(TT, "Logger", functools.partial(Logger, use_tensorboard=False))
    bundle = dataclasses.replace(
        registry.get_gan_model("cifar10", model="sngan", loss_type="hinge", drs=True,
                               device="cpu"),
        gen=MODELS["32"][1](device="cpu"), disc=MODELS["32"][3](device="cpu"),
        disc_drs=MODELS["32"][3](device="cpu"))
    return TT.LogTrainer(run, bundle, ArrayDataset.from_images(images), NUM_STEPS,
                         sample_weights=np.linspace(0.1, 1.0, N_DATA), n_dis=N_DIS,
                         lr_decay="linear", batch_size=BS, netG_ckpt_file=paths[0],
                         netD_ckpt_file=paths[1], netD_drs_ckpt_file=paths[1],
                         save_logits=False, device="cpu")


def jax_resumed_steps(trainers, draws, images, monkeypatch, relu):
    """One fused step of the JAX package from each trainer's resumed states,
    with the injected draws and ReLU sides (traced once: the draws and the
    masks are the same for every trainer); each net's tx records its
    gradients."""
    jt = trainers[0]
    txs = [recording(jt.tx_g, 1), recording(jt.tx_d, N_DIS), recording(jt.tx_d_drs, N_DIS)]
    real, drs, normals = iter(draws["real"]), iter(draws["drs"]), []
    for i in range(N_DIS):
        normals += [draws["z"][i], draws["drs_z"][i]]
    normals = iter(normals + [draws["g_z"][N_DIS - 1]])
    images_j = jnp.asarray(images)
    outs = []
    with monkeypatch.context() as mp:
        mp.setattr(JS, "_sample_idx", lambda *a: jnp.asarray(next(real), jnp.int32))
        mp.setattr(JS, "sample_uniform_indices", lambda *a: jnp.asarray(next(drs), jnp.int32))
        mp.setattr(jax.random, "normal", lambda *a, **k: jnp.asarray(next(normals)))
        mp.setattr(flax.linen, "relu", relu)
        b = jt.bundle
        fused = JS.make_fused_step(b.gen, b.disc, b.disc_drs, *txs, jt.cfg, N_DATA, N_DATA)
        compiled = None
        for tr in trainers:
            states = []
            for state, tx in zip((tr.g_state, tr.d_state, tr.d_drs_state), txs):
                rec, i, _ = tx.init(state.params)
                states.append(state.replace(opt_state=(rec, i, state.opt_state)))
            args = (*states, images_j, images_j, jnp.zeros(N_DATA), jax.random.key(0),
                    jnp.asarray(tr.global_step, jnp.int32))
            if compiled is None:  # XLA's level 0 compiles ~40% sooner
                compiled = jax.jit(fused).lower(*args).compile(
                    compiler_options={"xla_backend_optimization_level": 0})
            outs.append(jax.device_get(compiled(*args)))
    return outs


def test_log_trainer_resumes_as_the_jax_trainer(tmp_path, monkeypatch):
    """From JAX phase-1 files (random moments, counts at P1 and P1 x n_dis)
    and from the reference's torch-mimicry files (fresh Adam, the step from
    global_step): global step, counts, steps and lr as the JAX LogTrainer's,
    then one phase-2 step as the JAX package's from its resumed states."""
    images = synthetic_natural(N_DATA, 32, seed=9)[0]
    gv, dv = jax_generator("32")[1], jax_discriminator("32")[1]
    kinds = {"jax": jax_files, "reference": reference_files}
    jts, pts = [], []
    for kind, write in kinds.items():
        paths = write(tmp_path / kind / "p1", (gv, dv), P1)
        jt = jax_trainer(tmp_path / kind / "jax", images, paths, monkeypatch)
        pt = port_trainer(tmp_path / kind / "port", images, paths, monkeypatch)
        assert pt.global_step == jt.global_step == P1
        for net, js, ups in ((pt.g, jt.g_state, 1), (pt.d, jt.d_state, N_DIS),
                             (pt.d_drs, jt.d_drs_state, N_DIS)):
            count = int(js.opt_state[1].count)
            assert net.count == count == (P1 * ups if kind == "jax" else 0)
            assert net.step == int(js.step)
            want_lr = float(linear_decay_schedule(LR, NUM_STEPS)(count / ups))
            np.testing.assert_allclose(net.schedule(net.count), want_lr, rtol=1e-7)
        jts.append(jt)
        pts.append(pt)

    draws = _draws("phase2", np.random.default_rng(11))
    relu = ReluMasks()
    with monkeypatch.context() as mp:
        mp.setattr(torch.nn.functional, "relu", relu.record(torch.nn.functional.relu))
        _port_step("phase2", draws, images, (gv, dv, dv), torch.float64)
    grads = []
    for pt in pts:
        grads.append({})
        for name, net in (("g", pt.g), ("d", pt.d), ("dd", pt.d_drs)):
            named = list(net.module.named_parameters())
            net.optim.register_step_pre_hook(
                lambda opt, args, kwargs, rec=grads[-1], name=name, named=named:
                rec.setdefault(name, []).append({k: p.grad.detach().clone() for k, p in named}))
        relu.used = 0
        with monkeypatch.context() as mp:
            mp.setattr(torch.nn.functional, "relu", relu.torch_relu)
            pt.fused_step(pt.global_step, InjectedDraws(draws))
        assert relu.used == len(relu.masks)
    relu.used = 0
    outs = jax_resumed_steps(jts, draws, images, monkeypatch, relu.jax_relu)
    assert relu.used == len(relu.masks)

    for kind, pt, rec_grads, (g_j, d_j, dd_j, _) in zip(kinds, pts, grads, outs):
        for name, net, js, bridge in (
                ("g", pt.g, g_j, jax_params.sngan_generator_state_dict),
                ("d", pt.d, d_j, jax_params.sngan_discriminator_state_dict),
                ("dd", pt.d_drs, dd_j, jax_params.sngan_discriminator_state_dict)):
            rec = js.opt_state[0]
            assert len(rec_grads[name]) == int(js.opt_state[1])
            masks = {}
            for k, got in enumerate(rec_grads[name]):
                want = bridge({"params": jax.tree.map(lambda r: r[k], rec)})
                assert set(want) == set(got)
                for key, w in want.items():
                    w = w.numpy()
                    scale = max(1.0, float(np.abs(w).max()))
                    np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-3,
                                               atol=1e-5 * scale,
                                               err_msg=f"{kind} {name} update {k} grad {key}")
                    big = np.abs(w) > max(1e-4 * np.abs(w).max(), 1e-5 * scale)
                    masks[key] = masks.get(key, True) & big
            after = bridge({"params": js.params})
            ours = dict(net.module.named_parameters())
            for key, m in masks.items():
                np.testing.assert_allclose(ours[key].detach().numpy()[m], after[key].numpy()[m],
                                           rtol=0, atol=1e-6,
                                           err_msg=f"{kind} {name} {key} after the step")


# --- evaluation -------------------------------------------------------------

@pytest.mark.parametrize("model", ["sngan", "dcgan"])
def test_load_eval_models_reads_jax_files(model, tmp_path, monkeypatch):
    step = 4
    if model == "sngan":
        gv, dv = jax_generator("32")[1], jax_discriminator("32", seed=4)[1]
        jbundle = dataclasses.replace(jax_get_gan_model("cifar10", drs=True),
                                      gen=MODELS["32"][0](), disc=MODELS["32"][2](),
                                      disc_drs=MODELS["32"][2]())
        bundle = dataclasses.replace(
            registry.get_gan_model("cifar10", drs=True, device="cpu"),
            gen=MODELS["32"][1](device="cpu"), disc=MODELS["32"][3](device="cpu"),
            disc_drs=MODELS["32"][3](device="cpu"))
        nz = 128
    else:
        jbundle = jax_get_gan_model("color_mnist", drs=True)
        gv = jax_variables("dcgan_g")[1]
        dv = flax_variables(jbundle.disc_drs, 2, example("img", 3, 2, 0))
        bundle = registry.get_gan_model("color_mnist", drs=True, device="cpu")
        nz = 100
    for name, v, ups, seed in (("netG", gv, 1, 1), ("netD_drs", dv, N_DIS, 2)):
        JC.save_net(jax_netstate(v, "linear", ups, step * ups, seed),
                    tmp_path / "checkpoints", name, step)
    # --auto_resume's newest step finds the JAX package's files under their names
    assert latest_ckpt_step(tmp_path) == JC.latest_step(tmp_path / "checkpoints", "netG") == step
    monkeypatch.setattr(JE, "create_net_state", shaped_net_state)
    g_state, d_state = JE.load_eval_models(jbundle, tmp_path, step, use_drs=True)
    gen, disc = TE.load_eval_models(bundle, tmp_path, step, use_drs=True)
    z = np.random.default_rng(0).standard_normal((6, nz)).astype(np.float32)
    want_x = np.asarray(JE.make_gen_fn(jbundle, g_state)(z))
    close(TE.make_gen_fn(gen)(torch.from_numpy(z)).numpy(), want_x, f"{model} G(z)")
    want = np.asarray(JE.make_disc_fn(jbundle.disc_drs, d_state)(want_x))
    close(TE.make_disc_fn(disc)(torch.from_numpy(want_x.copy())).numpy(), want,
          f"{model} netD_drs(x)")


# --- the classifier and CAE files -------------------------------------------

def test_load_classifier_reads_the_jax_files(tmp_path, monkeypatch):
    """{attr}.pth and ckpt_{epoch}.pt hold the same Flax bytes, to_bytes of
    {params, batch_stats} (count_attr_celeba.py:61-72 reads the one,
    diagan_tpu/train/classifier.py:101-103 writes the other); the files
    are written so here, for the attribute classifier and for the probes'
    SimpleConvNet. (The JAX train_classifier's compile costs ~16 s here.)"""
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (24, 64, 64, 3), dtype=np.uint8)
    module = JCN.AttrClassifier(num_attrs=2)
    variables = flax_variables(module, 5, jnp.zeros((2, 64, 64, 3)), train=True)
    (tmp_path / "attr_classifier").mkdir()
    (tmp_path / "attr_classifier" / "Bald.pth").write_bytes(serialization.to_bytes(variables))
    model = TCL.load_classifier(convnets.AttrClassifier(num_attrs=2, device="cpu"),
                                tmp_path / "attr_classifier" / "Bald.pth")
    # the JAX package's eval-mode logits (predict_classifier's forward, jitted once)
    logits_of = jax.jit(lambda v, x: module.apply(v, x.astype(jnp.float32) / 127.5 - 1.0,
                                                  train=False)[0])
    close(TCL.predict_classifier(model, images), logits_of(variables, images), "AttrClassifier")

    probe = JCN.SimpleConvNet(num_labels=10, kernel_size=3)
    pv = flax_variables(probe, 6, jnp.zeros((2, 28, 28, 1)), train=True)
    (tmp_path / "ckpt_10.pt").write_bytes(serialization.to_bytes(pv))
    model = TCL.load_classifier(convnets.SimpleConvNet(num_labels=10, kernel_size=3,
                                                       device="cpu", in_ch=1),
                                tmp_path / "ckpt_10.pt")
    x = np.tanh(np.random.default_rng(4).standard_normal((4, 28, 28, 1))).astype(np.float32)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))[0].numpy()
    close(got, jax.jit(lambda v, x: probe.apply(v, x, train=False)[0])(pv, x), "SimpleConvNet")

    # cli.count_attr_celeba on a JAX SNGAN-64 G file and that classifier file
    monkeypatch.setitem(registry._GEN_64, "sngan",
                        functools.partial(sngan.SNGANGenerator64, ngf=W))
    monkeypatch.setitem(registry._DISC_64, "sngan",
                        functools.partial(sngan.SNGANDiscriminator64, ndf=W))
    gen = JSN.SNGANGenerator64(ngf=W)
    gv = flax_variables(gen, 4, jnp.zeros((2, 128)), train=True)
    JC.save_net(jax_netstate(gv, "linear", 1, 3, 7), tmp_path / "run" / "checkpoints", "netG", 3)
    seen = {}

    def predict(model, imgs, batch_size=256):
        seen["images"] = imgs
        return TCL.predict_classifier(model, imgs, batch_size)

    monkeypatch.setattr(count_attr_celeba, "predict_classifier", predict)
    out = count_attr_celeba.main(["--exp_name", "run", "--netG_ckpt_step", "3", "--attr", "Bald",
                                  "--num_samples", "24", "--work_dir", str(tmp_path),
                                  "--device", "cpu"])
    logits = np.asarray(logits_of(variables, seen["images"]))
    assert out["count"] == int((logits.argmax(-1) == 1).sum()) and out["total"] == 24


def test_load_cae_reads_the_jax_file(tmp_path):
    module, v = cae_variables(32, 3)
    rng = np.random.default_rng(5)
    gen = jit_dequantized(rng.integers(0, 256, (64, 32, 32, 3), dtype=np.uint8)).astype(np.float32)
    real = jit_dequantized(rng.integers(0, 256, (40, 32, 32, 3), dtype=np.uint8)).astype(
        np.float32)

    class Standin:  # the JAX train_cae inits the CAE: hand it these weights
        def init(self, *a, **k):
            return jax.tree.map(np.array, jax.device_get(v))

        def apply(self, *a, **k):
            return module.apply(*a, **k)

    want = JCP.train_cae(Standin(), gen, real, tmp_path, epochs=1, batch_size=32,
                         model_save_epochs=1)
    port = TCP.load_cae(cae.CAE32(3, device="cpu"), tmp_path / "cae_epoch-1.pth")
    close(TCP.reconstruction_errors(port, torch.from_numpy(real)), want[:, 0], "RE")
