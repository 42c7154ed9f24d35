"""SSGAN and InfoMax-GAN in the port (diagan_tpu_torch.models.{ssgan,
infomax}, the losses, the weight bridges), the bf16 compute dtype of the
SNGAN and MNIST DCGAN models, and --model ssgan|infomax_gan, --bf16 and
--simultaneous_g through the CLIs, on the CPU, against the JAX package.

  - rotate_batch_4way exactly; ss_rotation_loss and infonce_loss at 1e-6;
  - the SSGAN / InfoMax discriminators at 32 and 64 px (ndf 32, nrkhs 32,
    batch 4) against the Flax modules through the new bridges: logits,
    features, ss_logits, local_proj and global_proj at 1e-5 x max(1,
    max|out|), u after one update_stats forward at 1e-6 (unchanged
    without);
  - the bridge's state_dicts through diagan_tpu/utils/mimicry_import.py
    back to the Flax tree, every leaf equal; the bridges raise on an unknown
    leaf;
  - bf16: G and D forwards against the JAX modules with dtype=bfloat16,
    each output within twice the distance bf16 moves the JAX output from
    its fp32 one (each side rounds to bf16 after every conv and dense layer,
    and XLA's bf16 convolutions and torch's do not round alike; the fp32
    tolerances stay as they are);
  - get_gan_model builds every cifar10 / celeba SSGAN and InfoMax bundle at
    full width with the twin D, fp32 and bf16, on the CPU;
  - the CLIs at width 32 (registry narrowed): phase 1 -> LDR scores ->
    phase 2 (twin D) -> cli.eval_gan_drs (counts cut to 64, a stand-in
    featurizer, DRS warming up on 2 batches), then the JAX package's
    load_eval_models on the port's run, its G(z) and netD_drs(x) at 1e-5;
    --simultaneous_g and --bf16 runs; the MNIST scripts honour --bf16 and
    accept --simultaneous_g without effect (a run with it is the run without,
    bit for bit), and the Inclusive script takes neither, as the JAX
    scripts do.

Flax variables come from jax.eval_shape filled with seeded numpy.
"""
import copy
import dataclasses
import functools
import math
import pickle
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_port_evaluate import StubFeaturizer  # noqa: E402
from test_torch_port_mnist_data import write_mnist  # noqa: E402
from test_torch_port_sngan_data import write_cifar_batches  # noqa: E402
from test_torch_port_sngan_models import randomize  # noqa: E402

from diagan_tpu.eval import evaluate as JE  # noqa: E402
from diagan_tpu.models import infomax as JI  # noqa: E402
from diagan_tpu.models import losses as JL  # noqa: E402
from diagan_tpu.models import mnist_dcgan as JD  # noqa: E402
from diagan_tpu.models import sngan as JSN  # noqa: E402
from diagan_tpu.models import ssgan as JSS  # noqa: E402
from diagan_tpu.models.registry import get_gan_model as jax_get_gan_model  # noqa: E402
from diagan_tpu.train.state import NetState as JNetState  # noqa: E402
from diagan_tpu.utils import mimicry_import as MI  # noqa: E402
from diagan_tpu_torch.cli import (  # noqa: E402
    eval_gan,
    eval_gan_drs,
    train_mimicry_color_mnist_phase1,
    train_mimicry_inclusive,
    train_mimicry_phase1,
    train_mimicry_phase2,
)
from diagan_tpu_torch.eval import evaluate as TE  # noqa: E402
from diagan_tpu_torch.eval.drs import DRS  # noqa: E402
from diagan_tpu_torch.models import (  # noqa: E402
    infomax,
    losses,
    mnist_dcgan,
    registry,
    sngan,
    ssgan,
)
from diagan_tpu_torch.train import trainer as TT  # noqa: E402
from diagan_tpu_torch.train.logger import Logger  # noqa: E402
from diagan_tpu_torch.utils import jax_params  # noqa: E402

BS, NZ, WIDTH, NRKHS, N_DATA, N_EVAL = 4, 128, 32, 32, 64, 64

# (JAX D, port D, bridge, aux keys) by (model, size)
DISCS = {
    ("ssgan", 32): (JSS.SSGANDiscriminator32, ssgan.SSGANDiscriminator32,
                    jax_params.ssgan_discriminator_state_dict, ("ss_logits",)),
    ("ssgan", 64): (JSS.SSGANDiscriminator64, ssgan.SSGANDiscriminator64,
                    jax_params.ssgan_discriminator_state_dict, ("ss_logits",)),
    ("infomax_gan", 32): (functools.partial(JI.InfoMaxGANDiscriminator32, nrkhs=NRKHS),
                          functools.partial(infomax.InfoMaxGANDiscriminator32, nrkhs=NRKHS),
                          jax_params.infomax_discriminator_state_dict,
                          ("local_proj", "global_proj")),
    ("infomax_gan", 64): (functools.partial(JI.InfoMaxGANDiscriminator64, nrkhs=NRKHS),
                          functools.partial(infomax.InfoMaxGANDiscriminator64, nrkhs=NRKHS),
                          jax_params.infomax_discriminator_state_dict,
                          ("local_proj", "global_proj")),
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch (see test_torch_port_sngan_models.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, what, tol=1e-5):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


def normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def flax_variables(module, seed, *example, **kwargs):
    """Seeded numpy variables in the shapes module.init gives (taken with
    jax.eval_shape: no compile): kernels N(0, 1 / fan_in), u N(0, 1), sigma
    1, then randomize's biases, BatchNorm scales and statistics."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(0)}, *example, **kwargs))

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            std = 1 / np.sqrt(np.prod(leaf.shape[:-1]))
            return (std * rng.standard_normal(leaf.shape)).astype(np.float32)
        if name.endswith("/sigma"):
            return np.ones(leaf.shape, np.float32)
        return rng.standard_normal(leaf.shape).astype(np.float32)

    return randomize(jax.tree_util.tree_map_with_path(fill, shapes), seed)


@functools.cache
def jax_discriminator(model, size, seed=3):
    disc = DISCS[model, size][0](ndf=WIDTH)
    return disc, flax_variables(disc, seed, jnp.zeros((2, size, size, 3)))


def port_discriminator(model, size, v, dtype=torch.float32):
    _, make, bridge, _ = DISCS[model, size]
    d = make(ndf=WIDTH, device="cpu", dtype=dtype)
    d.load_state_dict(bridge(v))
    return d


# --- the losses ---------------------------------------------------------------

def test_rotate_batch_4way_matches_jax_exactly():
    x = normal(0, 3, 5, 5, 2)  # square images; odd sizes show a wrong turn
    imgs, labels = losses.rotate_batch_4way(torch.from_numpy(x))
    want_imgs, want_labels = JL.rotate_batch_4way(jnp.asarray(x))
    np.testing.assert_array_equal(imgs.numpy(), np.asarray(want_imgs))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_labels))
    np.testing.assert_array_equal(imgs[3:6].numpy(), np.rot90(x, 1, axes=(1, 2)))


def test_ss_rotation_loss_matches_jax():
    logits, labels = 3 * normal(1, 16, 4), np.random.default_rng(2).integers(0, 4, 16)
    got = losses.ss_rotation_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    want = JL.ss_rotation_loss(jnp.asarray(logits), jnp.asarray(labels, jnp.int32))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_infonce_loss_matches_jax():
    local, glob = normal(3, 4, 9, 8), normal(4, 4, 8)
    got = losses.infonce_loss(torch.from_numpy(local), torch.from_numpy(glob))
    want = JL.infonce_loss(jnp.asarray(local), jnp.asarray(glob))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# --- the discriminators and the bridges ----------------------------------------

@pytest.mark.parametrize("model,size", sorted(DISCS), ids=[f"{m}-{s}" for m, s in sorted(DISCS)])
def test_discriminator_matches_flax(model, size):
    disc, v = jax_discriminator(model, size)
    x = np.tanh(normal(8, BS, size, size, 3))
    (logits, aux), new = jax.jit(lambda v, x: disc.apply(v, x, update_stats=True,
                                                         mutable=["spectral"]))(v, x)
    d = port_discriminator(model, size, v)
    u0 = {k: t.clone() for k, t in d.state_dict().items() if k.endswith("weight_u")}
    with torch.no_grad():
        d(torch.from_numpy(x))  # update_stats=False stores nothing
        assert all(torch.equal(t, d.state_dict()[k]) for k, t in u0.items())
        got, got_aux = d(torch.from_numpy(x), update_stats=True)
    close(got.numpy(), logits, "logits")
    for key in ("features", *DISCS[model, size][3]):
        assert got_aux[key].shape == aux[key].shape, key
        close(got_aux[key].numpy(), aux[key], key)
    want_u = DISCS[model, size][2]({"params": v["params"], "spectral": new["spectral"]})
    for k in u0:
        np.testing.assert_allclose(d.state_dict()[k].numpy(), want_u[k].numpy(), atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("model", ["ssgan", "infomax_gan"])
def test_bridge_round_trip_through_mimicry_import(model):
    """JAX -> port state_dict -> the JAX package's torch-mimicry importer ->
    JAX: every params leaf and every u equal (sigma, which the port does not
    store, is the importer's recomputation)."""
    _, v = jax_discriminator(model, 32)
    sd = {k: t.numpy() for k, t in DISCS[model, 32][2](v).items()}
    params, colls = MI.import_mimicry_discriminator(sd)
    want = jax.tree_util.tree_flatten_with_path(v["params"])
    got = jax.tree_util.tree_flatten_with_path(params)
    assert [p for p, _ in got[0]] == [p for p, _ in want[0]]
    for (path, w), (_, g) in zip(want[0], got[0]):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))
    want_u = [leaf for path, leaf in jax.tree_util.tree_flatten_with_path(v["spectral"])[0]
              if path[-1].key.endswith("/u")]
    got_u = [leaf for path, leaf in jax.tree_util.tree_flatten_with_path(colls["spectral"])[0]
             if path[-1].key.endswith("/u")]
    assert len(got_u) == len(want_u) > 0
    for g, w in zip(got_u, want_u):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("model,head", [("ssgan", "_SSHead_0"), ("infomax_gan", "_InfoMaxHeads_0")])
def test_bridge_raises_on_unknown_leaves(model, head):
    _, v = jax_discriminator(model, 32)
    bridge = DISCS[model, 32][2]
    extra = {"kernel": np.zeros((2, 2), np.float32)}
    for bad in ({**v["params"], "Extra_0": extra},
                {**v["params"], head: {**v["params"][head], "SNDense_9": {"Dense_0": extra}}}):
        with pytest.raises(ValueError, match="no rule"):
            bridge({"params": bad, "spectral": v["spectral"]})


# --- bf16 ------------------------------------------------------------------------

def _bf16_case(name):
    """(JAX module with dtype bf16, its variables, the port module, the
    input, apply kwargs) for each bf16 case."""
    bf16 = jnp.bfloat16
    if name == "sngan_g":
        mod = JSN.SNGANGenerator32(ngf=WIDTH, dtype=bf16)
        v = flax_variables(mod, 2, jnp.zeros((2, NZ)), train=True)
        port = sngan.SNGANGenerator32(ngf=WIDTH, device="cpu", dtype=torch.bfloat16)
        port.load_state_dict(jax_params.sngan_generator_state_dict(v))
        return mod, v, port.eval(), normal(7, BS, NZ), {"train": False}
    if name in ("ssgan_d", "infomax_d"):
        model = "ssgan" if name == "ssgan_d" else "infomax_gan"
        mod = DISCS[model, 32][0](ndf=WIDTH, dtype=bf16)
        v = jax_discriminator(model, 32)[1]
        port = port_discriminator(model, 32, v, torch.bfloat16)
        return mod, v, port, np.tanh(normal(8, BS, 32, 32, 3)), {"update_stats": False}
    if name == "dcgan_g":
        mod = JD.MNISTDCGANGenerator(nc=3, dtype=bf16)
        v = flax_variables(mod, 5, jnp.zeros((2, 100)), train=True)
        port = mnist_dcgan.MNISTDCGANGenerator(nc=3, device="cpu", dtype=torch.bfloat16)
        port.load_state_dict(jax_params.mnist_dcgan_generator_state_dict(v))
        return mod, v, port.eval(), normal(9, BS, 100), {"train": False}
    mod = JD.MNISTDCGANDiscriminator(nc=3, dtype=bf16)
    v = flax_variables(mod, 6, jnp.zeros((2, 32, 32, 3)))
    port = mnist_dcgan.MNISTDCGANDiscriminator(nc=3, device="cpu", dtype=torch.bfloat16)
    port.load_state_dict(jax_params.mnist_dcgan_discriminator_state_dict(v))
    return mod, v, port.eval(), np.tanh(normal(10, BS, 32, 32, 3)), {"train": False}


def _outputs(out, name):
    """{name: output} of a forward: its image or logits and its heads (the
    DCGAN D's features are a flatten in another layout on each side)."""
    if not isinstance(out, tuple):
        return {"out": out}
    logits, aux = out
    return {"out": logits, **{k: v for k, v in aux.items()
                              if k != "local" and not (name == "dcgan_d" and k == "features")}}


def _err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("name", ["sngan_g", "ssgan_d", "infomax_d", "dcgan_g", "dcgan_d"])
def test_bf16_forward_matches_flax(name):
    """The bf16 compute dtype against the JAX modules': each output within
    2 x (the JAX bf16 output's distance from the JAX fp32 one) + 1e-4, as a
    share of max(1, max|out|): the two packages' bf16 runs are no further
    apart than bf16 rounding moves either from fp32 (measured: G's images
    2.5e-2 apart against a shift of 2.5e-2, logits and heads 1e-4 to 1e-3
    against 8e-4 to 3e-3). Images, logits and heads leave in fp32 on both
    sides, and the port's bf16 run differs from its fp32 run."""
    mod, v, port, x, kwargs = _bf16_case(name)
    fp32_mod = mod.clone(dtype=jnp.float32)
    want = _outputs(jax.jit(lambda v, x: mod.apply(v, x, **kwargs))(v, x), name)
    want32 = _outputs(jax.jit(lambda v, x: fp32_mod.apply(v, x, **kwargs))(v, x), name)
    with torch.no_grad():
        got = _outputs(port(torch.from_numpy(x)), name)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == torch.float32 and want[key].dtype == jnp.float32, key
        shift = _err(want[key], want32[key])
        err = _err(got[key].numpy(), want[key])
        assert 0 < shift and err <= 2 * shift + 1e-4, (key, err, shift)
    fp32 = copy.deepcopy(port)
    for m in fp32.modules():
        if getattr(m, "dtype", None) == torch.bfloat16:
            m.dtype = torch.float32
    with torch.no_grad():
        out32 = _outputs(fp32(torch.from_numpy(x)), name)["out"]
    assert not torch.equal(out32, got["out"])


@pytest.mark.parametrize("dataset", ["cifar10", "celeba"])
def test_get_gan_model_builds_ssgan_and_infomax(dataset):
    """Full width, the twin D, fp32 and bf16, on the CPU."""
    size = 32 if dataset == "cifar10" else 64
    for model, bf16 in ((m, b) for m in ("ssgan", "infomax_gan") for b in (False, True)):
        b = registry.get_gan_model(dataset, model=model, drs=True, bf16=bf16, device="cpu")
        assert (b.model, b.image_size, b.nz) == (model, size, 128)
        dtype = torch.bfloat16 if bf16 else torch.float32
        assert b.gen.l1.dtype == dtype and b.disc.block1.c1.dtype == dtype
        want = {("ssgan", 32): ssgan.SSGANDiscriminator32,
                ("ssgan", 64): ssgan.SSGANDiscriminator64,
                ("infomax_gan", 32): infomax.InfoMaxGANDiscriminator32,
                ("infomax_gan", 64): infomax.InfoMaxGANDiscriminator64}[model, size]
        assert type(b.disc) is type(b.disc_drs) is want
        head = b.disc.l_y if model == "ssgan" else b.disc.local_nn
        assert head.dtype == torch.float32 and head.weight.dtype == torch.float32
        if model == "infomax_gan":
            assert b.disc.local_nn.weight.shape[0] == 1024  # nrkhs
        assert all(p.dtype == torch.float32 for p in b.gen.parameters())


# --- the CLIs --------------------------------------------------------------------

COMMON = ["--device", "cpu", "--batch_size", "4", "--n_dis", "2", "--seed", "3"]
PHASE1 = ["--exp_name", "p1", "--no_schedule_override", "--num_steps", "6",
          "--logit_save_steps", "2", "--save_logit_after", "2", "--stop_save_logit_after", "6"]
PHASE2 = ["--exp_name", "p2", "--baseline_exp_name", "p1", "--p1_step", "6", "--num_steps",
          "9", "--resample_score", "ldr_conf_1.0_ratio_50"]


@pytest.fixture
def narrow(monkeypatch, tmp_path):
    """Width-32 SNGAN / SSGAN / InfoMax (nrkhs 32) in the port's registry, no
    TensorBoard, DRS on 2 warm-up batches, evaluation counts cut to
    N_EVAL with the stand-in featurizer, and a CIFAR-format dataset."""
    for model, (gen, disc) in {
            "sngan": (sngan.SNGANGenerator32, sngan.SNGANDiscriminator32),
            "ssgan": (ssgan.SSGANGenerator32, ssgan.SSGANDiscriminator32),
            "infomax_gan": (infomax.InfoMaxGANGenerator32,
                            functools.partial(infomax.InfoMaxGANDiscriminator32, nrkhs=NRKHS))
    }.items():
        monkeypatch.setitem(registry._GEN_32, model, functools.partial(gen, ngf=WIDTH))
        monkeypatch.setitem(registry._DISC_32, model, functools.partial(disc, ndf=WIDTH))
    monkeypatch.setattr(TT, "Logger", functools.partial(Logger, use_tensorboard=False))
    monkeypatch.setattr(TE, "DRS", functools.partial(DRS, warmup_batches=2))
    evaluate = eval_gan.evaluate_checkpoint

    def cut(metric, num_real_samples=None, num_fake_samples=None, **kw):
        counts = {k: min(n, N_EVAL) for k, n in (("num_real_samples", num_real_samples),
                                                  ("num_fake_samples", num_fake_samples)) if n}
        return evaluate(metric, **counts, **kw)
    monkeypatch.setattr(eval_gan, "evaluate_checkpoint", cut)
    monkeypatch.setattr(eval_gan, "InceptionFeaturizer", lambda **k: StubFeaturizer())
    write_cifar_batches(tmp_path / "data", np.random.default_rng(5).integers(
        0, 256, (N_DATA, 32, 32, 3), np.uint8))
    return COMMON + ["-r", str(tmp_path / "data"), "--work_dir", str(tmp_path)]


def _finite(tr):
    m = {k: float(v) for k, v in tr.metrics.items()}
    assert all(math.isfinite(v) for v in m.values()), m
    return m


def shaped_net_state(module, rngs, example_inputs, tx, **apply_kwargs):
    """The JAX package's create_net_state with zeros in init's shapes (taken
    with jax.eval_shape): its loader only needs the tree, which the port's
    checkpoint then fills; an eager Flax init costs seconds on the CPU."""
    shapes = jax.eval_shape(lambda: module.init(rngs, *example_inputs, **apply_kwargs))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params = variables.pop("params")
    return JNetState(params, variables, tx.init(params), jnp.zeros((), jnp.int32))


@pytest.mark.parametrize("model", ["ssgan", "infomax_gan"])
def test_phase1_phase2_and_eval_gan_drs(model, narrow, tmp_path, monkeypatch):
    model_args = ["--model", model]
    tr1 = train_mimicry_phase1.main(narrow + PHASE1 + model_args)
    assert {"errD", "errG", "D(x)", "D(G(z))"} == set(_finite(tr1))
    assert tr1.global_step == 6 and tr1.d.count == 12 and tr1.cfg.model == model
    with open(tmp_path / "p1" / "logits_netD_eval.pkl", "rb") as f:
        assert list(pickle.load(f)) == [2, 4, 6]
    tr2 = train_mimicry_phase2.main(narrow + PHASE2 + model_args)
    assert {"errD", "errG", "errD_drs"} <= set(_finite(tr2))
    assert tr2.global_step == 9 and tr2.d.count == tr2.d_drs.count == 18
    head = "l_y.weight" if model == "ssgan" else "global_nn.2.weight"
    assert head in tr2.d_drs.module.state_dict()

    results = eval_gan_drs.main(["-r", str(tmp_path / "data"), "--work_dir", str(tmp_path),
                                 "--exp_name", "p2", "--netG_ckpt_step", "9", "--model", model,
                                 "--device", "cpu"])
    assert [r["metric"] for r in results] == ["fid", "inception_score", "pr"]
    assert all(r["use_drs"] for r in results)
    for r in results:
        scores = [v for s in r["scores"].values() for v in
                  (s.values() if isinstance(s, dict) else np.ravel(s))]
        assert scores and all(math.isfinite(v) for v in scores), r

    # the JAX package's loader restores the port's phase-2 run
    jax_gen = JSN.SNGANGenerator32(ngf=WIDTH)
    jax_d = (JSS.SSGANDiscriminator32(ndf=WIDTH) if model == "ssgan"
             else JI.InfoMaxGANDiscriminator32(ndf=WIDTH, nrkhs=NRKHS))
    bundle = dataclasses.replace(jax_get_gan_model("cifar10", model=model, drs=True),
                                 gen=jax_gen, disc=jax_d, disc_drs=jax_d)
    monkeypatch.setattr(JE, "create_net_state", shaped_net_state)
    g_state, d_state = JE.load_eval_models(bundle, tmp_path / "p2", 9, use_drs=True)
    gen, disc = TE.load_eval_models(registry.get_gan_model("cifar10", model=model, drs=True,
                                                           device="cpu"),
                                    tmp_path / "p2", 9, use_drs=True)
    z = normal(0, 6, NZ)
    want_x = np.asarray(JE.make_gen_fn(bundle, g_state)(z))
    close(TE.make_gen_fn(gen)(torch.from_numpy(z)).numpy(), want_x, "G(z)")
    want = np.asarray(JE.make_disc_fn(bundle.disc_drs, d_state)(want_x))
    close(TE.make_disc_fn(disc)(torch.from_numpy(want_x.copy())).numpy(), want, "netD_drs(x)")


@pytest.mark.parametrize("flags",
                         [["--simultaneous_g"], ["--bf16"], ["--bf16", "--simultaneous_g"]],
                         ids=["simultaneous_g", "bf16", "bf16_simultaneous_g"])
def test_simultaneous_g_and_bf16_through_both_phases(flags, narrow):
    """The flags reach the trainer and the models, in phase 1 and phase 2
    (twin D); every metric finite; the simultaneous step's D and G update
    counts as the reference's."""
    bf16, sim = "--bf16" in flags, "--simultaneous_g" in flags
    dtype = torch.bfloat16 if bf16 else torch.float32
    for argv in (PHASE1, PHASE2):
        tr = train_mimicry_phase1.main(narrow + argv + flags) if argv is PHASE1 else \
            train_mimicry_phase2.main(narrow + argv + flags)
        _finite(tr)
        assert tr.cfg.simultaneous_g is sim and not tr.cfg.concat_d and not tr.cfg.fuse_g
        assert tr.g.module.l1.dtype == tr.d.module.block2.c1.dtype == dtype
        assert tr.d.count == 2 * tr.global_step == 2 * tr.g.count
        if tr.d_drs is not None:
            assert tr.d_drs.count == tr.d.count and tr.d_drs.module.block1.c2.dtype == dtype


@pytest.fixture
def mnist_dir(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    write_mnist(tmp_path / "dataset/colour_mnist", n=120)
    monkeypatch.setattr(TT, "Logger", functools.partial(Logger, use_tensorboard=False))
    return ["--device", "cpu", "--batch_size", "8", "--num_data", "120", "--seed", "3",
            "--num_steps", "3", "--logit_save_steps", "3"]


def test_mnist_scripts_honour_bf16_and_ignore_simultaneous_g(mnist_dir, tmp_path):
    tr = train_mimicry_color_mnist_phase1.main(mnist_dir + ["--exp_name", "bf16", "--bf16"])
    _finite(tr)
    assert tr.g.module.fc.dtype == tr.d.module.conv[0].dtype == torch.bfloat16
    runs = [train_mimicry_color_mnist_phase1.main(mnist_dir + ["--exp_name", name] + extra)
            for name, extra in (("plain", []), ("sim", ["--simultaneous_g"]))]
    assert not any(r.cfg.simultaneous_g for r in runs)
    for net in ("netG", "netD"):
        a, b = (torch.load(tmp_path / "exp_results" / name / "checkpoints" / net /
                           f"{net}_3_steps.pth", weights_only=True)["model_state_dict"]
                for name in ("plain", "sim"))
        assert all(torch.equal(a[k], b[k]) for k in a), net


def test_inclusive_script_takes_neither_flag(mnist_dir, monkeypatch):
    """As the root train_mimicry_inclusive.py: --bf16 and --simultaneous_g
    are accepted and passed on to nothing (the trainer is a stand-in that
    records what it gets)."""
    seen = {}

    class Stub(SimpleNamespace):
        def __init__(self, **kw):
            super().__init__(**kw)
            seen.update(kw)

        def train(self):
            return self

    monkeypatch.setattr(train_mimicry_inclusive, "InclusiveTrainer", Stub)
    monkeypatch.setattr(train_mimicry_inclusive, "plot_color_mnist_generator", lambda *a, **k: 0)
    train_mimicry_inclusive.main(mnist_dir + ["--exp_name", "incl", "--bf16", "--simultaneous_g"])
    assert "step_fusions" not in seen
    assert seen["bundle"].gen.fc.dtype == torch.float32
