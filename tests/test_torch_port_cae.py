"""The port's CAE reconstruction-error protocol (diagan_tpu_torch.models.cae,
eval.cae_protocol, data.generated, cli.train_cae / eval_ae_score /
train_cae_inclusive) against the JAX package's, on the CPU.

Weights: the Flax CAE variables from jax.eval_shape filled with seeded
numpy (kernels at the CAE's own lecun-normal scale, 1 / sqrt(fan_in);
biases, BatchNorm scales, biases and statistics random), bridged by
utils/jax_params.py cae_state_dict.

  - Forwards of CAE32 and CAE64 with nc 1 and 3, batch 16. Eval mode, fp32
    against fp32: within 1e-5 x max(1, max|out|). Train mode on batch
    statistics: both packages in float64 within 1e-9 x max(1, max|out|),
    and the port's fp32 within 1e-5 x max(1, max|out|) of the JAX float64
    output (each package's fp32 train-mode output is ~8e-6 from float64
    here; the two fp32 outputs differ by up to 1.03e-5 at CAE64). The
    running statistics after one train-mode forward within 1e-6 (fp32).
  - train_cae: 2 epochs, 256 generated and 200 real 32 px images, batch 32,
    the same seed (numpy permutations on both sides): the RE matrix at
    1e-5 x max(1, max RE). Both packages run in float64 on the same float
    images: the JAX package's jitted x / 127.5 - 1 rounds 205 of the 256
    uint8 codes one ulp away from the division the port (and numpy) does,
    and 16 Adam steps at lr 1e-3 grow that ulp to ~1e-5 in RE (as they grow
    it between two port runs). The port's uint8 path equals its float path
    on the exactly dequantized images, bit for bit.
  - The generated-image pickle (generate_dataset, save_generated) the same
    bytes as the JAX package's; load_generated of an NCHW pickle;
    eval_ae_score's dict exact.
  - The CLIs on tiny Colored-MNIST and MNIST-FMNIST runs: train_cae through
    DRS for a run with a twin D and through the plain sampler otherwise,
    eval_ae_score's CSV equal to the JAX package's eval_ae_score.py on the
    same files, the argparse surfaces of the root scripts plus --device,
    and no card without --device cpu raising. The CLIs draw 300 images (the
    scripts' 50,000 take minutes here) and DRS warms up on 2 batches of 50.
"""
import functools
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_port_mnist_cli import COMMON, PHASE1, PHASE2, mnist_dir  # noqa: E402,F401
from test_torch_port_sngan_models import randomize  # noqa: E402

import eval_ae_score as root_eval_ae_score  # noqa: E402
from diagan_tpu.data import generated as JG  # noqa: E402
from diagan_tpu.eval import cae_protocol as JC  # noqa: E402
from diagan_tpu.models import cae as J  # noqa: E402
from diagan_tpu_torch.cli import (  # noqa: E402
    eval_ae_score,
    train_cae,
    train_cae_inclusive,
    train_mimicry_color_mnist_phase1,
    train_mimicry_color_mnist_phase2,
    train_mimicry_mnist_fmnist_phase1,
)
from diagan_tpu_torch.data import generated as TG  # noqa: E402
from diagan_tpu_torch.eval import cae_protocol as TC  # noqa: E402
from diagan_tpu_torch.eval.drs import DRS  # noqa: E402
from diagan_tpu_torch.models import cae as T  # noqa: E402
from diagan_tpu_torch.utils import jax_params  # noqa: E402

BS = 16
N_GEN_CLI = 300
CASES = {"cae32_nc1": (32, 1), "cae32_nc3": (32, 3), "cae64_nc1": (64, 1), "cae64_nc3": (64, 3)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch (see test_torch_port_sngan_models.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cae_variables(size, nc, seed=1):
    """(Flax CAE, its variables) with seeded numpy leaves (module docstring)."""
    module = (J.CAE32 if size == 32 else J.CAE64)(nc)
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0),
                                                jnp.zeros((2, size, size, nc)), train=True))

    def fill(path, leaf):
        if str(path[-1].key) == "kernel":
            std = 1 / np.sqrt(np.prod(leaf.shape[:-1]))
            return (std * rng.standard_normal(leaf.shape)).astype(np.float32)
        return rng.standard_normal(leaf.shape).astype(np.float32)

    return module, randomize(jax.tree_util.tree_map_with_path(fill, shapes), seed)


def port_cae(variables, size, nc, dtype=torch.float32):
    cae = (T.CAE32 if size == 32 else T.CAE64)(nc, device="cpu")
    cae.load_state_dict(jax_params.cae_state_dict(variables))
    return cae.to(dtype)


def images(seed, n, size, nc):
    return np.tanh(np.random.default_rng(seed).standard_normal((n, size, size, nc))
                   ).astype(np.float32)


def within(got, want, tol, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())), err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_cae_forward_matches_flax(case):
    size, nc = CASES[case]
    module, v = cae_variables(size, nc)
    x = images(7, BS, size, nc)
    out_eval = jax.jit(lambda v, x: module.apply(v, x, train=False))(v, x)
    _, new = jax.jit(lambda v, x: module.apply(v, x, train=True, mutable=["batch_stats"]))(v, x)
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), v)
        out64, _ = jax.jit(lambda v, x: module.apply(v, x, train=True, mutable=["batch_stats"]))(
            v64, x.astype(np.float64))
        out64 = np.asarray(out64)
    cae = port_cae(v, size, nc)
    with torch.no_grad():
        got_eval = cae.eval()(torch.from_numpy(x))
        got = cae.train()(torch.from_numpy(x))
        got64 = port_cae(v, size, nc, torch.float64).train()(torch.from_numpy(x).double())
    assert got.shape == (BS, size, size, nc)
    within(got_eval.numpy(), out_eval, 1e-5, f"{case} eval")
    within(got64.numpy(), out64, 1e-9, f"{case} train, float64")
    within(got.numpy(), out64, 1e-5, f"{case} train, fp32 against float64")
    want = jax_params.cae_state_dict({**v, **jax.device_get(new)})
    stats = {k: t for k, t in cae.state_dict().items() if "running" in k}
    assert len(stats) == 4 * (size // 32 + 2)  # mean and var of 2 x num_stages BatchNorms
    for k, t in stats.items():
        np.testing.assert_allclose(t.numpy(), want[k].numpy(), atol=1e-6, err_msg=k)
        assert not np.array_equal(t.numpy(), jax_params.cae_state_dict(v)[k].numpy()), k


def test_cae_bridge_consumes_every_leaf():
    module, v = cae_variables(32, 3)
    v = jax.device_get(v)
    sd = jax_params.cae_state_dict(v)
    assert set(sd) == set(T.CAE32(3, device="cpu").state_dict())
    v["params"]["decode"]["Extra_0"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="no rule for Flax leaf params/decode/Extra_0"):
        jax_params.cae_state_dict(v)


def test_get_ae_model_dispatch():
    assert T.get_ae_model("color_mnist", device="cpu").convs[0].in_channels == 3
    assert T.get_ae_model("mnist_fmnist", in_channels=3, device="cpu").convs[0].in_channels == 1
    cae64 = T.get_ae_model("celeba", device="cpu")
    assert len(cae64.convs) == 4 and cae64.fc_dec.out_features == 512 * 16
    a, b = T.CAE32(seed=5, device="cpu"), T.CAE32(seed=5, device="cpu")
    assert all(torch.equal(a.state_dict()[k], t) for k, t in b.state_dict().items())
    with pytest.raises(ValueError):
        T.get_ae_model("ffhq", device="cpu")


def jit_dequantized(u8):
    """The JAX package's jitted x / 127.5 - 1 of uint8 codes, as float64."""
    table = np.asarray(jax.jit(lambda x: x.astype(jnp.float32) / 127.5 - 1.0)(
        np.arange(256, dtype=np.uint8)))
    return table[u8].astype(np.float64)


def test_train_cae_matches_jax(tmp_path):
    nc = 3
    module, v = cae_variables(32, nc)
    rng = np.random.default_rng(5)
    gen = jit_dequantized(rng.integers(0, 256, (256, 32, 32, nc), dtype=np.uint8))
    real = jit_dequantized(rng.integers(0, 256, (200, 32, 32, nc), dtype=np.uint8))
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), jax.device_get(v))

        class Standin:  # the JAX train_cae inits the CAE: hand it these weights
            def init(self, *a, **k):
                return jax.tree.map(np.array, v64)

            def apply(self, *a, **k):
                return module.apply(*a, **k)

        want = JC.train_cae(Standin(), gen, real, tmp_path / "jax", epochs=2, batch_size=32,
                            seed=3)
    cae = port_cae(v, 32, nc, torch.float64)
    got = TC.train_cae(cae, gen, real, tmp_path / "port", epochs=2, batch_size=32, seed=3,
                       model_save_epochs=1)
    assert got.shape == want.shape == (200, 2)
    within(got, want, 1e-5, "RE matrix")
    assert not np.allclose(got[:, 0], got[:, 1])  # the CAE trained
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "cae_training_loss.npy"), got)
    saved = torch.load(tmp_path / "port" / "cae_epoch-2.pth", weights_only=True)
    assert all(torch.equal(saved[k], t) for k, t in cae.state_dict().items())
    assert (tmp_path / "port" / "cae_epoch-1.pth").is_file()


def test_train_cae_uint8_path_is_the_float_path(tmp_path):
    rng = np.random.default_rng(6)
    gen = rng.integers(0, 256, (64, 32, 32, 1), dtype=np.uint8)
    real = rng.integers(0, 256, (40, 32, 32, 1), dtype=np.uint8)

    def deq(u8):
        return u8.astype(np.float32) / np.float32(127.5) - np.float32(1.0)

    runs = [TC.train_cae(T.CAE32(1, seed=2, device="cpu"), g, r, tmp_path / str(k), epochs=1,
                         batch_size=16, seed=4)
            for k, (g, r) in enumerate(((gen, real), (deq(gen), deq(real))))]
    assert runs[0].dtype == np.float32
    np.testing.assert_array_equal(runs[0], runs[1])


def test_generated_pickles_match_the_jax_package(tmp_path):
    u8 = np.random.default_rng(8).integers(0, 256, (37, 32, 32, 3), dtype=np.uint8)
    calls = []

    def sampler(n, return_uint8=False):
        calls.append((n, return_uint8))
        return np.concatenate([u8, u8])  # a sampler may return more than asked

    for name, gen_ds in (("jax", JC.generate_dataset), ("port", TC.generate_dataset)):
        out = gen_ds(sampler, tmp_path / name / "g.pkl", num_images=37)
        np.testing.assert_array_equal(out, u8)
    assert calls == [(37, True)] * 2
    assert (tmp_path / "jax" / "g.pkl").read_bytes() == (tmp_path / "port" / "g.pkl").read_bytes()
    JG.save_generated(tmp_path / "jax.pkl", u8)
    TG.save_generated(tmp_path / "port.pkl", u8)
    assert (tmp_path / "jax.pkl").read_bytes() == (tmp_path / "port.pkl").read_bytes()
    with open(tmp_path / "nchw.pkl", "wb") as f:
        pickle.dump(u8.transpose(0, 3, 1, 2), f)
    for path in ("port.pkl", "nchw.pkl"):
        ours, theirs = TG.load_generated(tmp_path / path), JG.load_generated(tmp_path / path)
        assert ours.name == theirs.name == "generated"
        np.testing.assert_array_equal(ours.images, u8)
        np.testing.assert_array_equal(ours.images, theirs.images)


def test_eval_ae_score_is_exact(tmp_path):
    rng = np.random.default_rng(9)
    for name in ("base", "res"):
        np.save(tmp_path / f"{name}.npy", rng.random((50, 3)).astype(np.float32))
    mask = rng.random(50) < 0.2
    args = (tmp_path / "base.npy", tmp_path / "res.npy", mask)
    assert TC.eval_ae_score(*args) == JC.eval_ae_score(*args)


def test_cae_optimizer_is_the_jax_chain():
    """One update from the same parameters and gradients: L2 added before
    Adam's moments (eps 1e-7), on every parameter."""
    rng = np.random.default_rng(10)
    p0, g0 = rng.standard_normal(7), rng.standard_normal(7)
    with jax.enable_x64(True):
        tx = JC.make_cae_tx()
        upd, _ = tx.update(jnp.asarray(g0), tx.init(jnp.asarray(p0)), jnp.asarray(p0))
        want = p0 + np.asarray(upd)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = TC.make_cae_optimizer([p])
    p.grad = torch.from_numpy(g0.copy())
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(), want, rtol=0, atol=1e-15)


def run_cae_cli(cli, argv, monkeypatch):
    """cli.main(argv) drawing N_GEN_CLI images; returns (RE, the sampler's
    class)."""
    used = []
    monkeypatch.setattr(train_cae, "generate_dataset",
                        functools.partial(TC.generate_dataset, num_images=N_GEN_CLI))
    monkeypatch.setattr(train_cae, "DRS", lambda *a, **k: used.append("DRS") or DRS(
        *a, **{**k, "batch_size": 50, "warmup_batches": 2}))
    sampler = train_cae.Sampler
    monkeypatch.setattr(train_cae, "Sampler", lambda *a, **k: used.append("Sampler") or sampler(
        *a, **k))
    re = cli.main(argv)
    return re, used


def test_cae_clis_on_colour_and_fmnist_runs(mnist_dir, monkeypatch):
    exp = mnist_dir / "exp_results"
    train_mimicry_color_mnist_phase1.main(COMMON + PHASE1)
    train_mimicry_color_mnist_phase2.main(COMMON + PHASE2 + [
        "--exp_name", "p2", "--resample_score", "ldr_conf_1.0_ratio_50"])
    # the baseline to the phase-2 run's last step, as chip_smoke.py does
    base = train_mimicry_color_mnist_phase1.main(COMMON + PHASE1[2:] + [
        "--num_steps", "9", "--auto_resume"])
    assert base.global_step == 9
    cae_args = ["-d", "color_mnist", "-r", "dataset/colour_mnist", "--device", "cpu",
                "--netG_step", "9", "--epochs", "2", "--batch_size", "32",
                "--num_data", "300", "--seed", "3"]
    res = {}
    for run, want_sampler in (("colour_mnist", "Sampler"), ("p2", "DRS")):
        re, used = run_cae_cli(train_cae, cae_args + ["--exp_name", run], monkeypatch)
        assert used == [want_sampler], (run, used)
        res[run] = re
        assert re.shape == (300, 2) and np.isfinite(re).all()
        d = exp / run
        with open(d / "netG_9_steps_seed3_generated_dataset.pkl", "rb") as f:
            gen = pickle.load(f)
        assert gen.dtype == np.uint8 and gen.shape == (N_GEN_CLI, 32, 32, 3)
        np.testing.assert_array_equal(
            np.load(d / "cae_checkpoints" / "9_steps_seed3" / "cae_training_loss.npy"), re)
        with open(d / "netG_9_steps_seed3_epoch2_ae_score.pkl", "rb") as f:
            np.testing.assert_array_equal(pickle.load(f), re[:, -1])
        for side in ("low", "high"):
            assert (d / f"netG_9_steps_seed3_epoch2_ae_score_ae_score_{side}.png").is_file()

    # --generated_dataset_path skips generation
    again, used = run_cae_cli(train_cae_inclusive, cae_args + [
        "--exp_name", "colour_mnist", "--generated_dataset_path",
        str(exp / "colour_mnist" / "netG_9_steps_seed3_generated_dataset.pkl")], monkeypatch)
    np.testing.assert_array_equal(again, res["colour_mnist"])

    score = ["-d", "color_mnist", "--baseline_exp_path", str(exp / "colour_mnist"),
             "--resample_exp_path", str(exp / "p2"), "--p1_step", "6", "--p2_step", "9",
             "--resample_score", "ldr_conf_1.0_ratio_50", "--use_loss", "--seed", "3",
             "--num_data", "300"]
    rows = eval_ae_score.main(score + ["--name", "port", "--device", "cpu"])
    assert [r[2] for r in rows] == ["all", "green"]
    monkeypatch.setattr(sys, "argv", ["eval_ae_score.py"] + score + ["--name", "jax"])
    root_eval_ae_score.main()
    ours = (mnist_dir / "re_color_mnist_port.csv").read_text()
    theirs = (mnist_dir / "re_color_mnist_jax.csv").read_text()
    assert ours == theirs and ours.startswith("Ratio,Seed,Type,Baseline,Resample,Difference(%)")
    eval_ae_score.main(score + ["--name", "port", "--device", "cpu"])  # appends, no header
    assert (mnist_dir / "re_color_mnist_port.csv").read_text() == ours + ours.split("\n", 1)[1]

    train_mimicry_mnist_fmnist_phase1.main(COMMON + PHASE1 + ["--exp_name", "base"])
    re, used = run_cae_cli(train_cae, ["-d", "mnist_fmnist", "-r", "dataset/mnist_fmnist",
                                       "--device", "cpu", "--exp_name", "base", "--netG_step",
                                       "6", "--epochs", "2", "--batch_size", "32",
                                       "--num_data", "300", "--seed", "3"], monkeypatch)
    assert used == ["Sampler"] and re.shape == (300, 2) and np.isfinite(re).all()
    with open(exp / "base" / "netG_6_steps_seed3_generated_dataset.pkl", "rb") as f:
        assert pickle.load(f).shape == (N_GEN_CLI, 32, 32, 1)


def test_cli_flags_match_the_root_scripts():
    """The CAE and Inclusive CLIs keep the root scripts' argparse surfaces
    (option strings, defaults, types, actions), plus --device; captured live
    by scripts/dump_argparse.py."""
    repo = Path(__file__).resolve().parents[1]
    names = ["train_cae", "eval_ae_score", "train_cae_inclusive", "train_mimicry_inclusive"]
    saved_path = list(sys.path)
    sys.path.insert(0, str(repo / "scripts"))
    try:
        from dump_argparse import capture_script

        want = [capture_script(str(repo / f"{n}.py")) for n in names]
        got = [capture_script(str(repo / "diagan_tpu_torch" / "cli" / f"{n}.py")) for n in names]
    finally:
        sys.path[:] = saved_path
        sys.modules.pop("dump_argparse", None)
    for name, ours, theirs in zip(names, got, want):
        assert len(theirs) >= 5, name
        device = ours.pop("--device")
        assert device["default"] == "cuda" and device["type"] == "str"
        assert ours == theirs, name


@pytest.mark.parametrize("entry", [
    lambda: T.CAE32(),
    lambda: T.get_ae_model("celeba"),
    lambda: train_cae.main(["--netG_step", "1", "--work_dir", "unused"]),
    lambda: train_cae_inclusive.main(["--netG_step", "1", "--work_dir", "unused"]),
    lambda: eval_ae_score.main(["--use_loss"]),
], ids=["cae32", "get_ae_model", "train_cae_cli", "train_cae_inclusive_cli",
        "eval_ae_score_cli"])
def test_entry_points_without_device_raise_when_no_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
