"""The Colored-MNIST / MNIST-FMNIST Dia-GAN path and the 25-Gaussians toy
through the port's CLIs, on the CPU, at the models' own widths, against the
JAX package.

  - Colored-MNIST: cli.train_mimicry_color_mnist_phase1 (6 steps, batch 8,
    train-mode sweeps at 2, 4 and 6 over 300 images), phase2 (to step 9,
    ldr_conf_1.0_ratio_50, the twin DRS D, the DRS red/green counts) and
    phase2_gold (to step 9): the pickle's keys and format are the JAX
    package's and its calculate_scores (the JAX mnist_scripts.phase2's
    scoring) reads it to the port's scores; the JAX package's torch importer
    (what its restore_net does with a torch file) reads the port's phase-2
    checkpoints (the DCGAN's reference layout) to the port's G(z) and
    netD_drs(x) in eval mode;
    plot_color_mnist_generator's counts equal the JAX function's on the
    same images.
  - MNIST-FMNIST: the phase-1 / phase-2 --gold / phase2_gold trio, and a
    PacGAN phase 1 (--num_pack 2), which records no logits.
  - Resume: a phase 1 stopped at step 3 and resumed with --auto_resume
    gives the uninterrupted run's weights, Adam state and logit pickle, bit
    for bit.
  - The two bias probes (1 epoch, 140 images) and cli.train_mimicry_phase1
    -d 25gaussian (500 steps, the scatter at step 500, sweeps of the 10,000
    points).
  - The eight CLIs keep the root scripts' argparse surfaces plus --device.
MNIST comes from idx files of the procedural digits written here (the
scripts' roots are relative, so each test runs in its own directory); DRS
runs at batch 50 and warms up on 2 batches (the scripts' 50 batches of 250
take minutes here), the colour plots draw 100 samples (the scripts' 1000)
and the probes train one step of 128 on 140 images.
"""
import functools
import math
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_port_mnist_data import write_mnist  # noqa: E402

import jax  # noqa: E402
from diagan_tpu.models.registry import get_gan_model as jax_get_gan_model  # noqa: E402
from diagan_tpu.score import calculate_scores as jax_calculate_scores  # noqa: E402
from diagan_tpu.utils import plot as JPL  # noqa: E402
from diagan_tpu.utils import torch_import as TI  # noqa: E402
from diagan_tpu_torch.cli import (  # noqa: E402
    mnist_scripts,
    train_color_mnist_feature,
    train_mimicry_color_mnist_phase1,
    train_mimicry_color_mnist_phase2,
    train_mimicry_color_mnist_phase2_gold,
    train_mimicry_mnist_fmnist_phase1,
    train_mimicry_mnist_fmnist_phase2,
    train_mimicry_mnist_fmnist_phase2_gold,
    train_mimicry_phase1,
    train_mnist_fmnist_feature,
)
from diagan_tpu_torch.eval import drs as TD  # noqa: E402
from diagan_tpu_torch.eval.drs import DRS  # noqa: E402
from diagan_tpu_torch.eval import evaluate as TE  # noqa: E402
from diagan_tpu_torch.models.registry import get_gan_model  # noqa: E402
from diagan_tpu_torch.score import calculate_scores  # noqa: E402
from diagan_tpu_torch.train import trainer as TT  # noqa: E402
from diagan_tpu_torch.train.logger import Logger  # noqa: E402
from diagan_tpu_torch.utils import plot as TPL  # noqa: E402

N_DATA, N_PLOT = 300, 100
COMMON = ["--device", "cpu", "--batch_size", "8", "--num_data", str(N_DATA), "--seed", "3"]
PHASE1 = ["--num_steps", "6", "--logit_save_steps", "2"]
PHASE2 = ["--p1_step", "6", "--num_steps", "9"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch (see test_torch_port_sngan_models.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def mnist_dir(monkeypatch, tmp_path):
    """A working directory with the scripts' default roots holding MNIST idx
    files, no TensorBoard, DRS at batch 50 on 2 warm-up batches, 100 plotted
    samples."""
    monkeypatch.chdir(tmp_path)
    for root in ("dataset/colour_mnist", "dataset/mnist_fmnist"):
        write_mnist(tmp_path / root, n=N_DATA)  # FashionMNIST reads the same files here
    monkeypatch.setattr(TT, "Logger", functools.partial(Logger, use_tensorboard=False))
    monkeypatch.setattr(TD, "DRS", lambda *a, **k: DRS(*a, **{**k, "batch_size": 50,
                                                            "warmup_batches": 2}))
    monkeypatch.setattr(mnist_scripts, "plot_color_mnist_generator",
                        functools.partial(TPL.plot_color_mnist_generator, num_images=N_PLOT))
    return tmp_path


def finite(tr):
    m = {k: float(v) for k, v in tr.metrics.items()}
    assert all(math.isfinite(v) for v in m.values()), m
    return m


def check_pickle(path, steps, n=N_DATA):
    with open(path, "rb") as f:
        logits = pickle.load(f)
    assert list(logits) == steps and all(type(k) is int for k in logits)
    assert all(type(v) is np.ndarray and v.dtype == np.float64 and v.shape == (n,)
               and np.isfinite(v).all() for v in logits.values())
    return logits


def test_color_mnist_trio_against_the_jax_package(mnist_dir):
    exp = mnist_dir / "exp_results"
    tr1 = train_mimicry_color_mnist_phase1.main(COMMON + PHASE1)
    assert tr1.global_step == 6 and set(finite(tr1)) == {"errD", "errG", "D(x)", "D(G(z))"}
    assert sum(tr1.channel_counts) == N_PLOT
    run1 = exp / "colour_mnist"
    logits = check_pickle(run1 / "logits_netD_train.pkl", [2, 4, 6])
    assert not (run1 / "logits_netD_eval.pkl").exists()
    ours, theirs = (calculate_scores(logits, start_epoch=6 - 5000, end_epoch=6),
                    jax_calculate_scores(logits, start_epoch=6 - 5000, end_epoch=6))
    assert sorted(ours) == sorted(theirs)
    for key in theirs:
        np.testing.assert_array_equal(np.asarray(ours[key]), np.asarray(theirs[key]), key)

    tr2 = train_mimicry_color_mnist_phase2.main(COMMON + PHASE2 + [
        "--exp_name", "p2", "--resample_score", "ldr_conf_1.0_ratio_50"])
    assert tr2.global_step == 9 and tr2.d_drs.count == tr2.d.count == 9
    assert "errD_drs" in finite(tr2)
    assert sum(tr2.channel_counts) == sum(tr2.drs_channel_counts) == N_PLOT
    assert tr2.drs.proposed > N_PLOT and 0 < tr2.drs.accepted
    run2 = exp / "p2"
    for name in ["p2_resampled_train_data_p2.png", "p2-eval_p2_channel_counts.png",
                 "p2-eval_drs_percent80_p2_channel_counts.png", "p2-eval_p2_samples.png"] + [
            f"p2_-4994-6_score_{m}_sort.png" for m in ("ldr", "ldrm", "ldrv", "ldrd")]:
        assert (run2 / name).is_file(), name
    assert not list(run2.glob("logits_*.pkl"))

    # the JAX package's torch importer (its restore_net path for a torch file)
    # reads the port's phase-2 checkpoints
    jax_vars = {}
    for net in ("netG", "netD_drs"):
        sd, step = TI.load_torch_state_dict(run2 / "checkpoints" / net / f"{net}_9_steps.pth")
        params, colls = TI.convert_state_dict(sd)
        jax_vars[net] = {"params": params, **colls}
        assert step == 9
    bundle = jax_get_gan_model("color_mnist", drs=True)
    gen, disc = TE.load_eval_models(get_gan_model("color_mnist", drs=True, device="cpu"),
                                    run2, 9, use_drs=True)
    z = np.random.default_rng(0).standard_normal((6, 100)).astype(np.float32)
    want_x = np.asarray(jax.jit(lambda v, z: bundle.gen.apply(v, z, train=False))(
        jax_vars["netG"], z))
    got_x = TE.make_gen_fn(gen)(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got_x, want_x, rtol=0, atol=1e-5)
    want = np.asarray(jax.jit(lambda v, x: bundle.disc_drs.apply(v, x, train=False)[0])(
        jax_vars["netD_drs"], want_x))
    got = TE.make_disc_fn(disc)(torch.from_numpy(want_x.copy())).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, float(np.abs(want).max())))

    # the channel counts: the JAX function on the same images
    imgs = np.random.default_rng(1).uniform(-1, 1, (40, 8, 8, 3)).astype(np.float32)
    imgs[:, :, :, 0] += np.linspace(-0.3, 0.3, 40)[:, None, None]
    counts = TPL.plot_color_mnist_generator(lambda n: imgs[:n], run2, "x", len(imgs))
    assert counts == JPL.plot_color_mnist_generator(lambda n: imgs[:n], run2, "x", len(imgs))
    assert min(counts) > 5

    tr3 = train_mimicry_color_mnist_phase2_gold.main(COMMON + PHASE2 + ["--exp_name", "p2g"])
    assert tr3.global_step == 9 and tr3.d_drs is None and tr3.cfg.gold
    finite(tr3)
    assert sum(tr3.channel_counts) == N_PLOT and (exp / "p2g" / "p2g-eval_p2_samples.png").is_file()


def test_mnist_fmnist_trio_and_pacgan(mnist_dir):
    exp = mnist_dir / "exp_results"
    tr1 = train_mimicry_mnist_fmnist_phase1.main(COMMON + PHASE1 + ["--exp_name", "base"])
    assert tr1.bundle.nc == 1 and tr1.bundle.model == "dcgan"
    check_pickle(exp / "base" / "logits_netD_train.pkl", [2, 4, 6])
    base = ["--baseline_exp_name", "base"]
    tr2 = train_mimicry_mnist_fmnist_phase2.main(COMMON + PHASE2 + base + [
        "--exp_name", "p2", "--gold", "--resample_score", "ldr_conf_1.0_ratio_50"])
    assert tr2.cfg.gold and tr2.cfg.gold_step == 6 and tr2.d_drs.count == 9
    assert tr2.source.weights is not None and "errD_drs" in finite(tr2)
    tr3 = train_mimicry_mnist_fmnist_phase2_gold.main(COMMON + PHASE2 + base + [
        "--exp_name", "p2g"])
    assert tr3.cfg.gold and tr3.global_step == 9
    finite(tr3)

    pac = train_mimicry_color_mnist_phase1.main(COMMON + PHASE1 + [
        "--exp_name", "pac", "--num_pack", "2"])
    assert pac.bundle.disc.num_pack == 2 and pac.bundle.disc.conv[0].in_channels == 6
    assert not list((exp / "pac").glob("logits_*.pkl"))  # PacGAN records none
    finite(pac)


def run_state(run, step):
    out = {}
    for net in ("netG", "netD"):
        raw = torch.load(run / "checkpoints" / net / f"{net}_{step}_steps.pth", weights_only=True)
        out[net] = (raw["model_state_dict"], raw["optimizer_state_dict"]["state"],
                    raw["update_count"])
    with open(run / "logits_netD_train.pkl", "rb") as f:
        out["logits"] = pickle.dumps(pickle.load(f))
    return out


def test_auto_resume_is_bit_for_bit(mnist_dir):
    """Phase 1 to step 3, then --auto_resume to step 6, against 6 steps in
    one run: the same weights (BatchNorm statistics included), Adam state,
    update counts and train-mode logits (the step's draws and dropout masks
    come from (seed, step), a sweep's masks from (seed + 2, step))."""
    exp = mnist_dir / "exp_results"
    train_mimicry_color_mnist_phase1.main(COMMON + PHASE1 + ["--exp_name", "full"])
    short = train_mimicry_color_mnist_phase1.main(COMMON + ["--num_steps", "3",
                                                            "--logit_save_steps", "2"])
    assert short.global_step == 3
    resumed = train_mimicry_color_mnist_phase1.main(COMMON + PHASE1 + ["--auto_resume"])
    assert resumed.global_step == 6
    a, b = run_state(exp / "full", 6), run_state(exp / "colour_mnist", 6)
    assert a["logits"] == b["logits"]
    for net in ("netG", "netD"):
        (wa, sa, ca), (wb, sb, cb) = a[net], b[net]
        assert ca == cb and list(wa) == list(wb)
        assert all(torch.equal(wa[k], wb[k]) for k in wa), net
        assert sa.keys() == sb.keys() and len(sa) > 0
        for k in sa:
            for field in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(sa[k][field], sb[k][field]), (net, k, field)


@pytest.mark.parametrize("cli,nc", [(train_color_mnist_feature, 3),
                                    (train_mnist_fmnist_feature, 1)],
                         ids=["color_mnist", "mnist_fmnist"])
def test_bias_probes(cli, nc, mnist_dir):
    model, hist = cli.main(["--device", "cpu", "--epochs", "1", "--num_data", "140"])
    assert model.conv0.in_channels == nc and model.fc.out_features == 20
    assert [h["epoch"] for h in hist] == [1] and math.isfinite(hist[0]["loss"])
    assert 0.0 <= hist[0]["acc"] <= 1.0


def test_25gaussian_through_the_mimicry_cli(mnist_dir):
    tr = train_mimicry_phase1.main([
        "-d", "25gaussian", "--device", "cpu", "--num_steps", "500", "--exp_name", "toy",
        "--save_logit_after", "250", "--stop_save_logit_after", "500",
        "--logit_save_steps", "250", "--seed", "3"])
    assert tr.bundle.model == "toy" and tr.bundle.image_size == 0 and tr.global_step == 500
    finite(tr)
    run = mnist_dir / "exp_results" / "toy"
    check_pickle(run / "logits_netD_eval.pkl", [250, 500], n=10000)
    assert (run / "images" / "gaussian_step_500.png").is_file()
    pts = tr.generate_images(z=torch.zeros(5, 2))
    assert pts.shape == (5, 2)


def test_cli_flags_match_the_root_scripts():
    """The eight CLIs keep the argparse surfaces of the root scripts (option
    strings, defaults, types, actions), plus --device; captured live by
    scripts/dump_argparse.py."""
    repo = Path(__file__).resolve().parents[1]
    names = [f"train_mimicry_{d}_phase{p}" for d in ("color_mnist", "mnist_fmnist")
             for p in ("1", "2", "2_gold")] + ["train_color_mnist_feature",
                                                "train_mnist_fmnist_feature"]
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
