"""The CelebA Dia-GAN path and its attribute study through the port's CLIs,
on the CPU, against the JAX package's root scripts.

The chain: cli.train_mimicry_phase1 -d celeba and cli.train_mimicry_phase2
(SNGAN-64 narrowed to ngf = ndf = 32 through the port's registry, 40 images
of 64 px written as celeba_64.npy with a list_attr_celeba.txt), then
cli.disc_score_celeba_with_attr, cli.train_convnet_celeba (1 epoch),
cli.count_attr_celeba --drs and cli.eval_gan_drs_celeba_with_attr --metric
all (a stand-in featurizer for the Inception; DRS with 2 warm-up batches
instead of 50). Each writes its files with finite numbers.

Then the root scripts (train_convnet_celeba.py, count_attr_celeba.py,
disc_score_celeba_with_attr.py, eval_gan_celeba_with_attr.py's run and
_attr_fid) against the port's CLIs on identical inputs: the same dataset
files, logit pickle, injected fakes and classifier logits, and one stand-in
featurizer with integer features (float32 distances are then exact in both
packages). The JSONs and the CSV byte for byte, the npz statistics member by
member (np.savez stamps each member with the time), the printed means
line by line. Also: the CLIs keep the root scripts' argparse surfaces, plus
--device.
"""
import functools
import io
import json
import math
import pickle
import sys
import types
import zipfile
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_port_celeba_data import write_celeba  # noqa: E402

from diagan_tpu_torch.cli import (  # noqa: E402
    count_attr_celeba,
    disc_score_celeba_with_attr,
    eval_gan_celeba_with_attr,
    eval_gan_drs_celeba_with_attr,
    train_convnet_celeba,
    train_mimicry_phase1,
    train_mimicry_phase2,
)
from diagan_tpu_torch.data.sources import synthetic_celeba_attrs  # noqa: E402
from diagan_tpu_torch.data.synthetic import synthetic_natural  # noqa: E402
from diagan_tpu_torch.eval.drs import DRS  # noqa: E402
from diagan_tpu_torch.models import registry, sngan  # noqa: E402
from diagan_tpu_torch.train import trainer as TT  # noqa: E402
from diagan_tpu_torch.train.logger import Logger  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
WIDTH, N_DATA, ATTR = 32, 40, "Bald"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch (see test_torch_port_sngan_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def celeba_root(tmp_path_factory):
    images = synthetic_natural(N_DATA, 64, seed=5)[0]
    return write_celeba(tmp_path_factory.mktemp("celeba"), images,
                        synthetic_celeba_attrs(images, seed=1))


class StubFeaturizer:
    """Integer features: 8 pixel sums of each uint8 image."""

    weights_kind = "stub"

    def __init__(self, *a, **k):
        pass

    def features(self, images):
        x = np.asarray(images).reshape(len(images), 8, -1).astype(np.int64)
        return x.sum(-1).astype(np.float64)


@pytest.fixture
def narrow(monkeypatch, tmp_path, celeba_root):
    """Width-32 SNGAN-64s in the port's registry, no TensorBoard, DRS with
    two warm-up batches, the stand-in featurizer; returns the common CLI
    arguments."""
    monkeypatch.setitem(registry._GEN_64, "sngan",
                        functools.partial(sngan.SNGANGenerator64, ngf=WIDTH))
    monkeypatch.setitem(registry._DISC_64, "sngan",
                        functools.partial(sngan.SNGANDiscriminator64, ndf=WIDTH))
    monkeypatch.setattr(TT, "Logger", functools.partial(Logger, use_tensorboard=False))
    monkeypatch.setattr(count_attr_celeba, "DRS", functools.partial(DRS, warmup_batches=2))
    monkeypatch.setattr(eval_gan_celeba_with_attr, "InceptionFeaturizer", StubFeaturizer)
    return ["--device", "cpu", "--seed", "3", "--work_dir", str(tmp_path)]


def test_the_celeba_chain_runs_through_the_port_clis(narrow, tmp_path, celeba_root):
    r = ["-r", str(celeba_root)]
    tr1 = train_mimicry_phase1.main(narrow + r + [
        "-d", "celeba", "--exp_name", "p1", "--no_schedule_override", "--num_steps", "6",
        "--batch_size", "4", "--n_dis", "1", "--logit_save_steps", "2",
        "--save_logit_after", "2", "--stop_save_logit_after", "6"])
    assert tr1.global_step == 6 and tr1.source.images.shape == (N_DATA, 64, 64, 3)
    assert all(math.isfinite(float(v)) for v in tr1.metrics.values())
    with open(tmp_path / "p1" / "logits_netD_eval.pkl", "rb") as f:
        assert list(pickle.load(f)) == [2, 4, 6]
    tr2 = train_mimicry_phase2.main(narrow + r + [
        "-d", "celeba", "--exp_name", "p2", "--baseline_exp_name", "p1", "--p1_step", "6",
        "--num_steps", "8", "--batch_size", "4", "--n_dis", "1",
        "--resample_score", "ldr_conf_1.0_ratio_50"])
    assert tr2.global_step == 8 and tr2.d_drs.count == 8
    assert (tmp_path / "p2" / "checkpoints" / "netD_drs" / "netD_drs_8_steps.pth").is_file()

    means = disc_score_celeba_with_attr.main(r + [
        "--work_dir", str(tmp_path), "--exp_name", "p1", "--p1_step", "6",
        "--resample_score", "ldr_conf_1.0_ratio_50", "--attr", ATTR])
    assert all(math.isfinite(v) and v > 0 for v in means.values())

    _, hist, val_acc, test_acc = train_convnet_celeba.main(narrow + r + [
        "--num_epochs", "1", "--batch_size", "16", "--attr", ATTR])
    assert len(hist) == 1 and 0 <= val_acc <= 1 and 0 <= test_acc <= 1
    clf = tmp_path / "attr_classifier"
    assert (clf / f"{ATTR}.pth").is_file()
    assert (clf / f"{ATTR}_results.csv").read_text().splitlines()[0] == \
        "attr,train_acc,val_acc,test_acc"

    out = count_attr_celeba.main(narrow + [
        "--exp_name", "p2", "--netG_ckpt_step", "8", "--attr", ATTR, "--drs",
        "--num_samples", "16", "--batch_size", "8"])
    saved = json.loads((tmp_path / "p2" / f"count_attr_{ATTR}_drs.json").read_text())
    assert saved == out and saved["total"] == 16 and 0 <= saved["fraction"] <= 1

    res = eval_gan_drs_celeba_with_attr.main(narrow + r + [
        "--exp_name", "p2", "--netG_ckpt_step", "8", "--attr", ATTR, "--metric", "all",
        "--num_real_samples", "6", "--num_fake_samples", "12", "--batch_size", "8"])
    step_dir = tmp_path / "p2" / "evaluate" / "step-8"
    pr = json.loads((step_dir / f"partial_recall_drs_{ATTR}.json").read_text())
    fid = json.loads((step_dir / f"fid_drs_{ATTR}.json").read_text())
    assert pr["inception_weights"] == fid["inception_weights"] == "stub"
    assert 0 <= pr["attr"]["recall"] <= 1 and 0 <= pr["not_attr"]["recall"] <= 1
    assert math.isfinite(fid["attr"]) and math.isfinite(fid["not_attr"])
    assert res["fid"]["attr"] == fid["attr"]
    assert (tmp_path / "p2" / "metrics" / "fid" / "statistics"
            / f"fid_stats_sngan_celeba_{ATTR}_cap6_run_3.npz").is_file()


# ---- the root scripts against the port's CLIs on identical inputs --------

@pytest.fixture
def root_scripts(monkeypatch):
    monkeypatch.syspath_prepend(str(REPO))
    yield
    for name in ("train_convnet_celeba", "count_attr_celeba", "disc_score_celeba_with_attr",
                 "eval_gan_celeba_with_attr"):
        sys.modules.pop(name, None)


def _run_jax_main(module, monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    buf = io.StringIO()
    with redirect_stdout(buf):
        module.main()
    return buf.getvalue()


class FakeSampler:
    def __init__(self, fakes):
        self.fakes = fakes

    def generate_images(self, n):
        return self.fakes[:n]


def _fakes(n, seed):
    return np.tanh(np.random.default_rng(seed).standard_normal((n, 64, 64, 3))).astype(np.float32)


def test_disc_score_prints_what_the_root_script_prints(root_scripts, monkeypatch, tmp_path,
                                                       celeba_root):
    import disc_score_celeba_with_attr as J

    run = tmp_path / "p1"
    run.mkdir()
    rng = np.random.default_rng(4)
    logits = {s: rng.standard_normal(N_DATA) for s in (10, 20, 30)}
    with open(run / "logits_netD_eval.pkl", "wb") as f:
        pickle.dump(logits, f)
    argv = ["-r", str(celeba_root), "--work_dir", str(tmp_path), "--exp_name", "p1",
            "--p1_step", "30", "--resample_score", "ldr_conf_1.0_ratio_50", "--attr", "Male"]
    want = _run_jax_main(J, monkeypatch, argv)
    buf = io.StringIO()
    with redirect_stdout(buf):
        disc_score_celeba_with_attr.main(argv)
    assert buf.getvalue() == want and "attr weights mean" in want


def test_train_convnet_writes_the_root_scripts_csv(root_scripts, monkeypatch, tmp_path,
                                                   celeba_root):
    import train_convnet_celeba as J

    hist = [{"epoch": 1, "loss": 0.5, "acc": 0.625}]
    logits = np.random.default_rng(5).standard_normal((N_DATA, 2)).astype(np.float32)
    seen = {}

    def predict(*a, **k):
        imgs = a[-1] if len(a) in (2, 4) else k["images"]
        seen.setdefault(len(a), []).append(len(imgs))
        return logits[:len(imgs)]

    monkeypatch.setattr(J, "train_classifier", lambda *a, **k: ({}, {}, hist))
    monkeypatch.setattr(J, "predict_classifier", predict)
    monkeypatch.setattr(train_convnet_celeba, "train_classifier", lambda m, *a, **k: (m, hist))
    monkeypatch.setattr(train_convnet_celeba, "predict_classifier", predict)
    argv = ["-r", str(celeba_root), "--attr", "Smiling"]
    _run_jax_main(J, monkeypatch, argv + ["--work_dir", str(tmp_path / "jax")])
    train_convnet_celeba.main(argv + ["--work_dir", str(tmp_path / "port"), "--device", "cpu"])
    want = (tmp_path / "jax" / "attr_classifier" / "Smiling_results.csv").read_bytes()
    assert (tmp_path / "port" / "attr_classifier" / "Smiling_results.csv").read_bytes() == want
    assert seen[4] == seen[2] == [4, 4]  # the scaled splits: train 32, valid 4, test 4


def test_count_attr_writes_the_root_scripts_json(root_scripts, monkeypatch, tmp_path):
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp
    from flax import serialization

    import count_attr_celeba as J

    fakes = _fakes(20, 6)
    logits = np.random.default_rng(7).standard_normal((20, 2)).astype(np.float32)
    got_u8 = []

    def predict(model, *a, **k):
        got_u8.append(a[-1] if len(a) in (1, 3) else k["images"])
        return logits

    # the JAX script: a tiny Flax classifier file, the sampler and the
    # classifier's logits injected
    class Tiny(fnn.Module):
        num_attrs: int = 2

        @fnn.compact
        def __call__(self, x, train=True):
            return fnn.Dense(self.num_attrs)(x.reshape(len(x), -1)), x

    variables = Tiny().init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)))
    (tmp_path / "attr_classifier").mkdir()
    (tmp_path / "attr_classifier" / "Bald.pth").write_bytes(serialization.to_bytes(variables))
    (tmp_path / "run").mkdir()
    for mod in (J, count_attr_celeba):
        monkeypatch.setattr(mod, "get_gan_model", lambda *a, **k: types.SimpleNamespace(
            nz=128, disc=None, disc_drs=None))
    monkeypatch.setattr(J, "load_eval_models", lambda *a, **k: (None, None))
    monkeypatch.setattr(J, "make_gen_fn", lambda *a: None)
    monkeypatch.setattr(J, "make_disc_fn", lambda *a: None)
    monkeypatch.setattr(J, "DRS", lambda *a, **k: FakeSampler(fakes))
    monkeypatch.setattr(J, "AttrClassifier", Tiny)
    monkeypatch.setattr(J, "predict_classifier", predict)
    argv = ["--work_dir", str(tmp_path), "--exp_name", "run", "--netG_ckpt_step", "5",
            "--drs", "--num_samples", "20"]
    _run_jax_main(J, monkeypatch, argv)
    want = (tmp_path / "run" / "count_attr_Bald_drs.json").read_bytes()
    (tmp_path / "run" / "count_attr_Bald_drs.json").unlink()

    from diagan_tpu_torch.models.convnets import AttrClassifier
    torch.save(AttrClassifier(num_attrs=2, device="cpu").state_dict(),
               tmp_path / "attr_classifier" / "Bald.pth")
    monkeypatch.setattr(count_attr_celeba, "make_sampler", lambda *a: FakeSampler(fakes))
    monkeypatch.setattr(count_attr_celeba, "predict_classifier", predict)
    count_attr_celeba.main(argv + ["--device", "cpu"])
    assert (tmp_path / "run" / "count_attr_Bald_drs.json").read_bytes() == want
    # uint8 by truncation, not rounding
    assert np.array_equal(got_u8[0], got_u8[1])
    assert np.array_equal(got_u8[1], np.floor(np.clip((fakes + 1) * 127.5, 0, 255)))


@pytest.mark.parametrize("metric", ["partial_recall", "fid", "all"])
def test_eval_with_attr_writes_the_root_scripts_files(root_scripts, monkeypatch, tmp_path,
                                                      celeba_root, metric):
    import eval_gan_celeba_with_attr as J

    fakes = _fakes(12, 8)
    monkeypatch.setattr(J, "get_gan_model", lambda **k: types.SimpleNamespace(
        nz=128, disc=None, disc_drs=None))
    monkeypatch.setattr(J, "load_eval_models", lambda *a, **k: (None, None))
    monkeypatch.setattr(J, "make_gen_fn", lambda *a: None)
    monkeypatch.setattr(J, "Sampler", lambda *a, **k: FakeSampler(fakes))
    monkeypatch.setattr(J, "InceptionFeaturizer", StubFeaturizer)
    monkeypatch.setattr(eval_gan_celeba_with_attr, "get_gan_model", lambda **k: None)
    monkeypatch.setattr(eval_gan_celeba_with_attr, "make_sampler",
                        lambda *a: FakeSampler(fakes))
    monkeypatch.setattr(eval_gan_celeba_with_attr, "InceptionFeaturizer", StubFeaturizer)
    outs = {}
    for side, parser in (("jax", J.build_parser()),
                         ("port", eval_gan_celeba_with_attr.build_parser())):
        args = parser.parse_args([
            "-r", str(celeba_root), "--work_dir", str(tmp_path / side), "--exp_name", "run",
            "--netG_ckpt_step", "7", "--attr", "Male", "--metric", metric,
            "--num_real_samples", "15", "--num_fake_samples", "12"])
        if side == "port":
            args.device = "cpu"
        outs[side] = (J.run if side == "jax" else eval_gan_celeba_with_attr.run)(args)
    assert outs["port"] == outs["jax"]
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert len(files) == {"partial_recall": 1, "fid": 2, "all": 3}[metric]
    for rel in files:
        want, got = (tmp_path / "jax" / rel).read_bytes(), (tmp_path / "port" / rel).read_bytes()
        if rel.suffix == ".npz":
            zw, zg = zipfile.ZipFile(io.BytesIO(want)), zipfile.ZipFile(io.BytesIO(got))
            assert zw.namelist() == zg.namelist() == [
                "attr_mu.npy", "attr_sigma.npy", "not_attr_mu.npy", "not_attr_sigma.npy"]
            assert all(zw.read(m) == zg.read(m) for m in zw.namelist())
            assert "_cap15_" in rel.name  # Male splits 20 / 20: both subsets capped
        else:
            assert got == want, rel


def test_attr_fid_reads_its_cache():
    """A second call finds the npz and never featurizes the reals."""
    args = types.SimpleNamespace(model="sngan", dataset="celeba", attr="Male", seed=1,
                                 netG_ckpt_step=4)
    ds = types.SimpleNamespace(images=np.random.default_rng(0).integers(
        0, 256, (40, 8, 8, 3)).astype(np.uint8))
    feats = StubFeaturizer().features(ds.images[:24])
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        first = eval_gan_celeba_with_attr._attr_fid(args, ds, StubFeaturizer(), feats,
                                                    np.arange(20), np.arange(20, 40), Path(d),
                                                    64, False)
        ds.images = None  # a featurization would fail now
        second = eval_gan_celeba_with_attr._attr_fid(args, ds, StubFeaturizer(), feats,
                                                     np.arange(20), np.arange(20, 40), Path(d),
                                                     64, True)
        assert first == second
        assert (Path(d) / "metrics" / "fid" / "statistics"
                / "fid_stats_sngan_celeba_Male_run_1.npz").is_file()


@pytest.mark.parametrize("name", ["train_convnet_celeba", "count_attr_celeba",
                                  "disc_score_celeba_with_attr", "eval_gan_celeba_with_attr",
                                  "eval_gan_drs_celeba_with_attr"])
def test_cli_flags_match_the_root_scripts(name):
    """The option strings, defaults, types and actions of each root script,
    plus --device where the CLI touches the card (disc_score runs on the
    host); captured live by scripts/dump_argparse.py."""
    saved_path = list(sys.path)
    sys.path[:0] = [str(REPO / "scripts"), str(REPO)]
    try:
        from dump_argparse import capture_script

        want = capture_script(str(REPO / f"{name}.py"))
        got = capture_script(str(REPO / "diagan_tpu_torch" / "cli" / f"{name}.py"))
    finally:
        sys.path[:] = saved_path
        for mod in ("dump_argparse", "eval_gan_celeba_with_attr"):
            sys.modules.pop(mod, None)
    assert len(want) >= 7
    if name != "disc_score_celeba_with_attr":
        device = got.pop("--device")
        assert device["default"] == "cuda" and device["type"] == "str"
    assert got == want
