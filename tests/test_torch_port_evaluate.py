"""evaluate_checkpoint, the DRS host extras and the eval CLIs of the port
against the JAX package's, on the CPU.

Set-up: a narrow SNGAN-32 run (width 32) with netG, netD and netD_drs written
by the port's checkpoint code, copied into one directory per package, and the
same uint8 fake cache .npy under both step directories. One stub featurizer
serves both sides: a fixed seeded integer projection of the pixels, so that
no Inception runs and every feature is an integer (the distances of PR are
then exact in float32 in both packages; see tests/test_torch_port_metrics.py).
Both packages then write the same JSON files and the same statistics: FID,
KID and PR equal, IS within rtol 1e-6. The JAX package reads the port's
checkpoints (tests/test_torch_port_sngan_cli.py); its fakes would differ from
the port's by design (threefry against Philox), so each side reads the cache.
"""
import dataclasses
import functools
import json
import pickle
import shutil
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from test_torch_port_sngan_data import write_cifar_batches  # noqa: E402

from diagan_tpu.eval import drs as jdrs  # noqa: E402
from diagan_tpu.eval import evaluate as JE  # noqa: E402
from diagan_tpu.models import sngan as JSN  # noqa: E402
from diagan_tpu.models.registry import get_gan_model as jax_get_gan_model  # noqa: E402
from diagan_tpu_torch.cli import (  # noqa: E402
    eval_gan,
    eval_gan_drs,
    eval_gan_drs_with_index,
    eval_gan_with_index,
)
from diagan_tpu_torch.eval import drs as tdrs  # noqa: E402
from diagan_tpu_torch.eval import evaluate as TE  # noqa: E402
from diagan_tpu_torch.models import registry, sngan, stylegan2  # noqa: E402
from diagan_tpu_torch.models.registry import OptSpec  # noqa: E402
from diagan_tpu_torch.train.checkpoint import save_net  # noqa: E402
from diagan_tpu_torch.train.state import NetState  # noqa: E402

WIDTH, STEP, N_REAL, N_FAKE = 32, 5, 80, 60


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch in these tests: the suite runs test files
    in parallel processes, and torch's default of one thread per core makes
    the processes' small ops wait on each other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class StubFeaturizer:
    """Integer features from a fixed seeded ±1 projection of the pixels, and
    logits from a fixed projection of the features. Counts its calls."""

    weights_kind = "random"

    def __init__(self, d=16):
        rng = np.random.default_rng(0)
        self.proj = rng.choice([-1, 1], (32 * 32 * 3, d)).astype(np.int64)
        self.head = rng.standard_normal((d, 10)).astype(np.float32) / 40
        self.calls = 0

    def features_and_logits(self, images):
        self.calls += 1
        x = np.asarray(images).reshape(len(images), -1).astype(np.int64)
        feats = ((x @ self.proj) // 512).astype(np.float32)
        return feats, feats @ self.head

    def features(self, images):
        return self.features_and_logits(images)[0]


@pytest.fixture
def narrow(monkeypatch):
    """Width-32 SNGANs in the port's registry."""
    monkeypatch.setitem(registry._GEN_32, "sngan",
                        functools.partial(sngan.SNGANGenerator32, ngf=WIDTH))
    monkeypatch.setitem(registry._DISC_32, "sngan",
                        functools.partial(sngan.SNGANDiscriminator32, ndf=WIDTH))


def _jax_bundle():
    return dataclasses.replace(
        jax_get_gan_model("cifar10", drs=True), gen=JSN.SNGANGenerator32(ngf=WIDTH),
        disc=JSN.SNGANDiscriminator32(ndf=WIDTH), disc_drs=JSN.SNGANDiscriminator32(ndf=WIDTH))


@pytest.fixture
def runs(narrow, tmp_path):
    """(jax run dir, port run dir, real images): the same SNGAN-32 run and
    the same fake caches (seeds 0 and 1, plain and _drs) in both."""
    torch.manual_seed(0)
    bundle = registry.get_gan_model("cifar10", drs=True, device="cpu")
    spec = OptSpec(2e-4, (0.0, 0.9))
    for name, module in (("netG", bundle.gen), ("netD", bundle.disc),
                         ("netD_drs", bundle.disc_drs)):
        save_net(NetState(module, spec, 10, "linear"), tmp_path / "run" / "checkpoints", name, STEP)
    rng = np.random.default_rng(1)
    images = tmp_path / "run" / "evaluate" / f"step-{STEP}" / "images"
    images.mkdir(parents=True)
    for seed in (0, 1):
        for tag in ("", "_drs"):
            fakes = rng.integers(0, 256, (N_FAKE, 32, 32, 3)).astype(np.uint8)
            np.save(images / f"fid_gen_images_0k_{seed}{tag}.npy", fakes)
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(tmp_path / "run", jax_dir)
    shutil.copytree(tmp_path / "run", port_dir)
    real = rng.integers(0, 256, (N_REAL, 32, 32, 3)).astype(np.uint8)
    return jax_dir, port_dir, real


def _both(jax_dir, port_dir, metric, **kw):
    """One evaluate_checkpoint call in each package; returns both results."""
    want = JE.evaluate_checkpoint(metric, bundle=_jax_bundle(), log_dir=jax_dir,
                                  evaluate_step=STEP, featurizer=StubFeaturizer(), **kw)
    got = TE.evaluate_checkpoint(metric, bundle=registry.get_gan_model("cifar10", drs=True,
                                                                       device="cpu"),
                                 log_dir=port_dir, evaluate_step=STEP,
                                 featurizer=StubFeaturizer(), device="cpu", **kw)
    return got, want


def _files(run):
    base = run / "evaluate" / f"step-{STEP}"
    return sorted(p.name for p in base.glob("*.json"))


def _same_file(jax_dir, port_dir, rel):
    assert (port_dir / rel).read_bytes() == (jax_dir / rel).read_bytes(), rel


COUNTS = dict(num_real_samples=N_FAKE, num_fake_samples=N_FAKE)


def test_fid_kid_pr_write_the_jax_files(runs):
    """fid (computing and caching the real statistics, then reading them),
    kid and pr over seeds 0 and 1: the same JSON bytes and statistics."""
    jax_dir, port_dir, real = runs
    got, want = _both(jax_dir, port_dir, "fid", real_images=real, num_runs=2, **COUNTS)
    assert got == want and set(got["scores"]) == {"0", "1"}
    assert all(np.isfinite(v) for v in got["scores"].values())
    _same_file(jax_dir, port_dir, f"evaluate/step-{STEP}/fid_0k_0k.json")
    stats = Path("metrics/fid/statistics/fid_stats_cifar10_0k_run_0.npz")
    with np.load(port_dir / stats) as a, np.load(jax_dir / stats) as b:
        assert sorted(a.files) == ["mu", "sigma"]
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    # the cached statistics are read back (no real images given)
    got, want = _both(jax_dir, port_dir, "fid", overwrite=True, **COUNTS)
    assert got == want
    for metric in ("kid", "pr"):
        got, want = _both(jax_dir, port_dir, metric, real_images=real, num_runs=2, **COUNTS)
        assert got == want
        _same_file(jax_dir, port_dir, f"evaluate/step-{STEP}/{metric}_0k_0k.json")
    assert 0.0 < got["scores"]["0"]["precision"] < 1.0
    assert _files(port_dir) == _files(jax_dir) == ["fid_0k_0k.json", "kid_0k_0k.json",
                                                   "pr_0k_0k.json"]


def test_inception_score_and_a_named_subset(runs):
    jax_dir, port_dir, real = runs
    got, want = _both(jax_dir, port_dir, "inception_score", num_fake_samples=N_FAKE)
    assert got.keys() == want.keys() and got["inception_weights"] == "random"
    np.testing.assert_allclose(got["scores"]["0"], want["scores"]["0"], rtol=1e-6)
    assert _files(port_dir) == ["inception_score_0k.json"]
    index = np.arange(10, 50)
    got, want = _both(jax_dir, port_dir, "fid", real_images=real, real_subset_index=index,
                      num_real_samples=30, num_fake_samples=N_FAKE, name="high_ldr")
    assert got == want
    _same_file(jax_dir, port_dir, f"evaluate/step-{STEP}/fid_high_ldr_0k_0k.json")


def test_rerun_skips_finished_seeds_and_overwrite_recomputes(runs):
    _, port_dir, real = runs
    bundle = registry.get_gan_model("cifar10", drs=True, device="cpu")
    kw = dict(bundle=bundle, log_dir=port_dir, evaluate_step=STEP, real_images=real,
              device="cpu", **COUNTS)
    first = StubFeaturizer()
    TE.evaluate_checkpoint("kid", featurizer=first, **kw)
    path = port_dir / "evaluate" / f"step-{STEP}" / "kid_0k_0k.json"
    text = path.read_text()
    again = StubFeaturizer()
    TE.evaluate_checkpoint("kid", featurizer=again, **kw)
    assert again.calls == 1 and path.read_text() == text  # the reals only
    # a second seed is added; overwrite starts the file over
    TE.evaluate_checkpoint("kid", featurizer=StubFeaturizer(), start_seed=0, num_runs=2, **kw)
    assert set(json.loads(path.read_text())["scores"]) == {"0", "1"}
    redo = StubFeaturizer()
    TE.evaluate_checkpoint("kid", featurizer=redo, overwrite=True, **kw)
    assert redo.calls == 2 and path.read_text() == text


def test_drs_reads_the_drs_fake_cache_and_writes_it(runs):
    """use_drs reads fid_gen_images_*_drs.npy (both packages) and, when it is
    missing, the port draws DRS fakes with the run's netD_drs and writes it."""
    jax_dir, port_dir, real = runs
    got, want = _both(jax_dir, port_dir, "pr", real_images=real, use_drs=True, **COUNTS)
    assert got == want and got["use_drs"] is True
    _same_file(jax_dir, port_dir, f"evaluate/step-{STEP}/pr_0k_0k.json")
    cache = port_dir / "evaluate" / f"step-{STEP}" / "images" / "fid_gen_images_0k_2_drs.npy"
    res = TE.evaluate_checkpoint("pr", bundle=registry.get_gan_model("cifar10", drs=True,
                                                                    device="cpu"),
                                 log_dir=port_dir, evaluate_step=STEP, real_images=real,
                                 use_drs=True, start_seed=2, batch_size=16,
                                 featurizer=StubFeaturizer(), device="cpu", **COUNTS)
    fakes = np.load(cache)
    assert fakes.shape == (N_FAKE, 32, 32, 3) and fakes.dtype == np.uint8
    assert set(res["scores"]) == {"0", "2"}


def test_stylegan2_checkpoint_loads_and_evaluates(monkeypatch, tmp_path):
    """The ffhq bundle (narrowed): load_eval_models reads g_ema and drs_d
    (falling back to d) from checkpoint/{step:06d}.pt, and evaluate_checkpoint
    runs DRS on it end to end."""
    monkeypatch.setattr(registry, "_STYLEGAN2_G", functools.partial(
        stylegan2.StyleGAN2Generator, n_mlp=2, width_scale=1 / 16))
    monkeypatch.setattr(registry, "_STYLEGAN2_D", functools.partial(
        stylegan2.StyleGAN2Discriminator, width_scale=1 / 16))
    torch.manual_seed(3)
    src = registry.get_gan_model("ffhq", drs=True, size=16, device="cpu")
    assert (src.nz, src.model, src.image_size, src.opt_g.betas) == (512, "stylegan", 16, (0.0, 0.9))
    (tmp_path / "checkpoint").mkdir()
    TE.save_stylegan2_ckpt(tmp_path / "checkpoint" / "000007.pt", src.gen, src.disc,
                           src.disc_drs)
    bundle = registry.get_gan_model("ffhq", drs=True, size=16, device="cpu")
    gen, disc = TE.load_eval_models(bundle, tmp_path, 7, use_drs=True)
    assert not gen.training and not disc.training

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                      b.state_dict().values()))
    assert same(gen, src.gen) and same(disc, src.disc_drs) and not same(disc, src.disc)
    assert TE.load_eval_models(bundle, tmp_path, 7)[1] is None
    TE.save_stylegan2_ckpt(tmp_path / "checkpoint" / "000008.pt", src.gen, src.disc)
    assert same(TE.load_eval_models(bundle, tmp_path, 8, use_drs=True)[1], src.disc)

    class Stub16(StubFeaturizer):
        def features_and_logits(self, images):
            return super().features_and_logits(np.tile(images, (1, 2, 2, 1)))

    real = np.random.default_rng(2).integers(0, 256, (12, 16, 16, 3)).astype(np.uint8)
    res = TE.evaluate_checkpoint("fid", bundle, tmp_path, 7, real_images=real,
                                 num_real_samples=12, num_fake_samples=8, use_drs=True,
                                 batch_size=4, featurizer=Stub16(), device="cpu")
    assert np.isfinite(res["scores"]["0"])
    assert (tmp_path / "evaluate" / "step-7" / "images" / "fid_gen_images_0k_0_drs.npy").is_file()


def test_netD_ckpt_dir_and_use_original_netD(runs):
    _, port_dir, _ = runs
    bundle = registry.get_gan_model("cifar10", drs=True, device="cpu")
    _, d_drs = TE.load_eval_models(bundle, port_dir, STEP, use_drs=True)
    want = {k: v.clone() for k, v in d_drs.state_dict().items()}
    other = port_dir.parent / "other"
    shutil.copytree(port_dir / "checkpoints" / "netD", other / "netD")
    _, own = TE.load_eval_models(bundle, port_dir, STEP, use_drs=True, use_original_netD=True,
                                 netD_ckpt_dir=other)
    raw = torch.load(other / "netD" / f"netD_{STEP}_steps.pth", weights_only=True)
    assert all(torch.equal(own.state_dict()[k], v) for k, v in raw["model_state_dict"].items())
    assert any(not torch.equal(want[k], v) for k, v in raw["model_state_dict"].items())
    with pytest.raises(FileNotFoundError, match="netD_drs"):
        TE.load_eval_models(bundle, port_dir, STEP, use_drs=True, netD_ckpt_dir=other)


# --- the DRS host extras ----------------------------------------------------

NZ = 4


def _port_drs(**kw):
    return tdrs.DRS(lambda z: z, lambda x: x[:, 0], NZ, warmup_batches=0, device="cpu", **kw)


@pytest.mark.parametrize("gamma", [None, 0.3])
def test_host_accept_matches_jax(gamma):
    rng = np.random.default_rng(11)
    for step in range(3):
        ldr = (2.0 * rng.standard_normal(64) + step).astype(np.float32)
        u = rng.uniform(size=64).astype(np.float32)
        if step == 0:
            jself = SimpleNamespace(percentile=80, gamma=gamma, maximum=-1e5)
            port = _port_drs(gamma=gamma)
        want = jdrs.DRS._accept(jself, ldr, u)
        got = port._accept(ldr, u)
        np.testing.assert_array_equal(got, want)
        assert port.maximum == jself.maximum  # updated before the test
        assert 0 < got.sum() < len(got)


def test_acceptance_rate_probe_matches_jax():
    """The same injected logits and uniforms, 5 batches: the JAX probe takes
    them 2 per chunk (and drops the last chunk's second row), the port one per
    batch."""
    rng = np.random.default_rng(12)
    ldr = (1.5 * rng.standard_normal((6, 8))).astype(np.float32)
    u = rng.uniform(size=(6, 8)).astype(np.float32)
    jd = jdrs.DRS(lambda z: z, lambda x: x[:, 0], NZ, key=jax.random.key(0), batch_size=8,
                  chunk=2)
    chunks = iter(range(0, 6, 2))

    def propose_chunk(key):
        i = next(chunks)
        return None, jnp.asarray(ldr[i:i + 2]), jnp.asarray(u[i:i + 2])
    jd._propose_chunk = propose_chunk
    port = _port_drs(batch_size=8)
    batches = iter(range(6))

    def propose():
        i = next(batches)
        return ldr[i], u[i]
    port._propose = propose
    jd.maximum = port.maximum = 0.5
    assert port.acceptance_rate_probe(num_batches=5) == jd.acceptance_rate_probe(num_batches=5)
    assert port.maximum == jd.maximum


def test_visualize_images_matches_jax_pixel_for_pixel(tmp_path):
    imgs = np.random.default_rng(13).uniform(-1.1, 1.1, (12, 8, 8, 3)).astype(np.float32)
    jd = SimpleNamespace(generate_images=lambda n: imgs[:n])
    want = jdrs.DRS.visualize_images(jd, tmp_path / "jax", num_images=12)
    port = _port_drs()
    port.generate_images = lambda n: imgs[:n]
    got = port.visualize_images(tmp_path / "port", num_images=12)
    assert got.name == want.name == "drs_samples.png"
    with Image.open(want) as a, Image.open(got) as b:
        assert a.size == b.size == (8 * 10 + 2, 2 * 10 + 2)
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


# --- the CLIs -------------------------------------------------------------

ROOT_SCRIPTS = ("eval_gan", "eval_gan_drs", "eval_gan_with_index", "eval_gan_drs_with_index")


def test_cli_flags_match_the_root_scripts():
    """cli/eval_gan*.py keep the argparse surfaces of the root eval_gan*.py
    (option strings, defaults, types, actions), plus --device; captured live
    by scripts/dump_argparse.py."""
    repo = Path(__file__).resolve().parents[1]
    saved_path = list(sys.path)
    sys.path.insert(0, str(repo / "scripts"))
    try:
        from dump_argparse import capture_script

        want = [capture_script(str(repo / f"{n}.py")) for n in ROOT_SCRIPTS]
        got = [capture_script(str(repo / "diagan_tpu_torch" / "cli" / f"{n}.py"))
               for n in ROOT_SCRIPTS]
    finally:
        sys.path[:] = saved_path
        sys.modules.pop("dump_argparse", None)
    assert [len(w) for w in want] == [11, 12, 17, 18]  # the whole surfaces were captured
    for ours, theirs in zip(got, want):
        device = ours.pop("--device")
        assert device["default"] == "cuda" and device["type"] == "str"
        assert ours == theirs


@pytest.fixture
def cli_env(narrow, monkeypatch, tmp_path):
    """A CIFAR-format dataset, a baseline run's logits, the stub featurizer in
    the CLIs and evaluate_checkpoint recording its calls."""
    write_cifar_batches(tmp_path / "data",
                        np.random.default_rng(3).integers(0, 256, (64, 32, 32, 3), np.uint8))
    rng = np.random.default_rng(4)
    (tmp_path / "p1").mkdir()
    logits = {s: rng.standard_normal(64) for s in (2, 4, 6)}
    with open(tmp_path / "p1" / "logits_netD_eval.pkl", "wb") as f:
        pickle.dump(logits, f)
    calls = []

    def record(metric, **kw):
        calls.append(dict(kw, metric=metric))
        return {}
    for cli in (eval_gan, eval_gan_with_index):
        monkeypatch.setattr(cli, "evaluate_checkpoint", record)
        monkeypatch.setattr(cli, "InceptionFeaturizer",
                            lambda batch_size, device: SimpleNamespace(batch_size=batch_size))
    common = ["-r", str(tmp_path / "data"), "--work_dir", str(tmp_path), "--exp_name", "p2",
              "--netG_ckpt_step", "7", "--device", "cpu"]
    return calls, common, logits


@pytest.mark.parametrize("cli,drs,extra", [(eval_gan, False, []), (eval_gan_drs, True, []),
                                           (eval_gan_drs, True, ["--use_original_netD"])],
                         ids=["eval_gan", "eval_gan_drs", "eval_gan_drs_original_netD"])
def test_fid_is_pr_clis_call_evaluate_checkpoint(cli_env, cli, drs, extra):
    calls, common, _ = cli_env
    cli.main(common + extra)
    assert [c["metric"] for c in calls] == ["fid", "inception_score", "pr"]
    assert [(c.get("num_real_samples"), c["num_fake_samples"]) for c in calls] == [
        (50000, 50000), (None, 50000), (10000, 10000)]
    for c in calls:
        assert c["use_drs"] is drs and c["use_original_netD"] is bool(extra)
        assert c["evaluate_step"] == 7 and c["batch_size"] == (256 if drs else 128)
        assert c["featurizer"].batch_size == 128 and c["device"] == torch.device("cpu")
        assert c["bundle"].dataset == "cifar10" and (c["bundle"].disc_drs is not None) is drs
        assert (c["start_seed"], c["num_runs"]) == (0, 1)
    assert calls[0]["stats_file"] is None and calls[0]["real_images"].shape == (64, 32, 32, 3)


@pytest.mark.parametrize("cli,drs,extra", [
    (eval_gan_with_index, False, []), (eval_gan_drs_with_index, True, []),
    (eval_gan_drs_with_index, True, ["--use_original_netD"])],
    ids=["with_index", "drs_with_index", "drs_with_index_original_netD"])
def test_index_clis_call_evaluate_checkpoint(cli_env, cli, drs, extra):
    from diagan_tpu_torch.score import calculate_scores

    calls, common, logits = cli_env
    cli.main(common + ["--baseline_exp_name", "p1", "--p1_step", "6", "--index_num", "10",
                       "--resample_score", "ldr_conf_1.0_ratio_50"] + extra)
    assert [(c["metric"], c["name"]) for c in calls] == [
        ("fid", "high_ldr_conf_1.0_ratio_50"), ("fid", "low_ldr_conf_1.0_ratio_50")]
    order = np.argsort(np.asarray(calculate_scores(logits, start_epoch=6 - 5000, end_epoch=6)[
        "ldr_conf_1.0_ratio_50"]))
    np.testing.assert_array_equal(calls[0]["real_subset_index"], order[-10:])
    np.testing.assert_array_equal(calls[1]["real_subset_index"], order[:10])
    for c in calls:
        assert (c["num_real_samples"], c["num_fake_samples"]) == (10, 50000)
        assert c["use_drs"] is drs and c["use_original_netD"] is bool(extra)
        assert "batch_size" not in c  # evaluate_checkpoint's default, 256
