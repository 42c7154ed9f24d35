"""The SNGAN Dia-GAN path through the port's CLIs, on the CPU, against the
JAX package.

Phase 1 (cli.train_mimicry_phase1 --device cpu --no_schedule_override) on a
256-image CIFAR-format directory written here, LDR scores from its logit
pickle (the JAX package's calculate_scores and the port's agree), phase 2
(cli.train_mimicry_phase2, ldr_conf_1.0_ratio_50, the twin DRS
discriminator), then the JAX package's own load_eval_models on the port's
run directory: its G(z) and netD_drs(x) equal the port's eval closures at
1e-5 x max(1, max|out|). Models narrowed to width 32 by monkeypatching the
port's registry (and, for the JAX side, a dataclasses.replace of its bundle:
no file of the JAX package changes); batch 4, n_dis 2. Also: a run stopped
by SIGTERM flushes a checkpoint that resumes to the uninterrupted run's bits,
the flag that is not in the port yet (--data_parallel) raises, and the CLIs
keep the root scripts' argparse surfaces plus --device.
"""
import dataclasses
import functools
import math
import os
import pickle
import signal
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_port_sngan_data import write_cifar_batches  # noqa: E402

from diagan_tpu.eval import evaluate as JE  # noqa: E402
from diagan_tpu.models import sngan as JSN  # noqa: E402
from diagan_tpu.models.registry import get_gan_model as jax_get_gan_model  # noqa: E402
from diagan_tpu.score import calculate_scores as jax_calculate_scores  # noqa: E402
from diagan_tpu_torch.cli import train_mimicry_phase1, train_mimicry_phase2  # noqa: E402
from diagan_tpu_torch.data.synthetic import synthetic_natural  # noqa: E402
from diagan_tpu_torch.eval import evaluate as TE  # noqa: E402
from diagan_tpu_torch.models import registry, sngan  # noqa: E402
from diagan_tpu_torch.score import calculate_scores  # noqa: E402
from diagan_tpu_torch.train import trainer as TT  # noqa: E402
from diagan_tpu_torch.train.logger import Logger  # noqa: E402

WIDTH, N_DATA = 32, 256
COMMON = ["--device", "cpu", "--batch_size", "4", "--n_dis", "2", "--seed", "3"]
PHASE1 = ["--exp_name", "p1", "--no_schedule_override", "--num_steps", "6",
          "--logit_save_steps", "2", "--save_logit_after", "2", "--stop_save_logit_after", "6"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch in these tests: the suite runs test files
    in parallel processes, and torch's default of one thread per core makes
    the processes' small ops wait on each other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def narrow(monkeypatch, tmp_path):
    """Width-32 SNGANs in the port's registry, no TensorBoard, and a
    CIFAR-format dataset; returns the common CLI arguments."""
    monkeypatch.setitem(registry._GEN_32, "sngan",
                        functools.partial(sngan.SNGANGenerator32, ngf=WIDTH))
    monkeypatch.setitem(registry._DISC_32, "sngan",
                        functools.partial(sngan.SNGANDiscriminator32, ndf=WIDTH))
    monkeypatch.setitem(registry._GEN_64, "sngan",
                        functools.partial(sngan.SNGANGenerator64, ngf=WIDTH))
    monkeypatch.setitem(registry._DISC_64, "sngan",
                        functools.partial(sngan.SNGANDiscriminator64, ndf=WIDTH))
    monkeypatch.setattr(TT, "Logger", functools.partial(Logger, use_tensorboard=False))
    write_cifar_batches(tmp_path / "data", synthetic_natural(N_DATA, 32, seed=5)[0])
    return COMMON + ["-r", str(tmp_path / "data"), "--work_dir", str(tmp_path)]


def _finite(tr):
    m = {k: float(v) for k, v in tr.metrics.items()}
    assert all(math.isfinite(v) for v in m.values()), m
    return m


def test_phase1_scores_phase2_and_the_jax_eval_loader(narrow, tmp_path):
    tr1 = train_mimicry_phase1.main(narrow + PHASE1)
    assert {"errD", "errG", "D(x)", "D(G(z))"} == set(_finite(tr1))
    assert tr1.global_step == 6 and tr1.g.count == 6 and tr1.d.count == 12
    with open(tmp_path / "p1" / "logits_netD_eval.pkl", "rb") as f:
        logits = pickle.load(f)
    assert list(logits) == [2, 4, 6] and all(type(k) is int for k in logits)
    assert all(v.dtype == np.float64 and v.shape == (N_DATA,) for v in logits.values())
    ours = calculate_scores(logits, start_epoch=6 - 5000, end_epoch=6)
    theirs = jax_calculate_scores(logits, start_epoch=6 - 5000, end_epoch=6)
    assert sorted(ours) == sorted(theirs)
    for key in theirs:
        np.testing.assert_array_equal(np.asarray(ours[key]), np.asarray(theirs[key]), err_msg=key)
    raw = torch.load(tmp_path / "p1" / "checkpoints" / "netD" / "netD_6_steps.pth",
                     weights_only=True)
    assert set(raw) == {"model_state_dict", "optimizer_state_dict", "global_step", "update_count"}
    assert raw["global_step"] == 6 and raw["update_count"] == 12
    assert (tmp_path / "p1" / "checkpoints" / "logit_buffer.npz").is_file()

    tr2 = train_mimicry_phase2.main(narrow + [
        "--exp_name", "p2", "--baseline_exp_name", "p1", "--p1_step", "6", "--num_steps", "9",
        "--resample_score", "ldr_conf_1.0_ratio_50"])
    assert {"errD", "errG", "errD_drs"} <= set(_finite(tr2))
    np.testing.assert_allclose(tr2.source.weights.numpy(),
                               np.maximum(np.asarray(ours["ldr_conf_1.0_ratio_50"]), 1e-6),
                               rtol=1e-6)
    # netD_drs started from netD's phase-1 file and continued its update count
    assert tr2.global_step == 9 and tr2.d.count == tr2.d_drs.count == 18 and tr2.g.count == 9
    assert not (tmp_path / "p2" / "logits_netD_drs_eval.pkl").exists()  # phase 2 records none
    assert sorted(p.name for p in (tmp_path / "p2").glob("*.png")) == [
        "p2_ldr_conf_1.0_ratio_50_high.png", "p2_ldr_conf_1.0_ratio_50_low.png"]

    # the JAX package's loader restores the port's phase-2 run
    bundle = dataclasses.replace(
        jax_get_gan_model("cifar10", drs=True), gen=JSN.SNGANGenerator32(ngf=WIDTH),
        disc=JSN.SNGANDiscriminator32(ndf=WIDTH), disc_drs=JSN.SNGANDiscriminator32(ndf=WIDTH))
    g_state, d_state = JE.load_eval_models(bundle, tmp_path / "p2", 9, use_drs=True)
    gen, disc = TE.load_eval_models(registry.get_gan_model("cifar10", drs=True, device="cpu"),
                                    tmp_path / "p2", 9, use_drs=True)
    assert not gen.training and not disc.training
    z = np.random.default_rng(0).standard_normal((6, 128)).astype(np.float32)
    want_x = np.asarray(JE.make_gen_fn(bundle, g_state)(z))
    got_x = TE.make_gen_fn(gen)(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got_x, want_x, rtol=0, atol=1e-5)
    want = np.asarray(JE.make_disc_fn(bundle.disc_drs, d_state)(want_x))
    got = TE.make_disc_fn(disc)(torch.from_numpy(want_x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))
    # use_original_netD: a phase-1 model's own D under DRS
    _, own = TE.load_eval_models(registry.get_gan_model("cifar10", device="cpu"), tmp_path / "p2",
                                 9, use_drs=True, use_original_netD=True)
    assert all(torch.equal(a, b) for a, b in zip(own.state_dict().values(),
                                                tr2.d.module.state_dict().values()))


def _sigterm_at(monkeypatch, at):
    """The trainer's fused step, sending SIGTERM to this process during step `at`."""
    make = TT.make_fused_step

    def make_and_stop(*a, **k):
        fused = make(*a, **k)

        def step(global_step, draws):
            out = fused(global_step, draws)
            if global_step == at:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        return step

    monkeypatch.setattr(TT, "make_fused_step", make_and_stop)


def _run_state(run):
    ck = run / "checkpoints"
    out = {}
    for net in ("netG", "netD"):
        raw = torch.load(ck / net / f"{net}_6_steps.pth", weights_only=True)
        out[net] = (raw["model_state_dict"], raw["optimizer_state_dict"]["state"],
                    raw["update_count"])
    with open(run / "logits_netD_eval.pkl", "rb") as f:
        out["logits"] = pickle.dumps(pickle.load(f))
    return out


def test_sigterm_flushes_a_checkpoint_that_resumes_bit_for_bit(narrow, tmp_path, monkeypatch):
    """SIGTERM stops the run after the current step and writes that step's
    checkpoints, logit buffer and pickle; resuming from them (--ckpt_step)
    gives the uninterrupted run's weights, Adam state, update counts and
    logits, bit for bit (each step's draws come from (seed, step))."""
    full = train_mimicry_phase1.main(narrow + PHASE1[:1] + ["full"] + PHASE1[2:])
    assert full.global_step == 6

    with monkeypatch.context() as mp:
        _sigterm_at(mp, 2)
        stopped = train_mimicry_phase1.main(narrow + PHASE1)
    assert stopped.global_step == 3
    ck = tmp_path / "p1" / "checkpoints"
    assert sorted(p.name for p in (ck / "netG").iterdir()) == ["netG_3_steps.pth"]
    assert (ck / "netD" / "netD_3_steps.pth").is_file() and (ck / "logit_buffer.npz").is_file()
    with open(tmp_path / "p1" / "logits_netD_eval.pkl", "rb") as f:
        assert list(pickle.load(f)) == [2]
    assert signal.getsignal(signal.SIGTERM) is not None  # the old handler is back

    resumed = train_mimicry_phase1.main(narrow + PHASE1 + ["--ckpt_step", "3"])
    assert resumed.global_step == 6
    a, b = _run_state(tmp_path / "full"), _run_state(tmp_path / "p1")
    assert a["logits"] == b["logits"]
    for net in ("netG", "netD"):
        (wa, sa, ca), (wb, sb, cb) = a[net], b[net]
        assert ca == cb and list(wa) == list(wb)
        assert all(torch.equal(wa[k], wb[k]) for k in wa), net
        assert sa.keys() == sb.keys() and len(sa) > 0
        for k in sa:
            for field in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(sa[k][field], sb[k][field]), (net, k, field)


@pytest.mark.parametrize("flag", ["--data_parallel"])
@pytest.mark.parametrize("cli", [train_mimicry_phase1, train_mimicry_phase2],
                         ids=["phase1", "phase2"])
def test_flags_not_in_the_port_raise(cli, flag, narrow):
    with pytest.raises(NotImplementedError, match="not in the port yet"):
        cli.main(narrow + ["--exp_name", "x", flag])


def test_cli_flags_match_the_root_scripts():
    """cli/train_mimicry_phase{1,2}.py keep the argparse surfaces of the root
    train_mimicry_phase{1,2}.py (option strings, defaults, types, actions),
    plus --device; captured live by scripts/dump_argparse.py."""
    repo = Path(__file__).resolve().parents[1]
    saved_path = list(sys.path)
    sys.path.insert(0, str(repo / "scripts"))
    try:
        from dump_argparse import capture_script

        names = ("train_mimicry_phase1", "train_mimicry_phase2")
        want = [capture_script(str(repo / f"{n}.py")) for n in names]
        got = [capture_script(str(repo / "diagan_tpu_torch" / "cli" / f"{n}.py")) for n in names]
    finally:
        sys.path[:] = saved_path
        sys.modules.pop("dump_argparse", None)
    assert [len(w) for w in want] == [27, 22]  # the whole surfaces were captured
    for ours, theirs in zip(got, want):
        device = ours.pop("--device")
        assert device["default"] == "cuda" and device["type"] == "str"
        assert ours == theirs
