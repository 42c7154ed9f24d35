"""The port's headline benchmark (diagan_tpu_torch/cli/bench.py), on the CPU.

The measuring functions run here at tiny widths (SNGAN-32 at ngf = ndf = 16,
StyleGAN2 at 16 px and width 1/16) to hold their control flow: which global
steps each window runs, what a timed window may not do (read a device value
on the host, tune ADA), the FLOP counter's closed forms and the amortised
StyleGAN2 basis, the SNGAN step's count against XLA's count of the JAX
package's step, the CLI without a card and the key set of its line. The
numbers themselves come only from the card.
"""
import functools
import json
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from diagan_tpu_torch.cli import bench  # noqa: E402
from diagan_tpu_torch.models import registry, sngan, stylegan2  # noqa: E402
from diagan_tpu_torch.models.ada import AdaptiveAugment  # noqa: E402

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]
NGF = NDF = 16


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def narrow(monkeypatch):
    """The bench's models at test widths."""
    monkeypatch.setitem(registry._GEN_32, "sngan",
                        functools.partial(sngan.SNGANGenerator32, ngf=NGF))
    monkeypatch.setitem(registry._DISC_32, "sngan",
                        functools.partial(sngan.SNGANDiscriminator32, ndf=NDF))
    monkeypatch.setattr(bench, "StyleGAN2Generator",
                        functools.partial(stylegan2.StyleGAN2Generator, width_scale=1 / 16))
    monkeypatch.setattr(bench, "StyleGAN2Discriminator",
                        functools.partial(stylegan2.StyleGAN2Discriminator, width_scale=1 / 16))


def tiny_trainer(tmp_path):
    return bench.sg2_trainer(CPU, tmp_path, size=16, batch=4, n_images=16)


# --- (a) the StyleGAN2 window -------------------------------------------------
@pytest.mark.parametrize("p", [0.0, bench.SG2_ADA_P])
def test_sg2_measure_times_global_steps_25_to_49_at_pinned_p(p, narrow, tmp_path, monkeypatch):
    tr = tiny_trainer(tmp_path)
    passes, augs = [], []
    train_step, r1_step, path_step, draw_aug = (tr.train_step, tr.r1_step, tr.path_step,
                                                tr.draw_aug)

    def recorded(step):
        passes.append({"step": step, "r1": 0, "path": 0})
        out = train_step(step)
        assert tr.ada_aug_p == p
        return out

    def count(name, fn):
        def wrapper(*a, **k):
            passes[-1][name] += 1
            return fn(*a, **k)
        return wrapper

    def aug():
        augs.append(draw_aug())
        return augs[-1]

    def no_tuning(*a, **k):
        raise AssertionError("ADA tuned inside a bench window")

    monkeypatch.setattr(tr, "train_step", recorded)
    monkeypatch.setattr(tr, "r1_step", count("r1", r1_step))
    monkeypatch.setattr(tr, "path_step", count("path", path_step))
    monkeypatch.setattr(tr, "draw_aug", aug)
    monkeypatch.setattr(tr, "tune_ada", no_tuning)
    monkeypatch.setattr(AdaptiveAugment, "tune", no_tuning)
    tr.ada_aug_p = 0.3  # whatever an earlier run left: the measurement pins its own p

    s_per_step, per_step = bench.sg2_measure(tr, 25, p)

    assert [r["step"] for r in passes] == list(range(25, 50)) * 2
    for half in (passes[:25], passes[25:]):  # the warm pass, then the timed one
        assert [r["step"] for r in half if r["r1"]] == [32, 48]
        assert [r["step"] for r in half if r["path"]] == [28, 32, 36, 40, 44, 48]
        assert sum(r["r1"] for r in half) == 2 and sum(r["path"] for r in half) == 6
    assert tr.ada_aug_p == p
    assert len(augs) == 2 * (25 * 3 + 2)  # D's two, G's one a step; R1's one
    if p == 0.0:
        assert all(a is None for a in augs)
    else:
        assert all(a is not None for a in augs)
    assert s_per_step > 0 and len(per_step) == 25 and all(s > 0 for s in per_step)
    kinds = [bench.step_kind(tr, s) for s in range(25, 50)]
    assert [kinds.count(k) for k in ("plain", "path", "r1", "r1+path")] == [19, 4, 0, 2]


# --- (b) the SNGAN window -----------------------------------------------------
HOST_READS = ("item", "tolist", "numpy", "__float__", "__int__", "__bool__")


def test_sngan_window_runs_steps_0_to_249_with_no_host_read_while_timed(narrow, monkeypatch):
    sn = bench.sngan_setup(CPU, n_data=64, batch_size=2, n_dis=1)
    fused, steps, timed = sn.fused, [], {"on": False, "adam_steps": set()}

    def recorded(step, draws):
        steps.append(step)
        if step == 50:  # the first timed step: Adam's step counts exist by now
            timed["adam_steps"] = {id(s["step"]) for net in (sn.g, sn.d)
                                   for s in net.optim.state.values()}
            timed["on"] = True
        out = fused(step, draws)
        if step == 249:
            timed["on"] = False
        return out

    def guarded(name, orig):
        def read(self, *a, **k):
            # Adam's own step counts live on the host, on the card too
            # (capturable=False): reading them syncs nothing
            if timed["on"] and id(self) not in timed["adam_steps"]:
                raise AssertionError(f"host read .{name} inside the timed window")
            return orig(self, *a, **k)
        return read

    for name in HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, guarded(name, getattr(torch.Tensor, name)))
    sn.fused = recorded

    sps, per_chunk = bench.sngan_measure(sn, CPU)

    assert steps == list(range(250))
    assert not timed["on"] and timed["adam_steps"]
    assert sps > 0 and len(per_chunk) == 4 and all(c > 0 for c in per_chunk)


def test_a_host_read_in_the_window_is_caught(narrow, monkeypatch):
    """The guard of the test above fails a step that reads a loss."""
    sn = bench.sngan_setup(CPU, n_data=64, batch_size=2, n_dis=1)
    fused = sn.fused

    def reads_a_loss(step, draws):
        return {k: v.item() for k, v in fused(step, draws).items()}

    on = {"v": False}

    def item(self):
        if on["v"]:
            raise AssertionError("host read")
        return orig(self)

    orig = torch.Tensor.item
    monkeypatch.setattr(torch.Tensor, "item", item)
    sn.fused = reads_a_loss
    on["v"] = True
    with pytest.raises(AssertionError, match="host read"):
        bench.sngan_measure(sn, CPU, warm=1, timed=1)


# --- (c) the FLOP counter -----------------------------------------------------
def _layers():
    g = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=g)

    n, cin, cout, k, h = 3, 5, 7, 3, 6
    return {
        # conv k x k, SAME: 2 N Cout Cin k^2 H W
        "conv": (lambda x, w: F.conv2d(x, w, padding=1), rand(n, cin, h, h),
                 rand(cout, cin, k, k), 2 * n * cout * cin * k * k * h * h),
        # the reference ModulatedConv: N styled kernels as one grouped conv
        "grouped_conv": (lambda x, w: F.conv2d(x, w, padding=1, groups=n),
                         rand(1, n * cin, h, h), rand(n * cout, cin, k, k),
                         2 * n * cout * cin * k * k * h * h),
        # transposed x2 (the StyleGAN2 upsampling conv): every input pixel
        # meets the whole kernel, 2 N Cin Cout k^2 H W
        "transposed_conv": (lambda x, w: F.conv_transpose2d(x, w, stride=2),
                            rand(n, cin, h, h), rand(cin, cout, k, k),
                            2 * n * cin * cout * k * k * h * h),
        # linear: 2 N in out (the bias add is not a MAC)
        "linear": (lambda x, w: F.linear(x, w, torch.zeros(cout)), rand(n, cin), rand(cout, cin),
                   2 * n * cin * cout),
        # the spectral norm's power iteration: W v and u . (W v)
        "spectral_norm": (lambda u, w: torch.dot(u, w @ (u @ w)), rand(cout),
                          rand(cout, cin), 2 * cout * cin * 2 + 2 * cout),
    }


@pytest.mark.parametrize("kind", list(_layers()))
def test_flop_counter_gives_the_closed_form(kind):
    fn, x, w, want = _layers()[kind]
    assert bench.count_flops(lambda: fn(x, w))[1] == want
    if kind != "spectral_norm":  # backward: the input's and the weight's gradients
        x.requires_grad_(True)
        w.requires_grad_(True)
        assert bench.count_flops(lambda: fn(x, w).sum().backward())[1] == 3 * want


def test_sg2_amortised_basis_is_the_sum_of_its_substeps(narrow, tmp_path):
    tr = tiny_trainer(tmp_path)
    tr.ada_aug_p = 0.0
    parts = bench.sg2_flops(tr)
    d, r1, g, path = (parts[k] for k in ("d", "r1", "g", "path"))
    assert min(d, r1, g, path) > 0
    assert parts["amortised"] == d + g + r1 / 16 + path / 4
    # a whole step is its sub-steps: plain, path length, R1 and path length
    for step, want in ((25, d + g), (28, d + g + path), (32, d + r1 + g + path)):
        assert bench.count_flops(lambda: tr.train_step(step))[1] == want, step


# --- (d) the SNGAN step's count against XLA's count of the JAX step -------------
SNGAN_XLA_RATIO = (1.00, 1.10)  # port's FlopCounterMode count / XLA's cost_analysis


def xla_sngan_step_flops(ngf, ndf, batch_size, n_dis, n_data):
    """XLA's cost_analysis FLOPs of the JAX package's fused SNGAN-32 step
    (hinge, n_dis D updates and one G update), compiled on the CPU from
    abstract states: the program bench.py counts, its scan body once."""
    import jax
    import jax.numpy as jnp

    from diagan_tpu.models import sngan as J
    from diagan_tpu.train.state import create_net_state
    from diagan_tpu.train.steps import StepConfig, make_fused_step
    from diagan_tpu.train.trainer import _make_tx

    gen, disc = J.SNGANGenerator32(ngf=ngf), J.SNGANDiscriminator32(ndf=ndf)
    tx_g = _make_tx(2e-4, (0.0, 0.9), 50000, "linear", 1)
    tx_d = _make_tx(2e-4, (0.0, 0.9), 50000, "linear", n_dis)
    cfg = StepConfig(n_dis=n_dis, batch_size=batch_size, nz=128, loss_type="hinge",
                     drs_loss_type="ns", model="sngan", gold=False, gold_step=0, topk=False,
                     epoch_steps=n_data // batch_size, use_drs=False, quantized=True)
    k = jax.random.key(0)
    g = jax.eval_shape(lambda: create_net_state(gen, {"params": k}, (jnp.zeros((2, 128)),),
                                                tx_g, train=True))
    d = jax.eval_shape(lambda: create_net_state(disc, {"params": k, "dropout": k},
                                                (jnp.zeros((2, 32, 32, 3)),), tx_d))
    fused = make_fused_step(gen, disc, None, tx_g, tx_d, None, cfg, n_data, 1)
    images = jax.ShapeDtypeStruct((n_data, 32, 32, 3), jnp.uint8)
    ca = jax.jit(fused).lower(g, d, None, images, images, None, k,
                              jnp.int32(0)).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    return float(ca["flops"])


def test_sngan_step_count_lies_within_10_percent_above_xlas(narrow):
    batch_size, n_dis, n_data = 4, 5, 64
    sn = bench.sngan_setup(CPU, n_data=n_data, batch_size=batch_size, n_dis=n_dis)
    port = bench.sngan_flops(sn, CPU, 0)
    xla = xla_sngan_step_flops(NGF, NDF, batch_size, n_dis, n_data)
    print(f"SNGAN-32 step at ngf {NGF}, ndf {NDF}, batch {batch_size}, n_dis {n_dis}: port "
          f"{port / 1e9:.4f} GFLOP, XLA {xla / 1e9:.4f} GFLOP, ratio {port / xla:.4f}")
    assert SNGAN_XLA_RATIO[0] <= port / xla <= SNGAN_XLA_RATIO[1]


# --- (e) no card ----------------------------------------------------------------
def test_main_without_a_card_raises_and_prints_no_line(monkeypatch, capsys):
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bench.main([])
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    assert "{" not in capsys.readouterr().out


# --- (f) the line ---------------------------------------------------------------
# bench.py's fields, less its comparison with earlier TPU rounds
BENCH_PY_FIELDS = {"metric", "value", "unit", "vs_baseline", "flops_per_step", "mfu_pct",
                   "drs_samples_per_sec", "sg2_256_ms_per_step", "sg2_256_img_per_sec",
                   "sg2_256_gflop_per_step", "sg2_256_mfu_pct", "sg2_256_ada_ms_per_step",
                   "sg2_256_ada_img_per_sec"}
PORT_FIELDS = {"device", "precision", "mfu_peak_tflops", "sg2_256_mfu_peak_tflops"}


def test_the_line_has_bench_pys_fields_and_the_ports(narrow, monkeypatch):
    text = (REPO / "bench.py").read_text()
    assert all(f'"{k}"' in text for k in BENCH_PY_FIELDS | {"prev_bench", "regressions"})
    monkeypatch.setattr(bench, "SG2_SIZE", 16)  # the FLOP fields' configuration
    monkeypatch.setattr(bench, "SG2_BATCH", 4)
    monkeypatch.setattr(bench, "SG2_STEPS", 4)
    monkeypatch.setattr(bench, "sngan_setup",
                        functools.partial(bench.sngan_setup, n_data=64, batch_size=4))
    monkeypatch.setattr(bench, "sg2_trainer",
                        functools.partial(bench.sg2_trainer, size=16, batch=4, n_images=16))
    monkeypatch.setattr(bench, "DRS", functools.partial(bench.DRS, warmup_batches=2))
    card = {"name": "stand-in", "power_limit": "0 W", "count": 1}
    out, runs = bench.headline(CPU, card, sngan_warm=2, sngan_timed=3, drs_quota=32)
    assert set(out) == BENCH_PY_FIELDS | PORT_FIELDS
    assert out["device"] == card and out["precision"] == bench.PRECISION
    assert (out["mfu_peak_tflops"], out["sg2_256_mfu_peak_tflops"]) == (67.0, 989.0)
    for k, v in out.items():
        if isinstance(v, float):
            assert math.isfinite(v) and v > 0, k
    assert out["mfu_pct"] <= 100 and out["sg2_256_mfu_pct"] <= 100
    assert json.loads(json.dumps(out)) == out
    assert list(runs) == ["sngan", "drs", "sg2 p=0.0", f"sg2 p={bench.SG2_ADA_P}"]
    # no port kernel launches on the CPU: every wrapper takes its plain twin
    assert all(not any(r.values()) for r in runs.values())
    assert not re.search(r"\bjax\b|diagan_tpu\b(?!_torch)",
                         "\n".join(ln for ln in (REPO / "diagan_tpu_torch" / "cli" /
                                                 "bench.py").read_text().splitlines()
                                   if ln.startswith(("import", "from"))))
    assert np.isfinite(out["sg2_256_gflop_per_step"])
