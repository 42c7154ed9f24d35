"""The StyleGAN3-T DRS cell (sg3t_256.drs) on the CPU at a size a test can
hold: its files, a sound run read `correct` with every gap at round-off,
the TF32 control and each fault read incorrect (L10's up filter designed at
layer 8's cutoff, planted in the program; a served code altered; every
proposal accepted), and the reference's count of one layer's FLOPs and
bytes against a count by hand."""
import functools
import time
import types

import pytest
import torch

from benchmark.harness import core
from benchmark.reference import ops
from benchmark.reference import stylegan3 as ref
from benchmark.reference.sg2_train import flop_counter
from benchmark.tests.test_perfbench_faults import drs_accept_all, drs_altered
from benchmark.traffic import sg3_drs

CELL = "sg3t_256.drs"
TINY = dict(img_resolution=32, channel_base=256, channel_max=8, d_width_scale=1 / 32,
            drs_batch=8, drs_warmup_batches=2)
PARAMS = dict(request=6, calibration_batch=4, reference_block=4)
CPU_GAPS = {"logit_gap": 1e-4, "image_gap": 1e-2}


def narrow(monkeypatch):
    """The registry's StyleGAN3 G and StyleGAN2 D at TINY's widths."""
    from diagan_tpu_torch.models import registry, stylegan3
    from diagan_tpu_torch.models.stylegan2 import StyleGAN2Discriminator
    monkeypatch.setattr(registry, "_STYLEGAN3_G", functools.partial(
        stylegan3.StyleGAN3Generator, channel_base=TINY["channel_base"],
        channel_max=TINY["channel_max"]))
    monkeypatch.setattr(registry, "_STYLEGAN2_D", functools.partial(
        StyleGAN2Discriminator, width_scale=TINY["d_width_scale"]))


def run_cell(tmp_path, monkeypatch, controls="", seed=2 ** 31 + 7):
    """(correct, checks, ctx) of one run of the cell on the CPU at TINY."""
    narrow(monkeypatch)
    workload = core.load_json(core.BENCH_DIR / "workloads" / f"{CELL}.json")
    config = core.load_json(core.BENCH_DIR / "configs" / f"{workload['config']}.json")
    workload = dict(workload, params=dict(workload["params"], **PARAMS))
    args = types.SimpleNamespace(seed=seed, seconds=0.5, trace=0, controls=controls)
    ctx = core.Context(args, workload, dict(config, **TINY), time.perf_counter())
    ctx.scratch = str(tmp_path)
    core.load_module(core.BENCH_DIR / "traffic" / f"{workload['driver']}.py").run(
        ctx, torch.device("cpu"))
    correct, checks = core.verdict(ctx.checks)
    return correct, {n: v for n, v, _ in checks}, ctx


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_cell_finds_its_files_and_states_its_cut():
    workload, config, e2e, per_layer = core.find_cell(CELL)
    assert (workload["driver"], workload["chips"], workload["config"]) == \
        ("sg3_drs", 1, "stylegan3-t-256-ffhqu")
    assert {m["name"] for m in e2e} == {"drs_accepted_per_s", "setup_s"}
    assert len(per_layer) == 8 and all(m["workloads"] == [CELL] for m in per_layer)
    assert config["reduced"] == ["drs_batch", "drs_warmup_batches"]
    assert set(config["reduced"]) <= set(config["assumed"])
    layers, inp = ref.schedule(config)
    rows = config["layers"]["rows"]
    assert [[s["name"], s["cout"], s["up"], s["up_taps"], s["down"], s["down_taps"],
             list(s["pad"])] for s in layers] == \
        [[r[0], r[3], r[4], r[5], r[6], r[7], r[8]] for r in rows]
    assert inp == dict(channels=config["input"]["channels"], size=config["input"]["size"],
                       sr=config["input"]["sampling_rate"], bandwidth=config["input"]["bandwidth"])


def test_a_sound_run_is_correct(tmp_path, monkeypatch):
    correct, checks, ctx = run_cell(tmp_path, monkeypatch)
    assert correct, checks
    for name, value in checks.items():
        assert value <= CPU_GAPS.get(name, ctx.workload["limits"].get(name, 0.0)), (name, value)
    assert ctx.attempted > 0 and ctx.setup_s > 0 and ctx.e2e["drs_accepted_per_s"] > 0
    assert core.loaded_forbidden() == []


def test_the_controls_read_incorrect(tmp_path, monkeypatch):
    """TF32 (rounded in the forward's products on the CPU) and the program's G
    with L10's filter at layer 8's cutoff each fail one of the cell's
    numbers, while the run itself is correct."""
    correct, _, ctx = run_cell(tmp_path, monkeypatch, controls="tf32,l10_filter")
    assert correct
    limits = ctx.workload["limits"]
    for control in ("tf32", "l10_filter"):
        read = ctx.facts["controls"][control]
        assert any(read[n] > limits[n] for n in read), (control, read, limits)


@pytest.mark.parametrize("fault", ["l10_filter", "altered", "accept_all"])
def test_a_broken_timed_path_reads_incorrect(fault, tmp_path, monkeypatch):
    if fault == "l10_filter":
        from diagan_tpu_torch.models import stylegan3
        patch = sg3_drs.l10_filter_fault(stylegan3)
        patch.start()
        try:
            correct, checks, _ = run_cell(tmp_path, monkeypatch)
        finally:
            patch.stop()
    else:
        {"altered": drs_altered, "accept_all": drs_accept_all}[fault](monkeypatch)
        correct, checks, _ = run_cell(tmp_path, monkeypatch)
    assert not correct, checks


def test_count_forward_of_one_layer_by_hand():
    """One 2x layer of the 256 px schedule at batch 2: the grouped conv at
    full padding, the affine, the four FIR passes (their depthwise
    convolutions over the zero-stuffed input), and the bytes of each call."""
    cfg = dict(core.load_json(core.BENCH_DIR / "configs" / "stylegan3-t-256-ffhqu.json"))
    spec = ref.schedule(cfg)[0][0]  # L0: 36 -> 36, 512 channels, up 2, down 2, pad (9, 8)
    layer = ref.Layer(spec, 512, device="meta")
    n, c, s = 2, 512, 36
    ops.CALLS = calls = []
    counter = flop_counter()
    try:
        with counter, torch.no_grad():
            y = layer(torch.empty((n, c, s, s), device="meta"),
                      torch.empty((n, 512), device="meta"))
    finally:
        ops.CALLS = None
    assert y.shape == (n, c, 36, 36)
    conv = 2 * n * c * c * 9 * 38 * 38
    affine = 2 * n * 512 * c
    w1 = 38 * 2 + 9 + 8 - 12 + 1  # 82: after the x up pass, and the y pass's rows
    firs = 2 * n * c * (38 * w1 * 12 + w1 * w1 * 12 + w1 * 36 * 12 + 36 * 36 * 12)
    assert counter.get_total_flops() == conv + affine + firs
    elems = [(38 * 38, 38 * w1), (38 * w1, w1 * w1), (w1 * w1, w1 * w1), (w1 * w1, w1 * 36),
             (w1 * 36, 36 * 36)]
    assert [op for op, _, _ in calls] == ["fir", "fir", "act", "fir", "fir"]
    assert [b for _, b, _ in calls] == [4 * n * c * (a + b) for a, b in elems]
    # the fir calls' FLOPs count real taps only: 6 of 12 at up 2
    assert [f for _, _, f in calls] == [2 * n * c * 38 * w1 * 6, 2 * n * c * w1 * w1 * 6, 0,
                                        2 * n * c * w1 * 36 * 12, 2 * n * c * 36 * 36 * 12]
