"""The readers of the program's spans (harness/program_trace.py) on synthetic
device operations and spans: an idle gap split exactly across two spans, the
innermost span's claim, device self time less nested device spans, and None
when the program recorded nothing or has no trace module. One test needs the
card: a host sleep inside a program span between two kernels, under the
harness's CUDA-only profiler, is an idle gap put down to that span (the
program's and the profiler's clocks agree)."""
import sys
import time

import pytest
import torch

from benchmark.harness import program_trace as pt
from benchmark.harness import trace as bench_trace
from diagan_tpu_torch import utils
from diagan_tpu_torch.utils import trace

BENCH = [(0, 100, "bench.step")]


def idle(kernels, spans):
    return pt.idle_by_span(kernels, BENCH, spans)


def test_a_gap_is_split_exactly_at_a_span_boundary():
    kernels = [(0, 10, "k"), (50, 100, "k")]
    spans = [(5, 30, "a", None), (30, 60, "b", None)]
    assert idle(kernels, spans) == {"a": 20, "b": 20}


def test_the_window_is_the_extent_of_the_benchmark_spans():
    kernels = [(-50, 5, "k"), (95, 200, "k")]
    assert idle(kernels, []) == {None: 90}
    assert pt.idle_by_span(kernels, [(0, 40, "bench.a"), (60, 100, "bench.b")], []) \
        == {None: 90}


def test_the_innermost_span_takes_the_gap():
    kernels = [(0, 10, "k"), (90, 100, "k")]
    spans = [(0, 100, "outer", None), (20, 40, "inner", 0), (25, 30, "innermost", 1),
             (60, 70, "second", 0)]
    got = idle(kernels, spans)
    assert got == {"outer": 10 + 20 + 20, "inner": 15, "innermost": 5, "second": 10}
    assert sum(got.values()) == 80


def test_idle_under_no_program_span_and_open_spans():
    kernels = [(0, 10, "k"), (40, 50, "k")]
    spans = [(10, 20, "a", None), (30, None, "open", None)]
    assert idle(kernels, spans) == {"a": 10, None: 20 + 50}


class _Event:
    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


def recorded(monkeypatch, spans, events, counters=None):
    """The program's recorder holding `spans` and events {index: (start ms,
    end ms)}, recording off."""
    session = trace._Session()
    session.spans = [list(s) for s in spans]
    session.events = {i: [_Event(a), _Event(b)] for i, (a, b) in events.items()}
    session.counters = dict(counters or {})
    monkeypatch.setattr(trace._REC, "session", session)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)


def test_device_self_time_leaves_out_nested_device_spans(monkeypatch):
    spans = [(0, 100, "train.d_main", None), (10, 20, "data.draw", 0),
             (11, 19, "ada.augment", 1), (30, 40, "ada.augment", 0),
             (50, 60, "train.g", None)]
    recorded(monkeypatch, spans, {0: (0.0, 9.0), 2: (1.0, 2.5), 3: (4.0, 5.0), 4: (9.0, 12.0)},
             {"host_sync": 6})
    assert trace.device_ms() == {0: 9.0 - 1.5 - 1.0, 2: 1.5, 3: 1.0, 4: 3.0}
    facts = {"window_s": 0.02, "trace": bench_trace.Trace(), "kinds": ["plain"] * 3}
    assert pt.phase_pct(facts, ("train.d_main",)) == pytest.approx(100 * 6.5 / 20)
    assert pt.phase_pct(facts, ("ada.augment", "train.g")) == pytest.approx(100 * 5.5 / 20)
    assert pt.per(facts, "host_sync", len(facts["kinds"])) == 2.0
    assert pt.per(facts, "other", 3) == 0.0


def test_readers_give_none_when_nothing_was_recorded(monkeypatch):
    tr = bench_trace.Trace()
    tr.kernels, tr.spans = [(0, 10, "k")], list(BENCH)
    recorded(monkeypatch, [], {})
    facts = {"window_s": 1e-7, "trace": tr}
    assert pt.phase_pct(facts, ("train.g",)) is None
    assert pt.idle_pct(facts, lambda name: name is None) is None
    assert pt.per(facts, "host_sync", 4) is None
    recorded(monkeypatch, [(0, 50, "train.g", None)], {})
    with monkeypatch.context() as m:  # a program from before the module
        m.delattr(utils, "trace")
        m.setitem(sys.modules, "diagan_tpu_torch.utils.trace", None)
        facts = {"window_s": 1e-7, "trace": tr}
        assert pt.idle_pct(facts, lambda name: name is None) is None
        assert pt.phase_pct(facts, ("train.g",)) is None
    facts = {"window_s": 1e-7, "trace": tr}
    assert pt.idle_pct(facts, lambda name: name == "train.g") == pytest.approx(40.0)
    assert pt.idle_pct(facts, lambda name: name is None) == pytest.approx(50.0)


def test_a_host_sleep_in_a_span_is_its_idle_gap_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.randn(2048, 2048, device="cuda")
    (x @ x).sum().item()  # warm
    with bench_trace.traced(True) as tr:
        with bench_trace.span("clock"):
            y = x @ x
            torch.cuda.synchronize()
            with trace.span("test.sleep"):
                time.sleep(0.02)
            y = y @ x
            torch.cuda.synchronize()
    spans = trace.spans()
    assert [s[2] for s in spans] == ["test.sleep"]
    got = pt.idle_by_span(tr.kernels, tr.spans, spans)
    print(f"idle by span (ns): {got}; kernels {len(tr.kernels)}")
    assert got.get("test.sleep", 0) >= 18_000_000
    assert got.get("test.sleep", 0) <= 25_000_000
    del y

