"""The reader of fir_up4_pct.sg3t_drs on synthetic counters of the program
(utils/trace.py): every 24-tap up-4 call on the up-4 instances reads 100,
half of them 50, and a window that counted none, or a program without the
counters, None."""
import pytest
import torch

from benchmark.harness import core
from benchmark.harness import trace as bench_trace
from diagan_tpu_torch.utils import trace

READER = core.load_module(core.BENCH_DIR / "metrics" / "fir_up4_pct.sg3t_drs.py")


def facts(monkeypatch, counters):
    """Facts of a traced window whose program recorded one span and
    `counters`."""
    session = trace._Session()
    session.spans = [[0, 50, "drs.generate", None]]
    session.counters = dict(counters)
    monkeypatch.setattr(trace._REC, "session", session)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    return {"window_s": 1.0, "trace": bench_trace.Trace()}


@pytest.mark.parametrize("counters,want", [
    ({"fir_up4_calls": 160, "fir_up4_family": 160}, 100.0),
    ({"fir_up4_calls": 160, "fir_up4_family": 80}, 50.0),
    ({"fir_up4_calls": 0, "fir_up4_family": 0}, None),
    ({"filtered_lrelu": 280, "filtered_lrelu_fused": 280}, None),  # a program before the counters
])
def test_the_share_of_up4_calls_on_the_family(monkeypatch, counters, want):
    got = READER.read(facts(monkeypatch, counters))
    assert got == (pytest.approx(want) if want is not None else None)
    assert (READER.LAYER, READER.MOVES) == ("ops", "drs_accepted_per_s")


def test_nothing_recorded_reads_none(monkeypatch):
    f = facts(monkeypatch, {"fir_up4_calls": 8, "fir_up4_family": 8})
    trace._REC.session.spans = []
    assert READER.read(f) is None
