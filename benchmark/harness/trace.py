"""The traced window: torch.profiler over the window, CUDA activity only (the
host's operator events would slow a host-paced step severalfold), reduced
from its raw Kineto events (building the FunctionEvent tree of ~10^5
device events takes minutes) to

  busy_s        the union of the device's operation intervals (kernels,
                copies, memsets; annotations are not operations), seconds;
  device_ops    device time by operation name;
  idle_gaps     the gaps between device operations, each named by the
                benchmark's innermost span at the gap's middle.

Spans are the benchmark's own, `span(<what>)` around its calls into the
program, kept in memory as (name, start, end) on the host's epoch clock,
which Kineto's timestamps share, and only while a window is traced.
"""
from __future__ import annotations

import re
import time
from contextlib import contextmanager, nullcontext

import torch

_SPANS: list | None = None


@contextmanager
def _recorded(name):
    t = time.time_ns()
    try:
        yield
    finally:
        _SPANS.append((t, time.time_ns(), f"bench.{name}"))


def span(name):
    return nullcontext() if _SPANS is None else _recorded(name)


def _is_operation(e):
    """A kernel, copy or memset on the card (not a range annotation)."""
    if e.device_type() != torch.autograd.DeviceType.CUDA or e.is_user_annotation():
        return False
    kind = getattr(e, "activity_type", None)
    return "annotation" not in str(kind() if kind else "").lower() and "#" not in e.name()


class Trace:
    def __init__(self):
        self.kernels = []  # (start_ns, end_ns, name) on the device
        self.spans = []  # (start_ns, end_ns, name) on the host

    def reduce(self, prof):
        for e in prof.profiler.kineto_results.events():
            if _is_operation(e):
                s = e.start_ns()
                self.kernels.append((s, s + e.duration_ns(), e.name()))
        self.kernels.sort()
        return self

    def busy_s(self):
        busy, end = 0, None
        for s, e, _ in self.kernels:
            if end is None or s > end:
                busy, end = busy + e - s, e
            elif e > end:
                busy, end = busy + e - end, e
        return busy / 1e9

    def device_time(self, pattern):
        """Seconds of the device operations whose name matches `pattern`."""
        rx = re.compile(pattern)
        return sum(e - s for s, e, n in self.kernels if rx.search(n)) / 1e9

    def device_ops(self, top=10):
        by = {}
        for s, e, n in self.kernels:
            by[n] = by.get(n, 0) + (e - s)
        return [[n[:160], t / 1e9] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top=10):
        gaps, end = [], None
        for s, e, _ in self.kernels:
            if end is not None and s > end:
                gaps.append((s - end, end, s))
            end = e if end is None else max(end, e)
        out = []
        for g, a, b in sorted(gaps, reverse=True)[:top]:
            mid = (a + b) // 2
            inner = [sp for sp in self.spans if sp[0] <= mid <= sp[1]]
            name = min(inner, key=lambda sp: sp[1] - sp[0])[2] if inner else "outside spans"
            out.append([name, g / 1e9])
        return out


@contextmanager
def traced(enabled):
    """Profile the body when `enabled`; yields the Trace, filled on exit."""
    global _SPANS
    tr = Trace()
    if not enabled:
        yield tr
        return
    _SPANS = tr.spans
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            yield tr
            torch.cuda.synchronize()
    finally:
        _SPANS = None
    tr.reduce(prof)
