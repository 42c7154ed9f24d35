"""Spans and counters inside the port, recorded while a torch.profiler session
collects and at no other time.

    with trace.span("train.g", device=self.device):
        ...                      # the G step
    trace.count("host_sync")     # one device-to-host read

A span is (start_ns, end_ns, name, parent): both times on `time.time_ns()`,
the host's epoch clock, which the profiler's device timestamps share, so a
span lies over the device operations of the same session; `parent` is the
index of the span that was open around it, None at the top. A span given a
CUDA device also records a timing event on that device's current stream at
entry and at exit; `device_ms()` turns each pair into the stream's time
between the two, busy or starved, less that of the device-timed spans nested
in it (the span's self time on the device).

Recording follows the profiler (`torch.autograd.profiler`'s flag, which every
torch.profiler session sets while it collects): an operator who profiles
training, and a benchmark's traced window, get the spans with no change to
their code, and outside a session `span` costs one flag read and returns a
shared null context, `count` one flag read. A session's first span or count
empties the buffers once the recorder has found recording off (in `span`'s
exit, or in an accessor called between sessions), so a session that follows
a read starts empty. Spans are opened and closed by one thread, the one that
drives the step.

The kernels' launch counters stay in ops/_build.py; the counters here are
those of host-side events at the layer boundaries (`host_sync`: a read that
waits for the device).
"""
from __future__ import annotations

import time
from contextlib import nullcontext

import torch
import torch.autograd.profiler as _profiler

_OFF = nullcontext()


class _Session:
    """What one profiler session recorded."""

    def __init__(self):
        self.spans = []  # [start_ns, end_ns, name, parent], end None while open
        self.events = {}  # span index -> [start event, end event]
        self.counters = {}
        self.open = []  # indices of the open spans, innermost last


class _Recorder:
    def __init__(self):
        self.session = _Session()
        self.live = False  # `session` belongs to the profiler session collecting now

    def current(self):
        if not self.live:
            self.session, self.live = _Session(), True
        return self.session


_REC = _Recorder()


class _Span:
    __slots__ = ("session", "index", "stream")

    def __init__(self, name, device):
        t = time.time_ns()
        s = self.session = _REC.current()
        self.index = len(s.spans)
        s.spans.append([t, None, name, s.open[-1] if s.open else None])
        s.open.append(self.index)
        self.stream = (torch.cuda.current_stream(device)
                       if device is not None and device.type == "cuda" else None)
        if self.stream is not None:
            s.events[self.index] = [_event(self.stream), None]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        s = self.session
        if self.stream is not None:
            s.events[self.index][1] = _event(self.stream)
        s.spans[self.index][1] = time.time_ns()
        s.open.pop()
        if not _profiler._is_profiler_enabled:
            _REC.live = False
        return False


def _event(stream):
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


def span(name, device=None):
    """A context manager that records `name` over its body while a profiler
    session collects. `device`: a torch.device whose current stream also
    times the body, when it is a CUDA device (None: the host clock alone)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


def count(name, n=1):
    """Add `n` to counter `name` while a profiler session collects."""
    if not _profiler._is_profiler_enabled:
        return
    c = _REC.current().counters
    c[name] = c.get(name, 0) + n


def _seen():
    if not _profiler._is_profiler_enabled:
        _REC.live = False


def spans():
    """The spans of the last session, in the order they were opened, as
    (start_ns, end_ns, name, parent) tuples (end_ns None while open)."""
    _seen()
    return [tuple(s) for s in _REC.session.spans]


def counters():
    """The counters of the last session, by name."""
    _seen()
    return dict(_REC.session.counters)


def device_ms():
    """{span index: self time on the device, ms} of the last session's closed
    device-timed spans: the stream's time between the span's two events less
    that of the nearest device-timed spans nested in it. Waits for the
    device."""
    _seen()
    s = _REC.session
    pairs = {i: p for i, p in s.events.items() if p[1] is not None}
    if not pairs:
        return {}
    torch.cuda.synchronize()
    own = {i: a.elapsed_time(b) for i, (a, b) in pairs.items()}
    out = dict(own)
    for i in own:
        p = s.spans[i][3]
        while p is not None and p not in own:
            p = s.spans[p][3]
        if p is not None:
            out[p] -= own[i]
    return out
