"""The program's own spans and counters (`diagan_tpu_torch/utils/trace.py`),
recorded while the traced window's profiler collected, laid over the
window's device operations (`facts["trace"]`, harness/trace.py).

  phase_pct(facts, names)   the device self time of the program's spans
        named `names` (the stream's time between each span's two events, busy
        or starved, less that of the device-timed spans nested in it), as a
        share of the window (`facts["window_s"]`);
  idle_pct(facts, under)    the device's idle time put down to the innermost
        program span over it, summed over the spans whose name `under`
        accepts (`under(None)`: idle under no program span), as a share of
        the window;
  per(facts, counter, n)    a program counter over n.

The window on the epoch clock is the extent of the benchmark's own spans;
its idle time is that window less the union of the device operations. Each
idle nanosecond goes to the innermost program span that covers it: a gap
that crosses a span boundary is split there, exactly. Every reader returns
None, and raises nothing, when the program has no trace module or recorded
nothing (a program from before the module).
"""
from __future__ import annotations


def _recorded(facts):
    """(spans, counters, {span index: device self ms}) of the program's last
    session, or None; read once per run and kept in `facts`."""
    if "program_trace" not in facts:
        got = None
        try:
            from diagan_tpu_torch.utils import trace
        except ImportError:
            trace = None
        if trace is not None and "trace" in facts:
            spans = trace.spans()
            if spans:
                got = (spans, trace.counters(), trace.device_ms())
        facts["program_trace"] = got
    return facts["program_trace"]


def gaps(kernels, w0, w1):
    """The idle intervals of [w0, w1] outside the union of `kernels`
    ((start, end, name), sorted by start)."""
    t = w0
    for s, e, _ in kernels:
        if e <= t:
            continue
        if s >= w1:
            break
        if s > t:
            yield t, s
        t = e
    if t < w1:
        yield t, w1


def segments(spans, w0, w1):
    """[w0, w1] cut at the spans' starts and ends into (a, b, name of the
    innermost span over it, or None); spans are (start, end, name, parent),
    parent an index or None, and open ones (end None) are left out."""
    depth = []
    for s in spans:
        depth.append(0 if s[3] is None else depth[s[3]] + 1)
    events = sorted([(s[0], 1, i) for i, s in enumerate(spans) if s[1] is not None]
                    + [(s[1], 0, i) for i, s in enumerate(spans) if s[1] is not None])
    active, t0 = set(), w0

    def inner():
        if not active:
            return None
        return spans[max(active, key=lambda i: (depth[i], spans[i][0], i))][2]

    out = []
    for t, opens, i in events:
        if t > t0:
            a, b = t0, min(t, w1)
            if a < b:
                out.append((a, b, inner()))
            t0 = max(t0, t)
        if opens:
            active.add(i)
        else:
            active.discard(i)
    if t0 < w1:
        out.append((t0, w1, inner()))
    return out


def idle_by_span(kernels, bench_spans, spans):
    """{innermost program span's name, or None: idle ns} over the extent of
    the benchmark's spans ((start, end, name))."""
    w0, w1 = min(s[0] for s in bench_spans), max(s[1] for s in bench_spans)
    out = {}
    segs = segments(spans, w0, w1)
    k = 0
    for a, b in gaps(kernels, w0, w1):
        while k < len(segs) and segs[k][1] <= a:
            k += 1
        j = k
        while j < len(segs) and segs[j][0] < b:
            lo, hi = max(a, segs[j][0]), min(b, segs[j][1])
            if lo < hi:
                out[segs[j][2]] = out.get(segs[j][2], 0) + hi - lo
            j += 1
    return out


def _idle(facts):
    if "program_idle_ns" not in facts:
        got = _recorded(facts)
        tr = facts.get("trace")
        facts["program_idle_ns"] = (idle_by_span(tr.kernels, tr.spans, got[0])
                                    if got and tr is not None and tr.spans else None)
    return facts["program_idle_ns"]


def idle_pct(facts, under):
    idle = _idle(facts)
    if idle is None:
        return None
    return 100.0 * sum(ns for name, ns in idle.items() if under(name)) / (facts["window_s"] * 1e9)


def phase_pct(facts, names):
    got = _recorded(facts)
    if got is None:
        return None
    spans, _, self_ms = got
    ms = sum(t for i, t in self_ms.items() if spans[i][2] in names)
    return 100.0 * ms / (facts["window_s"] * 1e3)


def per(facts, counter, n):
    got = _recorded(facts)
    if got is None or not n:
        return None
    return got[1].get(counter, 0) / n
