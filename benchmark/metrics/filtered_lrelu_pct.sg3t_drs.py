"""The device's time within G's filtered-lrelu spans (`g.filtered_lrelu`: the
up passes, the clamped activation and the down passes of each layer), as a
share of the traced window (harness/program_trace.py)."""
from benchmark.harness import program_trace

LAYER, MOVES = "models", "drs_accepted_per_s"


def read(facts):
    return program_trace.phase_pct(facts, ("g.filtered_lrelu",))
