"""The device's idle time in the traced window under no program span (the
benchmark's own code between requests), as a share of the window
(harness/program_trace.py)."""
from benchmark.harness import program_trace

LAYER, MOVES = "device", "drs_accepted_per_s"


def read(facts):
    return program_trace.idle_pct(facts, lambda name: name is None)
