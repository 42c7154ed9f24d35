"""The device's idle time in the traced window under any other program span
(`drs.generate`, `drs.discriminate`, `drs.select`): the host launching, as a
share of the window (harness/program_trace.py)."""
from benchmark.harness import program_trace

LAYER, MOVES = "eval", "drs_accepted_per_s"


def read(facts):
    return program_trace.idle_pct(
        facts, lambda name: name is not None and name not in ("drs.collect", "drs.concat"))
