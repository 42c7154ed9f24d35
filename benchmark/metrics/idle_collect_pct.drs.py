"""The device's idle time in the traced window under the sampler's host reads
(`drs.collect`) and the request's concatenate (`drs.concat`), as a share of the
window (harness/program_trace.py)."""
from benchmark.harness import program_trace

LAYER, MOVES = "eval", "drs_accepted_per_s"


def read(facts):
    return program_trace.idle_pct(
        facts, lambda name: name in ("drs.collect", "drs.concat"))
