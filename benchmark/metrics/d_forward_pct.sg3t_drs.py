"""The device's time within the sampler's D spans (`drs.discriminate`: the twin
D's logits of a proposal batch), less that of the device-timed spans nested in
it, as a share of the traced window (harness/program_trace.py)."""
from benchmark.harness import program_trace

LAYER, MOVES = "eval", "drs_accepted_per_s"


def read(facts):
    return program_trace.phase_pct(facts, ("drs.discriminate",))
