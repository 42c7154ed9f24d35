"""The share of kernel A's 24-tap up-4 calls in the traced window (24 taps
and up 4 along one axis: StyleGAN3-T's x and y up passes at L3, L5, L7 and
L10) that ran on its up-4 instances (the program's `fir_up4_family` counter
over its `fir_up4_calls`); None when the program counted none, as a program
without the counters does."""
from benchmark.harness import program_trace

LAYER, MOVES = "ops", "drs_accepted_per_s"


def read(facts):
    n = program_trace.per(facts, "fir_up4_calls", 1)
    return 100.0 * program_trace.per(facts, "fir_up4_family", n) if n else None
