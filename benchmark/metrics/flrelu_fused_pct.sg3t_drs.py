"""The share of G's filtered-lrelu calls in the traced window whose activation
ran as one clamped bias-act pass (the program's `filtered_lrelu_fused`
counter over its `filtered_lrelu`: every G forward with autograd off takes
it); None when the program counted none."""
from benchmark.harness import program_trace

LAYER, MOVES = "models", "drs_accepted_per_s"


def read(facts):
    n = program_trace.per(facts, "filtered_lrelu", 1)
    return 100.0 * program_trace.per(facts, "filtered_lrelu_fused", n) if n else None
