"""The share of G's StyledConv epilogues in the traced window that ran as one
fused bias-act pass (the program's `styled_act_fused` counter over its
`styled_act`: every G forward with autograd off takes it); None when the
program counted none."""
from benchmark.harness import program_trace

LAYER, MOVES = "models", "drs_accepted_per_s"


def read(facts):
    n = program_trace.per(facts, "styled_act", 1)
    return 100.0 * program_trace.per(facts, "styled_act_fused", n) if n else None
