"""The device's time within the twin DRS D step's span (`train.d_twin`: the
same step on uniform reals), less that of the device-timed spans nested in it,
as a share of the traced window (harness/program_trace.py)."""
from benchmark.harness import program_trace

LAYER, MOVES = "models", "sg2_train_img_per_s"


def read(facts):
    return program_trace.phase_pct(facts, ("train.d_twin",))
