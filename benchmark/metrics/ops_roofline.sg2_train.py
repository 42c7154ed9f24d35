"""The least time of the window's FIR, bias-act and warp calls (the
reference's calls at the cell's shapes and draws) over the device time of
the port's kernels that carry them (metrics/ops_kernels/*.json)."""
from benchmark.harness import counts

LAYER, MOVES = "ops", "sg2_train_img_per_s"


def read(facts):
    return counts.ops_roofline_pct(facts, counts.sg2_calls(facts))
