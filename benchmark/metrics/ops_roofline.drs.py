"""The least time of the window's FIR and bias-act calls (the reference's
G and D forward at the cell's shapes) over the device time of the port's
kernels that carry them (metrics/ops_kernels/*.json)."""
from benchmark.harness import counts

LAYER, MOVES = "ops", "drs_accepted_per_s"


def read(facts):
    return counts.ops_roofline_pct(facts, counts.drs_counts(facts)[1])
