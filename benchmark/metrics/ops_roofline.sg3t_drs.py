"""The least time of the StyleGAN3-T DRS window's FIR and activation calls
(the reference's G and D forward at the cell's shapes: every filtered lrelu's
four FIR passes and its clamped activation, D's blurs and bias-acts) over the
device time of the port's kernels that carry them
(metrics/ops_kernels/*.json)."""
from benchmark.harness import counts, sg3_counts

LAYER, MOVES = "ops", "drs_accepted_per_s"


def read(facts):
    return counts.ops_roofline_pct(facts, sg3_counts.drs_counts(facts)[1])
