"""The StyleGAN3-T DRS window's G and D forward FLOPs (the reference's count
of one proposal batch, times the batches) over the window's time and the
fp32 peak."""
from benchmark.harness import counts, sg3_counts

LAYER, MOVES = "eval", "drs_accepted_per_s"


def read(facts):
    return counts.mfu_pct(facts, sg3_counts.drs_counts(facts)[0])
