"""The work of a StyleGAN3-T DRS window, counted from the configuration's
shapes through the benchmark's plain reference on the meta device
(reference/stylegan3.py count_forward), as harness/counts.py counts the
StyleGAN2 cells': one proposal batch's FLOPs and op calls, times the
window's batches."""
from __future__ import annotations

from benchmark.harness import counts


def drs_counts(facts):
    from benchmark.reference.stylegan3 import count_forward
    flops, calls = counts._memo(facts, "sg3_drs",
                                lambda: count_forward(facts["cfg"], facts["batch"]))
    return flops * facts["batches"], calls * facts["batches"]
