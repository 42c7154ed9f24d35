"""The sampler's waits for the device per proposal batch in the traced window
(its `host_sync` counter: the running max, the accepted count and the accepted
images are read back each batch)."""
from benchmark.harness import program_trace

LAYER, MOVES = "eval", "drs_accepted_per_s"


def read(facts):
    return program_trace.per(facts, "host_sync", facts["batches"])
