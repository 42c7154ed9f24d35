"""The program's waits for the device per training step in the traced window
(its `host_sync` counter: ADA's tune reads sign(D(real)) once a step)."""
from benchmark.harness import program_trace

LAYER, MOVES = "train", "sg2_train_img_per_s"


def read(facts):
    return program_trace.per(facts, "host_sync", len(facts["kinds"]))
