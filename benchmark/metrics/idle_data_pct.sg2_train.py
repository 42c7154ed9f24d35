"""The device's idle time in the traced window under the data spans
(`data.draw`, `data.gather`, `data.staging_wait`: indices, host gather, pinned
slot wait, copy), as a share of the window (harness/program_trace.py)."""
from benchmark.harness import program_trace

LAYER, MOVES = "data", "sg2_train_img_per_s"


def read(facts):
    return program_trace.idle_pct(
        facts, lambda name: name is not None and name.startswith("data."))
