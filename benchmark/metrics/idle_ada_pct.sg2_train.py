"""The device's idle time in the traced window under ADA's spans (`ada.draw`:
the host's draws; `ada.augment`), as a share of the window
(harness/program_trace.py)."""
from benchmark.harness import program_trace

LAYER, MOVES = "models", "sg2_train_img_per_s"


def read(facts):
    return program_trace.idle_pct(
        facts, lambda name: name is not None and name.startswith("ada."))
