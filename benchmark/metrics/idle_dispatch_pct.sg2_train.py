"""The device's idle time in the traced window under any other program span
(the step's phases, `train.draw`, `train.tune_ada`): the host launching or
waiting, as a share of the window (harness/program_trace.py)."""
from benchmark.harness import program_trace

LAYER, MOVES = "train", "sg2_train_img_per_s"


def read(facts):
    return program_trace.idle_pct(
        facts, lambda name: name is not None and not name.startswith(("data.", "ada.")))
