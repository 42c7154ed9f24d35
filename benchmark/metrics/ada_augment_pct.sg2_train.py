"""The device's time within ADA's forward augment spans (`ada.augment`: the
warp's FIR passes and gather, the colour transform, the host's inverse and pad
choice), nested in the phases, less that of the device-timed spans nested in
it, as a share of the traced window (harness/program_trace.py)."""
from benchmark.harness import program_trace

LAYER, MOVES = "models", "sg2_train_img_per_s"


def read(facts):
    return program_trace.phase_pct(facts, ("ada.augment",))
