"""The device's time within the sampler's G spans (`drs.generate`: latents,
the mapping, the Fourier input and the modulated convolutions), less that of
the device-timed filtered-lrelu spans nested in it, as a share of the traced
window (harness/program_trace.py)."""
from benchmark.harness import program_trace

LAYER, MOVES = "eval", "drs_accepted_per_s"


def read(facts):
    return program_trace.phase_pct(facts, ("drs.generate",))
