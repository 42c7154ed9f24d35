"""The plain reference against the port's CPU path at tiny sizes: a whole run
of each cell, its timed path and its check, reads `correct`, with every
number far under its limit. Only these tests import both the benchmark's
reference and the port."""
import pytest

from benchmark.harness import core
from benchmark.tests.helpers import run_cell

# on the CPU both sides run plain torch in fp32: every gap is round-off
CPU_GAPS = {"loss_gap": 1e-4, "grad_gap": 1e-4, "change_gap": 2e-3, "logit_gap": 1e-4,
            "image_gap": 1e-2}


@pytest.mark.parametrize("cell", ["sg2_256.p2_train", "sg2_256.drs"])
def test_a_sound_run_is_correct(cell, tmp_path, monkeypatch):
    correct, checks, ctx = run_cell(cell, tmp_path, monkeypatch)
    assert correct, checks
    for name, value in checks.items():
        assert value <= CPU_GAPS.get(name, ctx.workload["limits"].get(name, 0.0)), (name, value)
    assert ctx.attempted > 0 and ctx.setup_s > 0
    assert ctx.e2e[ctx.workload["metric"]] > 0
    assert core.loaded_forbidden() == []


@pytest.mark.parametrize("cell,control", [("sg2_256.p2_train", "tf32"),
                                          ("sg2_256.drs", "tf32")])
def test_the_control_reads_incorrect(cell, control, tmp_path, monkeypatch):
    """The control, the reference one precision down (TF32, rounded in the
    forward's products on the CPU) put in the program's place, fails one of
    the cell's numbers at this size too, while the run itself is correct."""
    correct, _, ctx = run_cell(cell, tmp_path, monkeypatch, controls=control)
    assert correct
    limits = ctx.workload["limits"]
    read = ctx.facts["controls"][control]
    assert any(read[n] > limits[n] for n in read), (read, limits)
