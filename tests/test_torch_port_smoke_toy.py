"""The 25-Gaussians two-phase protocol (diagan_tpu_torch/cli/smoke_toy.py)
against the JAX package's script (scripts/smoke_toy.py), on the CPU.

`coverage` is held to the script's own function exactly, on seeded points
and on a hand-placed set that hits some modes and misses the rest. The CLI
runs the whole protocol at a small size (200 phase-1 steps on 512 points,
batch 64): it writes both phases' files, prints the three lines in the JAX
script's format, and phase 2 trains on the weights that the JAX package's
`load_phase1_scores` makes of the logit pickle that phase 1 wrote.
"""
import functools
import importlib.util
import pickle
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diagan_tpu.cli.common import load_phase1_scores as jax_load_phase1_scores  # noqa: E402
from diagan_tpu_torch.cli import smoke_toy  # noqa: E402
from diagan_tpu_torch.data.sampler import weights_from_scores  # noqa: E402
from diagan_tpu_torch.train import trainer as TT  # noqa: E402
from diagan_tpu_torch.train.logger import Logger  # noqa: E402

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "smoke_toy.py"
STEPS, NUM_DATA, BS = 200, 512, 64
LINE = re.compile(r"^(phase1|phase2|phase2\+DRS): (\d+)/25 modes, (\d\.\d{3}) high-quality$")


@functools.cache
def jax_script():
    spec = importlib.util.spec_from_file_location("jax_smoke_toy", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def hand_placed():
    """Points (in the dataset's /2.828 space) on modes 0, 6, 12 and 24, one
    just inside and one just outside the 3-sigma radius of mode 18, and two
    between modes."""
    centre = {i: np.array([2 * (i // 5 - 2), 2 * (i % 5 - 2)], np.float64) for i in range(25)}
    pts = [centre[i] + off for i in (0, 6, 12, 24) for off in ([0, 0], [0.1, -0.1])]
    pts += [centre[18] + [0.29, 0], centre[18] + [0, -0.31], [1.0, 1.0], [-3.0, 0.0]]
    return np.asarray(pts) / 2.828


@pytest.mark.parametrize("points", ["seeded", "hand_placed"])
def test_coverage_equals_the_jax_script(points):
    if points == "seeded":
        rng = np.random.default_rng(5)
        pts = (rng.integers(-2, 3, (4000, 2)) * 2 + rng.standard_normal((4000, 2)) * 0.12) / 2.828
        pts = pts.astype(np.float32)
    else:
        pts = hand_placed()
    got, want = smoke_toy.coverage(pts), jax_script().coverage(pts)
    assert got == want and type(got[1]) is type(want[1]) is float
    if points == "hand_placed":
        assert got == (5, 9 / 12)


@pytest.fixture
def tf32_restored():
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def test_protocol_writes_both_phases_and_prints_the_jax_lines(tmp_path, monkeypatch, capsys,
                                                             tf32_restored):
    monkeypatch.setattr(TT, "Logger", functools.partial(Logger, use_tensorboard=False))
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    run = smoke_toy.main(["--device", "cpu", "--num_steps", str(STEPS), "--num_data",
                          str(NUM_DATA), "--batch_size", str(BS), "--work_dir", str(tmp_path)])
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32

    out = tmp_path / "toy25"
    n2 = STEPS + STEPS // 2
    for path in (out / f"checkpoints/netG/netG_{STEPS}_steps.pth",
                 out / f"checkpoints/netD/netD_{STEPS}_steps.pth",
                 out / f"phase2/checkpoints/netG/netG_{n2}_steps.pth",
                 out / f"phase2/checkpoints/netD/netD_{n2}_steps.pth",
                 out / f"phase2/checkpoints/netD_drs/netD_drs_{n2}_steps.pth"):
        assert path.is_file(), path
    assert not list((out / "phase2").glob("logits_*"))
    with open(out / "logits_netD_eval.pkl", "rb") as f:
        logits = pickle.load(f)
    assert list(logits) == [100, 150, 200] and all(  # 25 modes x NUM_DATA // 25 points
        v.dtype == np.float64 and v.shape == (NUM_DATA // 25 * 25,) for v in logits.values())

    lines = [m.groups() for m in map(LINE.match, capsys.readouterr().out.splitlines()) if m]
    assert [name for name, *_ in lines] == ["phase1", "phase2", "phase2+DRS"]
    for (name, modes, frac), (m, f) in zip(lines, run["coverage"].values()):
        assert (int(modes), frac) == (m, f"{f:.3f}") and 0 <= m <= 25 and 0.0 <= f <= 1.0

    want = jax_load_phase1_scores(out, STEPS, "ldrv", window=STEPS // 2)
    np.testing.assert_array_equal(run["weights"], want)
    tr1, tr2 = run["trainers"]
    assert (tr1.global_step, tr2.global_step) == (STEPS, n2)
    assert torch.equal(tr2.source.weights, weights_from_scores(want, torch.device("cpu")))
    assert 0 < run["drs"].accepted < run["drs"].proposed
