"""Port package rules: no JAX, nothing of the JAX package, and no silent CPU.

diagan_tpu_torch and chip_smoke.py must import with jax unavailable and
must not import diagan_tpu; every public entry point defaults to the card
and raises when it is absent unless the caller passes device="cpu".
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from diagan_tpu_torch import resolve_device  # noqa: E402
from diagan_tpu_torch.cli import generate, train_ffhq, train_ffhq_phase2  # noqa: E402
from diagan_tpu_torch.eval.drs import DRS  # noqa: E402
from diagan_tpu_torch.eval.evaluate import Sampler  # noqa: E402
from diagan_tpu_torch.models.stylegan2 import (  # noqa: E402
    StyleGAN2Discriminator,
    StyleGAN2Generator,
)
from diagan_tpu_torch.train.stylegan2_trainer import StyleGAN2Trainer  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
_FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(jax|flax|optax|diagan_tpu)(?:\.|\s|$)",
                        re.MULTILINE)


def _port_sources():
    # build/ holds what the port generates at run time (listed in .gitignore)
    build = REPO / "diagan_tpu_torch" / "build"
    return sorted(p for p in (REPO / "diagan_tpu_torch").rglob("*.py")
                  if build not in p.parents) + [REPO / "chip_smoke.py"]


def test_port_sources_import_no_jax_and_no_jax_package():
    found = [(p.relative_to(REPO), m.group(0).strip())
             for p in _port_sources() for m in _FORBIDDEN.finditer(p.read_text())]
    assert found == []


def test_port_imports_with_jax_unavailable():
    """Every module of the port, and chip_smoke, imports in a process where
    importing jax or diagan_tpu fails."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['diagan_tpu'] = None\n"
        "import importlib, pkgutil\n"
        "import diagan_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(diagan_tpu_torch.__path__, "
        "'diagan_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "print(' '.join(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 16 and "diagan_tpu_torch.ops.ada_phase" in names


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", [
    lambda: resolve_device(),
    lambda: StyleGAN2Generator(size=16, style_dim=32, n_mlp=2, width_scale=1 / 16),
    lambda: StyleGAN2Discriminator(size=16, width_scale=1 / 16),
    lambda: DRS(lambda z: z, lambda x: x, 8, warmup_batches=0),
    lambda: Sampler(lambda z: z, 8),
    lambda: generate.main(["--size", "16", "--ckpt", "unused.pt"]),
    lambda: train_ffhq.main(["--size", "16", "--work_dir", "unused"]),
    lambda: train_ffhq_phase2.main(["--size", "16", "--work_dir", "unused",
                                    "--resample_score", "ldr"]),
    lambda: StyleGAN2Trainer("unused", None, None, None, 1),
], ids=["resolve_device", "generator", "discriminator", "drs", "sampler", "generate_cli",
        "train_ffhq_cli", "train_ffhq_phase2_cli", "trainer"])
def test_entry_points_without_device_raise_when_no_card(monkeypatch, entry):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def test_cpu_is_used_only_when_named(monkeypatch):
    _no_card(monkeypatch)
    assert resolve_device("cpu") == torch.device("cpu")
    g = StyleGAN2Generator(size=16, style_dim=32, n_mlp=2, width_scale=1 / 16, device="cpu")
    assert next(g.parameters()).device.type == "cpu"
