"""The port's one precision and its StyleGAN2 log line, on the CPU.

Precision: `diagan_tpu_torch.device.pin_fp32_precision` turns TF32 off for
cuDNN convolutions and CUDA matmuls through the legacy `allow_tf32` flags;
`torch.backends.cudnn.flags`, which the port enters around its Inception
and LPIPS forwards, reads those flags and raises in a process that also set
the newer `fp32_precision` ones, so no source of the port sets the latter.
Every CLI module that defines or re-exports a `main` reaches the helper
before it parses its flags.

The log line: a port StyleGAN2Trainer prints its metrics in the JAX
trainer's order (its pytree's sorted keys, then ada_p), which
scripts/soak_report.py reads.
"""
import importlib
import importlib.util
import re
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from test_torch_port_package import _port_sources  # noqa: E402

import diagan_tpu_torch  # noqa: E402
from diagan_tpu_torch.data.synthetic import synthetic_natural  # noqa: E402
from diagan_tpu_torch.device import pin_fp32_precision  # noqa: E402
from diagan_tpu_torch.models.stylegan2 import (  # noqa: E402
    StyleGAN2Discriminator,
    StyleGAN2Generator,
)
from diagan_tpu_torch.train.stylegan2_trainer import StyleGAN2Trainer  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PORT = Path(diagan_tpu_torch.__file__).resolve().parent
CLI_MODULES = sorted(
    p.stem for p in (PORT / "cli").glob("*.py")
    if re.search(r"^def main\(|^from \S+ import main$", p.read_text(), re.M))
# the JAX trainer's metric keys in the order its log line prints them
JAX_LOG_KEYS = ["d", "fake_score", "g", "path", "path_length", "r1", "real_score", "ada_p"]


@pytest.fixture
def tf32_restored():
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def test_pin_fp32_precision_turns_tf32_off_and_cudnn_flags_still_enter(tf32_restored):
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    pin_fp32_precision()
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_no_port_source_sets_the_new_precision_api():
    setters = [str(p) for p in _port_sources()
               if re.search(r"fp32_precision\s*=(?!=)|set_float32_matmul_precision",
                            p.read_text())]
    assert not setters


class Reached(Exception):
    pass


def test_every_cli_is_listed():
    assert len(CLI_MODULES) >= 29 and "smoke_toy" in CLI_MODULES


@pytest.mark.parametrize("name", CLI_MODULES)
def test_cli_main_pins_fp32_first(name, monkeypatch):
    module = importlib.import_module(f"diagan_tpu_torch.cli.{name}")

    def reached():
        raise Reached

    for mod in list(sys.modules.values()):  # the helper as every CLI module bound it
        if (getattr(mod, "__name__", "").startswith("diagan_tpu_torch.cli.")
                and hasattr(mod, "pin_fp32_precision")):
            monkeypatch.setattr(mod, "pin_fp32_precision", reached)
    with pytest.raises(Reached):
        module.main([])


def test_stylegan2_log_line_is_in_the_jax_order_and_soak_report_reads_it(tmp_path, capsys,
                                                                         monkeypatch):
    torch.manual_seed(0)
    g = StyleGAN2Generator(size=16, style_dim=32, n_mlp=2, width_scale=1 / 16, device="cpu")
    d = StyleGAN2Discriminator(size=16, width_scale=1 / 16, device="cpu")
    images = synthetic_natural(8, 16, seed=3)[0]
    StyleGAN2Trainer(tmp_path / "run", g, d, images, num_steps=2, batch_size=4, log_every=1,
                     device="cpu").train()
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step ")]
    assert [ln.split(":")[0] for ln in lines] == ["step 1", "step 2"]
    for ln in lines:
        keys = [part.split(":")[0] for part in ln.split(": ", 1)[1].split("; ")]
        assert keys == JAX_LOG_KEYS, ln

    log = tmp_path / "train.log"
    log.write_text("\n".join(lines) + "\n")
    spec = importlib.util.spec_from_file_location("soak_report", ROOT / "scripts" /
                                                  "soak_report.py")
    soak_report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(soak_report)
    monkeypatch.setattr(sys, "argv", ["soak_report.py", str(tmp_path / "run"), str(log)])
    soak_report.main()
    out = capsys.readouterr().out
    assert "log rows: 2;" in out
    rows = re.findall(r"step +(\d+): ada_p=([\d.]+) r1=([\d.-]+) path=([\d.-]+)", out)
    want = [re.search(r"step (\d+):.*; path: ([\d.-]+);.*; r1: ([\d.-]+);.*ada_p: ([\d.]+)", ln)
            .groups() for ln in lines]
    assert {(s, p, r1, path) for s, path, r1, p in want} == set(rows)
