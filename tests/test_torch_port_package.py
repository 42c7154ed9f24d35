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

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diagan_tpu_torch import resolve_device  # noqa: E402
from diagan_tpu_torch.cli import (  # noqa: E402
    bench,
    count_attr_celeba,
    eval_gan,
    eval_gan_celeba_with_attr,
    eval_gan_drs,
    eval_gan_drs_celeba_with_attr,
    eval_gan_drs_with_index,
    eval_gan_with_index,
    generate,
    train_convnet_celeba,
    train_ffhq,
    train_ffhq_phase2,
    train_mimicry_phase1,
    train_mimicry_phase2,
)
from diagan_tpu_torch.data.arrays import ArrayDataset  # noqa: E402
from diagan_tpu_torch.data.pipeline import DeviceDataSource  # noqa: E402
from diagan_tpu_torch.eval.drs import DRS  # noqa: E402
from diagan_tpu_torch.eval.evaluate import Sampler, evaluate_checkpoint  # noqa: E402
from diagan_tpu_torch.eval.inception import InceptionFeaturizer  # noqa: E402
from diagan_tpu_torch.models.convnets import (  # noqa: E402
    AttrClassifier,
    Simple3DNet,
    SimpleConvNet,
    SimpleNet,
)
from diagan_tpu_torch.models.registry import get_gan_model  # noqa: E402
from diagan_tpu_torch.models.sngan import SNGANDiscriminator32, SNGANGenerator32  # noqa: E402
from diagan_tpu_torch.models.stylegan2 import (  # noqa: E402
    StyleGAN2Discriminator,
    StyleGAN2Generator,
)
from diagan_tpu_torch.train.stylegan2_trainer import StyleGAN2Trainer  # noqa: E402
from diagan_tpu_torch.train.trainer import LogTrainer  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
_FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(jax|flax|optax|msgpack|diagan_tpu)(?:\.|\s|$)",
                        re.MULTILINE)
# the card's machine has no matplotlib, Pillow or TensorBoard: the port may
# import them only inside the functions that need them
_MODULE_LEVEL_OPTIONAL = re.compile(
    r"^(?:import|from)\s+(matplotlib|PIL|tensorboard|torch\.utils\.tensorboard)(?:\.|\s|$)",
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


def test_port_sources_import_no_optional_package_at_module_level():
    found = [(p.relative_to(REPO), m.group(0).strip())
             for p in _port_sources() for m in _MODULE_LEVEL_OPTIONAL.finditer(p.read_text())]
    assert found == []


def test_port_imports_with_jax_unavailable():
    """Every module of the port, and chip_smoke, imports in a process where
    importing jax or diagan_tpu fails."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['diagan_tpu'] = None\n"
        "sys.modules['optax'] = None\n"
        "sys.modules['msgpack'] = None\n"
        "sys.modules['pandas'] = None\n"
        "sys.modules['matplotlib'] = None\n"
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
    assert len(names) >= 30 and "diagan_tpu_torch.ops.ada_phase" in names
    assert {"diagan_tpu_torch.cli.train_mimicry_phase1", "diagan_tpu_torch.train.trainer",
            "diagan_tpu_torch.data.pipeline", "diagan_tpu_torch.utils.plot",
            "diagan_tpu_torch.eval.inception", "diagan_tpu_torch.eval.metrics",
            "diagan_tpu_torch.cli.eval_gan_drs", "diagan_tpu_torch.data.transform",
            "diagan_tpu_torch.models.convnets", "diagan_tpu_torch.train.classifier",
            "diagan_tpu_torch.cli.train_convnet_celeba", "diagan_tpu_torch.cli.count_attr_celeba",
            "diagan_tpu_torch.cli.disc_score_celeba_with_attr",
            "diagan_tpu_torch.cli.eval_gan_celeba_with_attr",
            "diagan_tpu_torch.cli.eval_gan_drs_celeba_with_attr",
            "diagan_tpu_torch.cli.bench"} <= set(names)


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
    lambda: train_mimicry_phase1.main(["--work_dir", "unused"]),
    lambda: train_mimicry_phase2.main(["--work_dir", "unused", "--resample_score", "ldr"]),
    lambda: LogTrainer("unused", None, None, 1),
    lambda: DeviceDataSource(ArrayDataset.from_images(np.zeros((2, 4, 4, 3), np.uint8))),
    lambda: get_gan_model("cifar10"),
    lambda: SNGANGenerator32(ngf=8),
    lambda: SNGANDiscriminator32(ndf=8),
    lambda: get_gan_model("ffhq"),
    lambda: InceptionFeaturizer(),
    lambda: evaluate_checkpoint("fid", None, "unused", 1),
    lambda: eval_gan.main(["--netG_ckpt_step", "1", "--work_dir", "unused"]),
    lambda: eval_gan_drs.main(["--netG_ckpt_step", "1", "--work_dir", "unused"]),
    lambda: eval_gan_with_index.main(["--netG_ckpt_step", "1", "--work_dir", "unused"]),
    lambda: eval_gan_drs_with_index.main(["--netG_ckpt_step", "1", "--work_dir", "unused"]),
    lambda: SimpleConvNet(),
    lambda: Simple3DNet(),
    lambda: SimpleNet(12),
    lambda: AttrClassifier(),
    lambda: train_convnet_celeba.main(["--work_dir", "unused"]),
    lambda: count_attr_celeba.main(["--netG_ckpt_step", "1", "--work_dir", "unused"]),
    lambda: eval_gan_celeba_with_attr.main(["--netG_ckpt_step", "1", "--work_dir", "unused"]),
    lambda: eval_gan_drs_celeba_with_attr.main(["--netG_ckpt_step", "1",
                                                "--work_dir", "unused"]),
    lambda: bench.main([]),
], ids=["resolve_device", "generator", "discriminator", "drs", "sampler", "generate_cli",
        "train_ffhq_cli", "train_ffhq_phase2_cli", "trainer", "mimicry_phase1_cli",
        "mimicry_phase2_cli", "log_trainer", "device_data_source", "get_gan_model",
        "sngan_generator", "sngan_discriminator", "ffhq_bundle", "inception_featurizer",
        "evaluate_checkpoint", "eval_gan_cli", "eval_gan_drs_cli", "eval_gan_with_index_cli",
        "eval_gan_drs_with_index_cli", "simple_convnet", "simple3dnet", "simple_net",
        "attr_classifier", "train_convnet_celeba_cli", "count_attr_celeba_cli",
        "eval_gan_celeba_with_attr_cli", "eval_gan_drs_celeba_with_attr_cli", "bench_cli"])
def test_entry_points_without_device_raise_when_no_card(monkeypatch, entry):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def test_cpu_is_used_only_when_named(monkeypatch):
    _no_card(monkeypatch)
    assert resolve_device("cpu") == torch.device("cpu")
    g = StyleGAN2Generator(size=16, style_dim=32, n_mlp=2, width_scale=1 / 16, device="cpu")
    assert next(g.parameters()).device.type == "cpu"
    bundle = get_gan_model("cifar10", drs=True, device="cpu")
    assert all(next(m.parameters()).device.type == "cpu"
               for m in (bundle.gen, bundle.disc, bundle.disc_drs))
