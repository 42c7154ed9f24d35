"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and compiles on its own
into `build/<name>-<hash>.so` (the build directory lies in the package and is
listed in .gitignore). The hash covers the source and the nvcc flags, so an
edited source is rebuilt and an unchanged one is loaded as it is. Nothing is
built at import: the first launch builds, and `build_all` builds every source
at once, one nvcc process per source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}

# Launch counts, one plain integer per kernel. Each wrapper adds one where it
# launches its kernel and nowhere else; a run zeroes them before the path it
# drives and reads them after, to show that the path went through the kernels.
# fused_leaky_relu_backward launches flr_bwd, and with it flr_db (the
# per-channel bias gradient) unless the caller skips the sums, as the double
# backward does: fused_leaky_relu_db counts those flr_db launches.
# styled_leaky_relu counts flr_fwd's launches with G's StyledConv epilogue
# folded in (its STYLED build); clamped_leaky_relu those of its CLAMP build
# (StyleGAN3's activation); fused_leaky_relu the plain bias-act's.
LAUNCHES = {"upfirdn2d": 0, "upfirdn2d_backward": 0, "fused_leaky_relu": 0,
            "styled_leaky_relu": 0, "clamped_leaky_relu": 0, "fused_leaky_relu_backward": 0, "fused_leaky_relu_db": 0,
            "affine_warp_gather": 0, "affine_warp_scatter": 0, "affine_warp2_gather": 0,
            "affine_warp2_scatter": 0}
# Launches of upfirdn2d (forward and backward together) by kernel instance;
# ops/upfirdn2d.py enters its FIR_INSTANCES names when it is imported.
FIR_INSTANCES: dict[str, int] = {}
# The launches among those on bfloat16 tensors: by kernel (LAUNCHES' names)
# and by kernel A instance ("upfirdn2d/<instance>"); absent means none.
BF16_LAUNCHES: dict[str, int] = {}


def count_bf16(name: str):
    BF16_LAUNCHES[name] = BF16_LAUNCHES.get(name, 0) + 1


def reset_launches():
    for counts in (LAUNCHES, FIR_INSTANCES):
        for name in counts:
            counts[name] = 0
    BF16_LAUNCHES.clear()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels are built on the machine that holds the card")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start nvcc for `name` unless its library is current; None if it is."""
    target = _target(name)
    if target.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, Path(tmp), target


def _finish(name: str, job) -> str:
    """Wait for one nvcc job; move its library into place; return its log."""
    if job is None:
        return ""
    proc, tmp, target = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    return log


def build_all() -> dict[str, str]:
    """Build every csrc/*.cu in parallel; return each source's nvcc log
    (the -Xptxas -v register and spill report), empty when it was current."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    jobs = {name: _start(name) for name in names}
    return {name: _finish(name, job) for name, job in jobs.items()}


def load(name: str) -> ctypes.CDLL:
    """The ctypes library for csrc/<name>.cu, building it on first use."""
    lib = _loaded.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib
