"""Device resolution for the port's public entry points.

Entry points default to the card. There is no silent CPU fallback: a run that
asked for "cuda" on a machine without a card raises, so a CPU run never
passes itself off as a card run. The CPU is used only when the caller names it.

Precision: every CLI's `main` pins IEEE fp32 (`pin_fp32_precision`), the
precision of the port's CPU parity tests and card-against-CPU bounds. PyTorch
would otherwise run cuDNN convolutions in TF32 on the card. `--bf16` is the
only fast mode.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """torch.device for `device`; raises if it names CUDA and no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU"
        )
    return dev


def pin_fp32_precision():
    """cuDNN convolutions and CUDA matmuls in IEEE fp32 (TF32 off), process-wide.

    Through the legacy `allow_tf32` flags only, as `torch.backends.cudnn.flags`
    reads them: PyTorch refuses a process that mixes them with the newer
    `fp32_precision` settings."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
