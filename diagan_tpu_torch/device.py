"""Device resolution for the port's public entry points.

Entry points default to the card. There is no silent CPU fallback: a run that
asked for "cuda" on a machine without a card raises, so a CPU run never
passes itself off as a card run. The CPU is used only when the caller names it.
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
