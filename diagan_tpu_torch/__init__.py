"""PyTorch + CUDA port of diagan_tpu for NVIDIA Hopper (H100).

The layout mirrors the JAX package (ops/, models/, eval/, train/, utils/,
cli/) so each counterpart is easy to find. This package imports torch and
never jax, and nothing of diagan_tpu: the JAX package is the reference the
tests hold it against.

Public entry points take `device=` and default to "cuda"; they raise when no
card is present unless the caller asks for device="cpu" (see device.py).
"""
from diagan_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
