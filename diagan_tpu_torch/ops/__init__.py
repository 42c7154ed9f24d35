"""Kernels of the port: upfirdn2d (CUDA C++) and fused bias-LeakyReLU (Triton),
each with its plain-torch version, which CPU tensors take."""
from diagan_tpu_torch.ops.fused_act import fused_leaky_relu, fused_leaky_relu_plain
from diagan_tpu_torch.ops.upfirdn2d import make_resample_kernel, upfirdn2d, upfirdn2d_plain

__all__ = [
    "fused_leaky_relu",
    "fused_leaky_relu_plain",
    "make_resample_kernel",
    "upfirdn2d",
    "upfirdn2d_plain",
]
