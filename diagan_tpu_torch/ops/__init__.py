"""Kernels of the port, each with its plain-torch version, which CPU tensors
take: upfirdn2d and its backward (CUDA C++), fused bias-LeakyReLU and its
backward, its StyledConv epilogue and its clamped build (Triton), and ADA's affine warp and its adjoint on the interleaved
2x buffer and on its two y-phase planes (CUDA C++)."""
from diagan_tpu_torch.ops.ada_phase import (
    affine_gather2_plain,
    affine_gather_2phase,
    affine_scatter2,
    affine_scatter2_plain,
)
from diagan_tpu_torch.ops.fused_act import (
    clamped_leaky_relu,
    clamped_leaky_relu_plain,
    fused_leaky_relu,
    fused_leaky_relu_backward,
    fused_leaky_relu_backward_plain,
    fused_leaky_relu_plain,
    styled_leaky_relu,
    styled_leaky_relu_plain,
)
from diagan_tpu_torch.ops.upfirdn2d import make_resample_kernel, upfirdn2d, upfirdn2d_plain
from diagan_tpu_torch.ops.warp import (
    affine_gather,
    affine_gather_plain,
    affine_scatter,
    affine_scatter_plain,
)

__all__ = [
    "affine_gather",
    "affine_gather2_plain",
    "affine_gather_2phase",
    "affine_gather_plain",
    "affine_scatter",
    "affine_scatter2",
    "affine_scatter2_plain",
    "affine_scatter_plain",
    "clamped_leaky_relu",
    "clamped_leaky_relu_plain",
    "fused_leaky_relu",
    "fused_leaky_relu_backward",
    "fused_leaky_relu_backward_plain",
    "fused_leaky_relu_plain",
    "make_resample_kernel",
    "styled_leaky_relu",
    "styled_leaky_relu_plain",
    "upfirdn2d",
    "upfirdn2d_plain",
]
