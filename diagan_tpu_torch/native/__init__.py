"""The port's native host-data runtime: the alias-method weighted sampler,
the threaded uint8 gather, the prefetching loader and the normalizer
(diagan_io.cpp, built with g++ at first use)."""
from diagan_tpu_torch.native.io import NativeLoader, NativeWeightedSampler, gather_u8, normalize_u8

__all__ = ["NativeLoader", "NativeWeightedSampler", "gather_u8", "normalize_u8"]
