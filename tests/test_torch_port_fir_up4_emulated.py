"""Kernel A's up-4 pair (csrc/upfirdn2d.cu fir_up4x_kernel, fir_up4y_kernel)
run on the CPU: the CUDA source is compiled by the host's C++ compiler
against stub CUDA headers, each launch rewritten into a loop that calls the
kernel once per (block, thread). The pair uses no shared memory, barrier
or shuffle, so one thread after another computes what the card computes.
Held against upfirdn2d_plain on the 24-tap up-4 passes at crops and pads
of every phase mod 4, odd widths (a lane of the y pass left with one
column), and input and output pointers off their 16- and 8-byte alignment
(the x pass's narrower stores); the output buffer starts as NaN with a NaN
guard past its end, so an output left unwritten or a write past the end
shows. The entry point refuses the pair on bfloat16.
"""
import ctypes
import itertools
import re
import shutil
import subprocess
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from diagan_tpu_torch.ops.upfirdn2d import (  # noqa: E402
    FIR_INSTANCES,
    _out_size,
    fir_instance,
    upfirdn2d_plain,
)

CSRC = Path(__file__).resolve().parents[1] / "diagan_tpu_torch" / "csrc" / "upfirdn2d.cu"

STUB_RUNTIME = r"""
#pragma once
#include <cstdint>
#include <cstring>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline dim3 threadIdx, blockIdx, blockDim, gridDim;
typedef void* cudaStream_t;
typedef int cudaError_t;
constexpr int cudaSuccess = 0, cudaErrorInvalidValue = 1;
inline cudaError_t cudaGetLastError() { return 0; }
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint4 { unsigned x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline void __syncthreads() {}
inline void __syncwarp() {}
inline unsigned __shfl_down_sync(unsigned, unsigned v, int) { return v; }
inline bool __any_sync(unsigned, bool v) { return v; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
inline unsigned __byte_perm(unsigned, unsigned, unsigned) { return 0; }
struct Cfg { dim3 g, b; };
template <class F, class... A> void emu(F f, Cfg c, A... a) {
  gridDim = c.g;
  blockDim = c.b;
  for (unsigned bz = 0; bz < c.g.z; ++bz)
    for (unsigned by = 0; by < c.g.y; ++by)
      for (unsigned bx = 0; bx < c.g.x; ++bx) {
        blockIdx = dim3(bx, by, bz);
        for (unsigned tz = 0; tz < c.b.z; ++tz)
          for (unsigned ty = 0; ty < c.b.y; ++ty)
            for (unsigned tx = 0; tx < c.b.x; ++tx) {
              threadIdx = dim3(tx, ty, tz);
              f(a...);
            }
      }
}
#define EMUCFG(g, b, ...) Cfg{dim3(g), dim3(b)}
"""

STUB_BF16 = r"""
#pragma once
#include "cuda_runtime.h"
struct __nv_bfloat16 { uint16_t v; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat16 __float2bfloat16(float f) { return {(uint16_t)(__float_as_uint(f) >> 16)}; }
inline float __bfloat162float(__nv_bfloat16 b) { return __uint_as_float((unsigned)b.v << 16); }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}
"""


@pytest.fixture(scope="module")
def forward(tmp_path_factory):
    """upfirdn2d_forward of the source built for the host, serial launches."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulated kernels")
    d = tmp_path_factory.mktemp("fir_up4_emu")
    (d / "cuda_runtime.h").write_text(STUB_RUNTIME)
    (d / "cuda_bf16.h").write_text(STUB_BF16)
    src = CSRC.read_text().replace("extern __shared__ float tile[];",
                                   "static float tile[1 << 16];")
    src = re.sub(r"([A-Za-z_]\w*(?:<[^<>;]*>)?)<<<(.*?)>>>\(", r"emu(\1, EMUCFG(\2), ", src,
                 flags=re.S)
    (d / "upfirdn2d_emu.cpp").write_text('#include "cuda_runtime.h"\n' + src)
    subprocess.run([cxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-I", str(d), "-o",
                    str(d / "upfirdn2d_emu.so"), str(d / "upfirdn2d_emu.cpp")], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(str(d / "upfirdn2d_emu.so")).upfirdn2d_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 8
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    return fn


def run(fn, x, taps, up, pad, instance, y_off=0, dtype=0):
    """The kernel's output, written into a NaN buffer `y_off` elements past
    its start with a NaN guard after it; (error code, output, guard)."""
    n, c, h, w = x.shape
    kh, kw = taps.shape
    px0, px1, py0, py1 = pad
    oh, ow = _out_size(h, up[1], py0, py1, kh, 1), _out_size(w, up[0], px0, px1, kw, 1)
    buf = torch.full((y_off + n * c * oh * ow + 4,), float("nan"))
    y = buf[y_off:y_off + n * c * oh * ow].view(n, c, oh, ow)
    err = fn(x.data_ptr(), y.data_ptr(), taps.data_ptr(), dtype, FIR_INSTANCES.index(instance),
             n, c, h, w, oh, ow, *x.stride(), *y.stride(), kh, kw, *up, 1, 1, px0, py0, None)
    return err, y, buf[y_off + y.numel():]


_K24 = torch.randn(24, generator=torch.Generator().manual_seed(24))
_SHAPES = [(38, 38), (7, 13), (5, 30)]
_PADS = [(-6, -9), (-7, -8), (-5, 3), (0, 0), (9, 8), (-1, -2)]


@pytest.mark.parametrize("axis,shape", list(itertools.product("xy", _SHAPES)))
def test_up4_pair_matches_plain(forward, axis, shape):
    taps = (_K24.reshape(1, 24) if axis == "x" else _K24.reshape(24, 1)).contiguous()
    up = (4, 1) if axis == "x" else (1, 4)
    instance = fir_instance(*taps.shape, up, 1, torch.float32, torch.contiguous_format)
    assert instance == ("fir24x_up4" if axis == "x" else "fir24y_up4")
    g = torch.Generator().manual_seed(sum(shape))
    h, w = shape
    ran = 0
    for (p0, p1), other, x_off, y_off in itertools.product(
            _PADS, [(0, 0), (2, -1), (1, 3), (2, 0), (-2, 4)], [0, 1], [0, 1, 2]):
        pad = (p0, p1, *other) if axis == "x" else (*other, p0, p1)
        if _out_size(h if axis == "y" else w, 4, p0, p1, 24, 1) <= 0 or \
                _out_size(w if axis == "y" else h, 1, *other, 1, 1) <= 0:
            continue
        xb = torch.randn(x_off + 2 * 3 * h * w, generator=g)
        x = xb[x_off:].view(2, 3, h, w)
        want = upfirdn2d_plain(x, taps, up, 1, pad)
        err, y, guard = run(forward, x, taps, up, pad, instance, y_off)
        assert err == 0
        assert torch.isnan(guard).all(), (pad, x_off, y_off)
        assert not torch.isnan(y).any(), (pad, x_off, y_off)
        torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-6 * want.abs().max().item())
        ran += 1
    assert ran >= 12


@pytest.mark.parametrize("instance", ["fir24x_up4", "fir24y_up4"])
def test_up4_pair_refuses_bfloat16_and_other_families(forward, instance):
    x = torch.zeros(1, 1, 32, 32)
    taps = torch.ones((1, 24) if instance == "fir24x_up4" else (24, 1))
    up = (4, 1) if instance == "fir24x_up4" else (1, 4)
    pad = (0, 0, 0, 0)
    assert run(forward, x, taps, up, pad, instance)[0] == 0
    assert run(forward, x, taps, up, pad, instance, dtype=1)[0] == -1  # bfloat16
    assert run(forward, x, taps, up[::-1], pad, instance)[0] == -1  # the other axis' factor
    assert run(forward, x, taps.T.contiguous(), up, pad, instance)[0] == -1  # the other axis
