// ADA's affine bilinear warp and its adjoint for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas pair in diagan_tpu/ops/warp_pallas.py:
// _gather_fwd_pallas (kernel body _gather_kernel) and _scatter_grad_pallas
// (_scatter_kernel). For output pixel (i, j) of image n the source point is
//   qy = ay*i + by*j + cy,  qx = ax*i + bx*j + cx       (coef row n, that order)
// clamped to [0, S2 - 1]; the gather reads the four neighbours with bilinear
// weights, and the adjoint adds g * weight back onto the same four pixels:
//   dx2[y, x] = sum_p g[p] * hat(qy_p - y) * hat(qx_p - x).
// The TPU built both as hat-weight matmuls on the MXU because it has no
// vector gather or scatter; the GPU has both, so each is a direct kernel.
//
// Bound: bytes. The gather does ~20 flops per output per channel against 4
// loads and 1 store; the adjoint must write all of dx2 (N*C*S2*S2 floats)
// once, and its atomics land in L2.
// Design: one thread per output pixel of one image walks the C channel
// planes, so the coordinates and weights are computed once per pixel. The
// coordinates use __fmul_rn / __fadd_rn in the order of the plain version
// (ops/warp.py: affine_gather_plain), which rules out FMA contraction: the
// clamp, floor and weights then equal the plain version's bit for bit, and
// the gather is exact against it. The adjoint zeroes dx2 (cudaMemsetAsync on
// the caller's stream) and adds each of the four terms with atomicAdd,
// skipping terms whose weight is 0 (a clamped coordinate has fy or fx 0, so
// edge pixels that collect many clamped reads take half the atomics). Its
// sums are taken in a run-dependent order: it matches the plain version to
// fp32 rounding, not bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

struct Tap {
  long long o00, o01, o10, o11;  // offsets of the 4 neighbours in a plane
  float wy0, wy1, wx0, wx1;       // (1 - fy), fy, (1 - fx), fx
};

__device__ __forceinline__ Tap tap(const float* __restrict__ cf, int i, int j, int S2) {
  const float fi = (float)i, fj = (float)j, hi = (float)(S2 - 1);
  float qy = __fadd_rn(__fadd_rn(__fmul_rn(cf[0], fi), __fmul_rn(cf[1], fj)), cf[2]);
  float qx = __fadd_rn(__fadd_rn(__fmul_rn(cf[3], fi), __fmul_rn(cf[4], fj)), cf[5]);
  qy = fminf(fmaxf(qy, 0.f), hi);
  qx = fminf(fmaxf(qx, 0.f), hi);
  const float fly = floorf(qy), flx = floorf(qx);
  const int y0 = (int)fly, x0 = (int)flx;
  const int y1 = min(y0 + 1, S2 - 1), x1 = min(x0 + 1, S2 - 1);
  Tap t;
  t.o00 = (long long)y0 * S2 + x0;
  t.o01 = (long long)y0 * S2 + x1;
  t.o10 = (long long)y1 * S2 + x0;
  t.o11 = (long long)y1 * S2 + x1;
  t.wy1 = __fsub_rn(qy, fly);
  t.wx1 = __fsub_rn(qx, flx);
  t.wy0 = __fsub_rn(1.f, t.wy1);
  t.wx0 = __fsub_rn(1.f, t.wx1);
  return t;
}

// grid: (ceil(win*win / THREADS), N); x2 (N, C, S2, S2), out (N, C, win, win)
__global__ void __launch_bounds__(THREADS)
gather_kernel(const float* __restrict__ x2, const float* __restrict__ coef,
              float* __restrict__ out, int C, int S2, int win) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  const int n = blockIdx.y;
  if (p >= win * win) return;
  const Tap t = tap(coef + 6 * n, p / win, p % win, S2);
  const long long plane = (long long)S2 * S2, oplane = (long long)win * win;
  for (int c = 0; c < C; ++c) {
    const float* xp = x2 + ((long long)n * C + c) * plane;
    const float top = __fadd_rn(__fmul_rn(__ldg(xp + t.o00), t.wx0),
                                __fmul_rn(__ldg(xp + t.o01), t.wx1));
    const float bot = __fadd_rn(__fmul_rn(__ldg(xp + t.o10), t.wx0),
                                __fmul_rn(__ldg(xp + t.o11), t.wx1));
    out[((long long)n * C + c) * oplane + p] =
        __fadd_rn(__fmul_rn(top, t.wy0), __fmul_rn(bot, t.wy1));
  }
}

__device__ __forceinline__ void add(float* dst, float v) {
  if (v != 0.f) atomicAdd(dst, v);
}

// grid as gather_kernel; g (N, C, win, win), dx2 (N, C, S2, S2) zeroed first
__global__ void __launch_bounds__(THREADS)
scatter_kernel(const float* __restrict__ g, const float* __restrict__ coef,
               float* __restrict__ dx2, int C, int S2, int win) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  const int n = blockIdx.y;
  if (p >= win * win) return;
  const Tap t = tap(coef + 6 * n, p / win, p % win, S2);
  const long long plane = (long long)S2 * S2, oplane = (long long)win * win;
  for (int c = 0; c < C; ++c) {
    const float gv = __ldg(g + ((long long)n * C + c) * oplane + p);
    if (gv == 0.f) continue;
    float* dp = dx2 + ((long long)n * C + c) * plane;
    // the plain version's autograd order: (g * wy) * wx
    const float top = __fmul_rn(gv, t.wy0), bot = __fmul_rn(gv, t.wy1);
    add(dp + t.o00, __fmul_rn(top, t.wx0));
    add(dp + t.o01, __fmul_rn(top, t.wx1));
    add(dp + t.o10, __fmul_rn(bot, t.wx0));
    add(dp + t.o11, __fmul_rn(bot, t.wx1));
  }
}

dim3 grid_for(int N, int win) {
  return dim3((unsigned)(((long long)win * win + THREADS - 1) / THREADS), (unsigned)N);
}

}  // namespace

// Both entry points launch on `stream` (PyTorch's current stream), take
// contiguous fp32 buffers, and return cudaGetLastError() so the caller can
// raise on a refused launch.
extern "C" int affine_warp_gather(const float* x2, const float* coef, float* out,
                                  int N, int C, int S2, int win, void* stream) {
  if ((long long)N * C * win == 0) return (int)cudaGetLastError();
  if (N > 65535) return (int)cudaErrorInvalidValue;
  gather_kernel<<<grid_for(N, win), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x2, coef, out, C, S2, win);
  return (int)cudaGetLastError();
}

extern "C" int affine_warp_scatter(const float* g, const float* coef, float* dx2,
                                   int N, int C, int S2, int win, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = sizeof(float) * (size_t)N * C * S2 * S2;
  cudaError_t err = cudaMemsetAsync(dx2, 0, bytes, s);
  if (err != cudaSuccess) return (int)err;
  if ((long long)N * C * win == 0) return (int)cudaGetLastError();
  if (N > 65535) return (int)cudaErrorInvalidValue;
  scatter_kernel<<<grid_for(N, win), THREADS, 0, s>>>(g, coef, dx2, C, S2, win);
  return (int)cudaGetLastError();
}
