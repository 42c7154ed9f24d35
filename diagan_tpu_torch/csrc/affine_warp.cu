// ADA's affine bilinear warp and its adjoint for Hopper (sm_90a), in two
// source layouts: one interleaved 2x buffer, or its two y-phase planes.
//
// Replaces the JAX package's Pallas kernels
//   diagan_tpu/ops/warp_pallas.py: _gather_fwd_pallas (kernel body
//     _gather_kernel) and _scatter_grad_pallas (_scatter_kernel), the
//     interleaved pair: gather_kernel and scatter_kernel below;
//   diagan_tpu/ops/ada_phase.py: _gather2_pallas (_gather2_kernel) and
//     _scatter2_pallas (_scatter2_kernel), the two-phase pair of the
//     polyphase resample: gather2_kernel and scatter2_kernel below.
// For output pixel (i, j) of image n the source point is
//   qy = ay*i + by*j + cy,  qx = ax*i + bx*j + cx       (coef row n, that order)
// clamped to [0, S2 - 1]; the gather reads the four neighbours with bilinear
// weights, and the adjoint adds g * weight back onto the same four pixels:
//   dx2[y, x] = sum_p g[p] * hat(qy_p - y) * hat(qx_p - x).
// The two-phase layout holds row y of the S2 x S2 buffer as row y >> 1 of
// plane y & 1 (v_phi[m, x] = x2[2m + phi, x], each plane S2/2 x S2), and
// emits the output split by parity into four quarter grids
// Y_ab[uy, ux] = out[2uy + a, 2ux + b], the layout the polyphase downsample
// reads. The TPU built all four as hat-weight matmuls over DMA windows
// because it has no vector gather or scatter; its two-phase windows also
// rounded their origins onto the phase grid, which truncates reads beyond
// about 2.5x scale at 45 degrees. The GPU has both gather and scatter, so
// each is a direct kernel, exact bilinear with no window.
//
// Bound: bytes. The gathers do ~20 flops per output per channel against 4
// loads and 1 store; the adjoints must write all of dx2 (or both planes,
// N*C*S2*S2 floats in all) once, and their atomics land in L2.
// Design: one thread per output pixel of one image walks the C channel
// planes, so the coordinates and weights are computed once per pixel. The
// two-phase gather numbers its threads by output row and column, as the
// interleaved gather does, so a warp's 32 lanes take 32 neighbouring output
// columns and read source columns as locally as that gather's warps; within
// each run of 32 columns the lanes are ordered parity first (lanes 0-15 the
// even columns, 16-31 the odd ones), so each half-warp stores 16
// neighbouring words of one quarter grid. The two-phase adjoint enumerates
// the pixels quarter-grid-major (a, b, uy, ux). All four share
// tap(), whose coordinates use __fmul_rn / __fadd_rn in the order of the
// plain versions (ops/warp.py: affine_gather_plain, ops/ada_phase.py:
// affine_gather2_plain), which rules out FMA contraction: the clamp, floor
// and weights then equal the plain versions' bit for bit, and the gathers
// are exact against them. The adjoints zero their output
// (cudaMemsetAsync on the caller's stream) and add each of the four terms
// with atomicAdd, skipping terms whose weight is 0 (a clamped coordinate has
// fy or fx 0, so edge pixels that collect many clamped reads take half the
// atomics). Their sums are taken in a run-dependent order: they match the
// plain versions to fp32 rounding, not bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

struct Tap {
  int y0, y1, x0, x1;        // rows and columns of the 4 neighbours
  float wy0, wy1, wx0, wx1;  // (1 - fy), fy, (1 - fx), fx
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
  t.y0 = y0; t.y1 = y1; t.x0 = x0; t.x1 = x1;
  t.wy1 = __fsub_rn(qy, fly);
  t.wx1 = __fsub_rn(qx, flx);
  t.wy0 = __fsub_rn(1.f, t.wy1);
  t.wx0 = __fsub_rn(1.f, t.wx1);
  return t;
}

// The bilinear blend of the four neighbours, rows `top` and `bot` (pointers
// to the start of rows y0 and y1), in the plain version's order.
__device__ __forceinline__ float blend(const float* top, const float* bot, const Tap& t) {
  const float a = __fadd_rn(__fmul_rn(__ldg(top + t.x0), t.wx0),
                            __fmul_rn(__ldg(top + t.x1), t.wx1));
  const float b = __fadd_rn(__fmul_rn(__ldg(bot + t.x0), t.wx0),
                            __fmul_rn(__ldg(bot + t.x1), t.wx1));
  return __fadd_rn(__fmul_rn(a, t.wy0), __fmul_rn(b, t.wy1));
}

__device__ __forceinline__ void add(float* dst, float v) {
  if (v != 0.f) atomicAdd(dst, v);
}

// The adjoint of blend: g's four weighted terms added onto rows `top` and
// `bot`, in the plain version's autograd order, (g * wy) * wx.
__device__ __forceinline__ void spread(float* top, float* bot, const Tap& t, float gv) {
  const float a = __fmul_rn(gv, t.wy0), b = __fmul_rn(gv, t.wy1);
  add(top + t.x0, __fmul_rn(a, t.wx0));
  add(top + t.x1, __fmul_rn(a, t.wx1));
  add(bot + t.x0, __fmul_rn(b, t.wx0));
  add(bot + t.x1, __fmul_rn(b, t.wx1));
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
  const long long r0 = (long long)t.y0 * S2, r1 = (long long)t.y1 * S2;
  for (int c = 0; c < C; ++c) {
    const float* xp = x2 + ((long long)n * C + c) * plane;
    out[((long long)n * C + c) * oplane + p] = blend(xp + r0, xp + r1, t);
  }
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
    spread(dp + (long long)t.y0 * S2, dp + (long long)t.y1 * S2, t, gv);
  }
}

// Row y of the S2 x S2 buffer in the two-phase layout: row y >> 1 of plane
// y & 1, planes (S2 / 2) x S2. `base` is the (n, c) offset of both planes.
template <typename T>
__device__ __forceinline__ T* phase_row(T* v0, T* v1, long long base, int y, int S2) {
  return (y & 1 ? v1 : v0) + base + (long long)(y >> 1) * S2;
}

// grid: (ceil(win * win / THREADS), N), h2 = win / 2; v0, v1 (N, C, S2/2,
// S2); out (4, N, C, h2, h2), quarter grid a * 2 + b first.
__global__ void __launch_bounds__(THREADS)
gather2_kernel(const float* __restrict__ v0, const float* __restrict__ v1,
               const float* __restrict__ coef, float* __restrict__ out,
               int N, int C, int S2, int win) {
  const int h2 = win / 2, qplane = h2 * h2;
  const int p = blockIdx.x * THREADS + threadIdx.x;
  const int n = blockIdx.y;
  if (p >= win * win) return;
  // output row i; lane l of the run of `wc` columns from c0 takes parity
  // b = (l >= wc / 2) and column j = 2 * ux + b (wc and win are even)
  const int i = p / win, c0 = (p % win) & ~31, l = p % win - c0;
  const int half = min(32, win - c0) >> 1, b = l >= half;
  const int ux = (c0 >> 1) + l - b * half, uy = i >> 1;
  const int q = (i & 1) * 2 + b, r = uy * h2 + ux;  // quarter grid q = a * 2 + b
  const Tap t = tap(coef + 6 * n, i, 2 * ux + b, S2);
  const long long vplane = (long long)(S2 / 2) * S2;
  for (int c = 0; c < C; ++c) {
    const long long base = ((long long)n * C + c) * vplane;
    out[(((long long)q * N + n) * C + c) * qplane + r] =
        blend(phase_row(v0, v1, base, t.y0, S2), phase_row(v0, v1, base, t.y1, S2), t);
  }
}

// grid as gather2_kernel; g (4, N, C, h2, h2); dv0, dv1 (N, C, S2/2, S2)
// zeroed first
__global__ void __launch_bounds__(THREADS)
scatter2_kernel(const float* __restrict__ g, const float* __restrict__ coef,
                float* __restrict__ dv0, float* __restrict__ dv1, int N, int C, int S2,
                int win) {
  const int h2 = win / 2, qplane = h2 * h2;
  const int p = blockIdx.x * THREADS + threadIdx.x;
  const int n = blockIdx.y;
  if (p >= 4 * qplane) return;
  const int q = p / qplane, r = p % qplane;
  const Tap t = tap(coef + 6 * n, 2 * (r / h2) + (q >> 1), 2 * (r % h2) + (q & 1), S2);
  const long long vplane = (long long)(S2 / 2) * S2;
  for (int c = 0; c < C; ++c) {
    const float gv = __ldg(g + (((long long)q * N + n) * C + c) * qplane + r);
    if (gv == 0.f) continue;
    const long long base = ((long long)n * C + c) * vplane;
    spread(phase_row(dv0, dv1, base, t.y0, S2), phase_row(dv0, dv1, base, t.y1, S2), t, gv);
  }
}

dim3 grid_for(int N, int win) {
  return dim3((unsigned)(((long long)win * win + THREADS - 1) / THREADS), (unsigned)N);
}

}  // namespace

// Every entry point launches on `stream` (PyTorch's current stream), takes
// contiguous fp32 buffers, and returns cudaGetLastError() so the caller can
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

// The two-phase pair: S2 and win even; v0, v1, dv0, dv1 (N, C, S2/2, S2);
// out and g (4, N, C, win/2, win/2).
extern "C" int affine_warp2_gather(const float* v0, const float* v1, const float* coef,
                                   float* out, int N, int C, int S2, int win, void* stream) {
  if ((S2 | win) & 1) return (int)cudaErrorInvalidValue;
  if ((long long)N * C * win == 0) return (int)cudaGetLastError();
  if (N > 65535) return (int)cudaErrorInvalidValue;
  gather2_kernel<<<grid_for(N, win), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      v0, v1, coef, out, N, C, S2, win);
  return (int)cudaGetLastError();
}

extern "C" int affine_warp2_scatter(const float* g, const float* coef, float* dv0, float* dv1,
                                    int N, int C, int S2, int win, void* stream) {
  if ((S2 | win) & 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = sizeof(float) * (size_t)N * C * (S2 / 2) * S2;
  cudaError_t err = cudaMemsetAsync(dv0, 0, bytes, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(dv1, 0, bytes, s);
  if (err != cudaSuccess) return (int)err;
  if ((long long)N * C * win == 0) return (int)cudaGetLastError();
  if (N > 65535) return (int)cudaErrorInvalidValue;
  scatter2_kernel<<<grid_for(N, win), THREADS, 0, s>>>(g, coef, dv0, dv1, N, C, S2, win);
  return (int)cudaGetLastError();
}
