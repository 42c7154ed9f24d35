// upfirdn2d forward for Hopper (sm_90a): upsample by zero-stuffing, pad or
// crop, correlate with the flipped FIR taps, keep every down-th pixel.
//
// Replaces the three Pallas FIR kernels of the JAX package,
// diagan_tpu/ops/fir_pallas.py: _fir2d (flattened (N, Hp, Wp*C) view),
// _fir2d_nhwc (up=down=1, C % 128 == 0) and _fir2d_pair (C == 64 pixel-pair
// view). Those were one computation split by TPU lane layout; on the GPU one
// kernel covers every channel count, and it also does the zero-stuffing,
// padding and striding that the TPU path did around its kernels with XLA
// pad and slice ops (_upfirdn2d_pallas_raw).
//
// Bound: bytes. Each output reads kh*kw taps (16 for the 4x4 blur, and only
// a quarter of them land on real pixels when up=2), i.e. about 2 flops per
// byte moved, far below the card's ~20 fp32 flops per byte. The least time
// is one read of the input plus one write of the output at 3.35 TB/s.
// Design: a block computes a 32x32 output tile of one (n, c) plane (grid z
// walks the planes). It first copies the input window that tile needs into
// shared memory as fp32, zero-filled where the pad lies outside the image,
// so each input pixel leaves device memory about once (plus a small halo)
// and the kh*kw re-reads hit shared memory. Then each thread computes four
// outputs of one column. Taps that would hit a stuffed zero are skipped by
// index math: one modulo per axis finds the first tap on a real pixel, then
// the input index steps by one every `up` taps, so no zero-stuffed or
// padded buffer is ever written. The 4x4 up = 1 blurs of the serving path
// get an instance with those sizes fixed, so its tap loops unroll with the
// taps in registers. Strides carry the layout, so the same
// kernel takes NCHW and channels-last (the latter with uncoalesced tile
// loads; it is not on the serving path). fp32 accumulation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

struct Params {
  int N, C, H, W, OH, OW;
  long long sxn, sxc, sxh, sxw;  // input strides, in elements
  long long syn, syc, syh, syw;  // output strides, in elements
  int kh, kw, up_x, up_y, down_x, down_y, p_x0, p_y0;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

constexpr int TILE = 32;   // output tile is TILE x TILE
constexpr int ROWS = 8;    // block is TILE x ROWS threads; each thread does TILE / ROWS rows

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// First tap index k0 on a real (not stuffed) pixel for an output whose tap 0
// sits at stuffed position s0, and that pixel's input index i0.
__device__ __forceinline__ void first_tap(int s0, int up, int& k0, int& i0) {
  k0 = (-s0) % up;
  if (k0 < 0) k0 += up;
  i0 = (s0 + k0) / up;  // exact: s0 + k0 is a multiple of up
}

// Input rows (or columns) a tile needs: outputs o0 .. o0 + TILE - 1 read the
// stuffed positions o*down - p0 + k, k < kh, i.e. input pixels lo .. lo + n - 1.
__host__ __device__ inline int window(int up, int down, int k) {
  return ((TILE - 1) * down + k - 1) / up + 2;
}

// taps: the kernel as given, (kh, kw) row-major and NOT flipped; the flip of
// the correlation is folded into the tap index. KH, KW, UP > 0 fix those
// values at compile time (the serving path's 4x4 blurs at up = 1, whose tap
// loops then unroll with the taps in registers); 0 reads them from `p`.
template <typename T, int KH, int KW, int UP>
__global__ void __launch_bounds__(TILE * ROWS)
upfirdn2d_kernel(const T* __restrict__ x, T* __restrict__ y,
                 const float* __restrict__ taps, Params p) {
  extern __shared__ float tile[];
  const int kh = KH ? KH : p.kh, kw = KW ? KW : p.kw;
  const int up_y = UP ? UP : p.up_y, up_x = UP ? UP : p.up_x;
  const int wh = window(up_y, p.down_y, kh);
  const int ww = window(up_x, p.down_x, kw);
  const int ox0 = blockIdx.x * TILE, oy0 = blockIdx.y * TILE;
  // first input row / column of the window (ceil of the first stuffed position / up)
  const int iy_lo = -floor_div(-(oy0 * p.down_y - p.p_y0), up_y);
  const int ix_lo = -floor_div(-(ox0 * p.down_x - p.p_x0), up_x);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ox = ox0 + tx;
  int kx0, ix0;
  first_tap(ox * p.down_x - p.p_x0, up_x, kx0, ix0);
  for (int z = blockIdx.z; z < p.N * p.C; z += gridDim.z) {
    const int n = z / p.C, c = z % p.C;
    const T* xb = x + n * p.sxn + c * p.sxc;
    __syncthreads();  // the previous plane's reads of `tile` are done
    for (int r = ty; r < wh; r += ROWS) {
      const int iy = iy_lo + r;
      const bool row_in = (unsigned)iy < (unsigned)p.H;
      for (int q = tx; q < ww; q += TILE) {
        const int ix = ix_lo + q;
        tile[r * ww + q] = (row_in && (unsigned)ix < (unsigned)p.W)
                               ? to_float(xb[iy * p.sxh + ix * p.sxw]) : 0.f;
      }
    }
    __syncthreads();
    if (ox >= p.OW) continue;
#pragma unroll
    for (int j = 0; j < TILE / ROWS; ++j) {
      const int oy = oy0 + ty + j * ROWS;
      if (oy >= p.OH) break;
      int ky0, iy0;
      first_tap(oy * p.down_y - p.p_y0, up_y, ky0, iy0);
      float acc = 0.f;
      const float* srow = tile + (iy0 - iy_lo) * ww + (ix0 - ix_lo);
#pragma unroll
      for (int ky = ky0; ky < kh; ky += up_y, srow += ww) {
        const float* trow = taps + (kh - 1 - ky) * kw + (kw - 1);
#pragma unroll
        for (int kx = kx0, q = 0; kx < kw; kx += up_x, ++q) {
          acc += __ldg(trow - kx) * srow[q];
        }
      }
      y[n * p.syn + c * p.syc + oy * p.syh + ox * p.syw] = from_float<T>(acc);
    }
  }
}

template <typename T, int KH, int KW, int UP>
cudaError_t launch_as(const void* x, void* y, const float* taps, const Params& p,
                      cudaStream_t s) {
  const size_t smem = sizeof(float) * window(p.up_y, p.down_y, p.kh)
                      * window(p.up_x, p.down_x, p.kw);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;  // taps far wider than any caller's
  const int planes = p.N * p.C;
  const dim3 grid((p.OW + TILE - 1) / TILE, (p.OH + TILE - 1) / TILE,
                  planes < 65535 ? planes : 65535);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  upfirdn2d_kernel<T, KH, KW, UP><<<grid, dim3(TILE, ROWS), smem, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), taps, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, void* y, const float* taps, const Params& p,
                   cudaStream_t s) {
  if (p.kh == 4 && p.kw == 4 && p.up_x == 1 && p.up_y == 1)
    return launch_as<T, 4, 4, 1>(x, y, taps, p, s);
  return launch_as<T, 0, 0, 0>(x, y, taps, p, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Launches on `stream` (PyTorch's current
// stream) and returns cudaGetLastError() so the caller can raise on a
// refused launch.
extern "C" int upfirdn2d_forward(
    const void* x, void* y, const float* taps, int dtype,
    int N, int C, int H, int W, int OH, int OW,
    long long sxn, long long sxc, long long sxh, long long sxw,
    long long syn, long long syc, long long syh, long long syw,
    int kh, int kw, int up_x, int up_y, int down_x, int down_y,
    int p_x0, int p_y0, void* stream) {
  Params p;
  p.N = N; p.C = C; p.H = H; p.W = W; p.OH = OH; p.OW = OW;
  p.sxn = sxn; p.sxc = sxc; p.sxh = sxh; p.sxw = sxw;
  p.syn = syn; p.syc = syc; p.syh = syh; p.syw = syw;
  p.kh = kh; p.kw = kw; p.up_x = up_x; p.up_y = up_y;
  p.down_x = down_x; p.down_y = down_y; p.p_x0 = p_x0; p.p_y0 = p_y0;
  if ((long long)N * C * OH * OW == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, y, taps, p, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, y, taps, p, s);
  return (int)cudaErrorInvalidValue;
}
