// upfirdn2d for Hopper (sm_90a): upsample by zero-stuffing, pad or crop,
// correlate with the flipped FIR taps, keep every down-th pixel.
//
// Replaces the three Pallas FIR kernels of the JAX package,
// diagan_tpu/ops/fir_pallas.py: _fir2d (:44, flattened (N, Hp, Wp*C) view),
// _fir2d_nhwc (:131, up = down = 1, C % 128 == 0) and _fir2d_pair (:226,
// C == 64 pixel-pair view), and with flipped taps their backward (_vjp_bwd,
// :379). Those were one computation split by TPU lane layout; here it is
// split by shape family instead, and every instance also does the
// zero-stuffing, padding and striding that the TPU path did around its
// kernels with XLA pad and slice ops (_upfirdn2d_pallas_raw).
//
// Bound: bytes, for every instance. An output takes at most kh*kw taps (16
// for the 4x4 blurs, 12 for ADA's passes; only half or a quarter of them
// land on real pixels when up = 2): ~2 flops per byte moved, far below the
// card's ~20 fp32 flops per byte, so tensor cores have nothing to do here.
// The least time is one read of the input and one write of the output at
// 3.35 TB/s: (N*C*H*W + N*C*OH*OW) * sizeof(T) bytes. What an instance can
// lose against it: input re-read from device memory (halos), idle lanes,
// sectors fetched and not used, bank conflicts, and too few bytes in flight.
//
// Instances. The Python wrapper (ops/upfirdn2d.py, fir_instance) chooses one
// from the arguments' shapes and passes its code; fits() below checks that
// the code fits the arguments and the entry point refuses a mismatch. Every
// family the main paths launch (serving, both training phases, the
// polyphase resample) has an instance with taps, up and down fixed at
// compile time, for contiguous NCHW float32 or bfloat16. Each replaces #1-#3
// above for its family, and is bound by its bytes as above:
//
//   code instance       taps  up x,y  down x,y  main-path use (256 px)
//   1    fir4x4         4x4   1,1     1,1       G upsample blur (16,128,257,257),
//                                               D conv and skip blurs, their backwards
//   2    fir4x4_up2     4x4   2,2     1,1       ToRGB skip upsample (16,3,128,128)
//   3    fir4x4_down2   4x4   1,1     2,2       its backward
//   4    fir6x6         6x6   1,1     1,1       polyphase 6x6 down FIRs (16,3,262,262)
//   5    fir6y          6x1   1,1     1,1       polyphase y-phase passes (16,3,652,1304)
//   6    fir12y_up2     12x1  1,2     1,1       ADA y up-pass (16,3,652,652), y down backward
//   7    fir12y_down2   12x1  1,1     1,2       ADA y down-pass, y up backward (16,3,1304,652)
//   8    fir12x_up2     1x12  2,1     1,1       ADA x up-pass (16,3,1304,652), x down backward
//   9    fir12x_down2   1x12  1,1     2,1       ADA x down-pass, x up backward (16,3,1304,1304)
//   0    generic        any   any     any       anything else, channels-last included
//
// Instances 1-8 are fir_kernel; their design against the bytes bound:
// - no shared memory and no barrier: lane l of a warp owns output column l
//   of a 32-wide tile (for up = 2 along x, the output column pair l of a
//   64-wide tile) and walks R output rows down it. Each input row it needs
//   is read once per thread into registers, and the kh taps of a column
//   re-use it from there (a sliding window), so the rows read per output
//   fall from kh to (R - 1) * down / up + kh over R. The kw horizontal
//   neighbours that adjacent lanes share come from the same L1 lines, and
//   the halo rows of one band are the next band's rows, which sit in the
//   same block: each input byte leaves device memory about once;
// - the loops are unrolled at compile time, so a thread starts all of its
//   loads back to back, independent of the FMAs: that keeps enough bytes
//   in flight to cover the memory latency without a double buffer;
// - the taps live in registers, loaded once per thread;
// - up = 2: one thread computes both output parities of one input position
//   (the pair along x, row pairs along y), so the taps that would hit
//   stuffed zeros are dropped at compile time and nothing branches on
//   parity; an odd pad shifts the tiling by one output. Along x the pair is
//   stored as one float2 (bfloat162) when the output row allows it;
// - one warp per (plane, row band, column tile), eight warps a block, the
//   bands of one column tile in one block so that their halo rows hit L1;
//   planes of 8-16 px put several planes in one block.
// Instance 9 is fir_xdown2_kernel. With down = 2 along x, a lane-per-column
// read would fetch columns two apart, twice the sectors a warp uses per
// load; instead each warp copies its row segment with coalesced loads into
// shared memory, de-interleaved into even and odd columns (the odd half 16
// banks after the even one, so the copy is free of bank conflicts), and
// then every tap is a read of 32 consecutive words: no conflicts, and each
// input byte is read from device memory once. A warp walks one output row;
// only __syncwarp orders its copy and its reads.
// fp32 accumulation in every instance; T is float or bfloat16.
//
// The generic instance keeps the first design: a block computes a 32x32
// output tile of one plane from an input window staged in shared memory,
// with kh, kw, up and down read at run time and strides carrying the
// layout, so it also takes channels-last input.

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

// Two neighbouring outputs as one aligned store.
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---------------------------------------------------------------------------
// Instances 1-8: fir_kernel
// ---------------------------------------------------------------------------
constexpr int WARPS = 8;  // warps per block

// Output tiling of fir_kernel: each warp owns a (32 * up_x) x R output tile;
// tiles are numbered row band fastest, then column tile, then plane.
struct Tiling {
  int tx, ty;  // column tiles and row bands per plane
};

// Taps (KH, KW), up (UPX, UPY) and down (DNX, DNY) fixed; R output rows per
// thread. Up and down are 1 or 2, and never both 2 on one axis.
template <typename T, int KH, int KW, int UPX, int UPY, int DNX, int DNY, int R>
__global__ void __launch_bounds__(32 * WARPS)
fir_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ taps,
           Params p, Tiling tl) {
  static_assert(UPX * DNX <= 2 && UPY * DNY <= 2 && R % UPY == 0, "instance shape");
  constexpr int CX = UPX;  // outputs per thread along x: both parities when up = 2
  // input columns and rows one thread reads
  constexpr int NX = ((CX - 1) * DNX + KW - 1) / UPX + 1;
  constexpr int NY = ((R - 1) * DNY + KH - 1) / UPY + 1;

  const long long warp = (long long)blockIdx.x * WARPS + threadIdx.y;
  const long long per_plane = (long long)tl.tx * tl.ty;
  const long long z = warp / per_plane;
  if (z >= (long long)p.N * p.C) return;
  const int t = (int)(warp - z * per_plane);
  const int band = t % tl.ty, col = t / tl.ty;
  // an odd pad under up = 2 shifts the tiling by one output, so that every
  // thread's first output sits on a real (not stuffed) input position
  const int sx = p.p_x0 & (UPX - 1), sy = p.p_y0 & (UPY - 1);
  const int ox0 = (col * 32 + (int)threadIdx.x) * CX - sx;
  const int oy0 = band * R - sy;
  if (ox0 >= p.OW) return;
  const int ix0 = (ox0 * DNX - p.p_x0) / UPX;  // exact: a multiple of UPX
  const int iy0 = (oy0 * DNY - p.p_y0) / UPY;

  float tf[KH][KW];  // the taps, flipped: the op correlates with the flipped kernel
#pragma unroll
  for (int ky = 0; ky < KH; ++ky)
#pragma unroll
    for (int kx = 0; kx < KW; ++kx) tf[ky][kx] = __ldg(taps + (KH - 1 - ky) * KW + (KW - 1 - kx));
  bool col_in[NX];
#pragma unroll
  for (int c = 0; c < NX; ++c) col_in[c] = (unsigned)(ix0 + c) < (unsigned)p.W;

  const T* xb = x + z * p.H * p.W + ix0;
  float acc[R][CX];
#pragma unroll
  for (int e = 0; e < R; ++e)
#pragma unroll
    for (int f = 0; f < CX; ++f) acc[e][f] = 0.f;
#pragma unroll
  for (int r = 0; r < NY; ++r) {
    const int iy = iy0 + r;
    const bool row_in = (unsigned)iy < (unsigned)p.H;
    float v[NX];
#pragma unroll
    for (int c = 0; c < NX; ++c)
      v[c] = (row_in && col_in[c]) ? to_float(xb[(long long)iy * p.W + c]) : 0.f;
    // input (r, c) feeds output (e, f) through tap (r*UPY - e*DNY, c*UPX - f*DNX)
#pragma unroll
    for (int e = 0; e < R; ++e) {
      const int ky = r * UPY - e * DNY;
      if (ky < 0 || ky >= KH) continue;
#pragma unroll
      for (int f = 0; f < CX; ++f)
#pragma unroll
        for (int c = 0; c < NX; ++c) {
          const int kx = c * UPX - f * DNX;
          if (kx >= 0 && kx < KW) acc[e][f] += tf[ky][kx] * v[c];
        }
    }
  }
  T* yb = y + z * p.OH * p.OW;
  // the pair of an up = 2 x pass as one store: the row and the pair aligned
  const bool pair = CX == 2 && sx == 0 && (p.OW & 1) == 0;
#pragma unroll
  for (int e = 0; e < R; ++e) {
    const int oy = oy0 + e;
    if ((unsigned)oy >= (unsigned)p.OH) continue;
    T* yr = yb + (long long)oy * p.OW;
    if (pair) {
      store_pair(yr + ox0, acc[e][0], acc[e][CX - 1]);
    } else {
#pragma unroll
      for (int f = 0; f < CX; ++f) {
        const int ox = ox0 + f;
        if ((unsigned)ox < (unsigned)p.OW) yr[ox] = from_float<T>(acc[e][f]);
      }
    }
  }
}

template <typename T, int KH, int KW, int UPX, int UPY, int DNX, int DNY, int R>
cudaError_t launch_fir(const void* x, void* y, const float* taps, const Params& p,
                       cudaStream_t s) {
  Tiling tl;
  tl.tx = (p.OW + (p.p_x0 & (UPX - 1)) + 32 * UPX - 1) / (32 * UPX);
  tl.ty = (p.OH + (p.p_y0 & (UPY - 1)) + R - 1) / R;
  const long long blocks = ((long long)p.N * p.C * tl.tx * tl.ty + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  fir_kernel<T, KH, KW, UPX, UPY, DNX, DNY, R><<<(unsigned)blocks, dim3(32, WARPS), 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), taps, p, tl);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Instance 9: fir_xdown2_kernel (taps 1 x KW, down 2 along x, stride 1 along y)
// ---------------------------------------------------------------------------
constexpr int XD_OUT = 128;  // outputs of one segment: four per lane
// words of each de-interleaved half; 16 mod 32, so the odd half starts 16
// banks after the even one
constexpr int XD_HALF = 144;

// One warp per output row (plane, oy); it walks the row in segments of
// XD_OUT outputs, whose inputs (2 * XD_OUT + KW - 2 columns) it first copies
// into its own shared-memory slot as even and odd columns.
template <typename T, int KW>
__global__ void __launch_bounds__(32 * WARPS)
fir_xdown2_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ taps,
                  Params p) {
  constexpr int NIN = 2 * XD_OUT + KW - 2;
  static_assert((NIN + 1) / 2 <= XD_HALF && XD_HALF % 32 == 16, "segment layout");
  __shared__ float seg[WARPS][2][XD_HALF];
  const int lane = threadIdx.x;
  const long long row = (long long)blockIdx.x * WARPS + threadIdx.y;
  if (row >= (long long)p.N * p.C * p.OH) return;
  const long long z = row / p.OH;
  const int iy = (int)(row - z * p.OH) - p.p_y0;  // kh = 1, up = down = 1 along y
  T* yr = y + row * p.OW;
  if ((unsigned)iy >= (unsigned)p.H) {  // a pad row
    for (int o = lane; o < p.OW; o += 32) yr[o] = from_float<T>(0.f);
    return;
  }
  const T* xr = x + (z * p.H + iy) * p.W;
  float tf[KW];  // flipped
#pragma unroll
  for (int k = 0; k < KW; ++k) tf[k] = __ldg(taps + KW - 1 - k);
  float* even = seg[threadIdx.y][0];
  float* odd = seg[threadIdx.y][1];
  for (int o0 = 0; o0 < p.OW; o0 += XD_OUT) {
    const int ix0 = 2 * o0 - p.p_x0;  // input column of segment word 0
    __syncwarp();  // the previous segment's reads are done
#pragma unroll
    for (int k = 0; k < (NIN + 31) / 32; ++k) {
      const int i = k * 32 + lane;
      if (i < NIN) {
        const int ix = ix0 + i;
        const float v = (unsigned)ix < (unsigned)p.W ? to_float(xr[ix]) : 0.f;
        (i & 1 ? odd : even)[i >> 1] = v;
      }
    }
    __syncwarp();
    // output o0 + j reads segment words 2j + t, t < KW
#pragma unroll
    for (int m = 0; m < XD_OUT / 32; ++m) {
      const int j = m * 32 + lane;
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < KW; ++t) acc += tf[t] * (t & 1 ? odd : even)[j + (t >> 1)];
      if (o0 + j < p.OW) yr[o0 + j] = from_float<T>(acc);
    }
  }
}

template <typename T, int KW>
cudaError_t launch_xdown2(const void* x, void* y, const float* taps, const Params& p,
                          cudaStream_t s) {
  const long long blocks = ((long long)p.N * p.C * p.OH + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  fir_xdown2_kernel<T, KW><<<(unsigned)blocks, dim3(32, WARPS), 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), taps, p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The generic instance
// ---------------------------------------------------------------------------
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
// the correlation is folded into the tap index. Taps that would hit a
// stuffed zero are skipped by index math: one modulo per axis finds the
// first tap on a real pixel, then the input index steps by one every `up`
// taps. Each thread computes four outputs of one column.
template <typename T>
__global__ void __launch_bounds__(TILE * ROWS)
fir_generic_kernel(const T* __restrict__ x, T* __restrict__ y,
                   const float* __restrict__ taps, Params p) {
  extern __shared__ float tile[];
  const int kh = p.kh, kw = p.kw, up_y = p.up_y, up_x = p.up_x;
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
      for (int ky = ky0; ky < kh; ky += up_y, srow += ww) {
        const float* trow = taps + (kh - 1 - ky) * kw + (kw - 1);
        for (int kx = kx0, q = 0; kx < kw; kx += up_x, ++q) {
          acc += __ldg(trow - kx) * srow[q];
        }
      }
      y[n * p.syn + c * p.syc + oy * p.syh + ox * p.syw] = from_float<T>(acc);
    }
  }
}

template <typename T>
cudaError_t launch_generic(const void* x, void* y, const float* taps, const Params& p,
                           cudaStream_t s) {
  const size_t smem = sizeof(float) * window(p.up_y, p.down_y, p.kh)
                      * window(p.up_x, p.down_x, p.kw);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;  // taps far wider than any caller's
  const int planes = p.N * p.C;
  const dim3 grid((p.OW + TILE - 1) / TILE, (p.OH + TILE - 1) / TILE,
                  planes < 65535 ? planes : 65535);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  fir_generic_kernel<T><<<grid, dim3(TILE, ROWS), smem, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), taps, p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Dispatch
// ---------------------------------------------------------------------------
// The codes of ops/upfirdn2d.py FIR_INSTANCES, in the same order.
enum Instance {
  GENERIC = 0, FIR4X4, FIR4X4_UP2, FIR4X4_DOWN2, FIR6X6, FIR6Y,
  FIR12Y_UP2, FIR12Y_DOWN2, FIR12X_UP2, FIR12X_DOWN2, N_INSTANCES
};

struct Family {
  int kh, kw, up_x, up_y, down_x, down_y;
};

// Indexed by Instance; GENERIC's row is unused.
constexpr Family FAMILIES[N_INSTANCES] = {
    {0, 0, 0, 0, 0, 0}, {4, 4, 1, 1, 1, 1}, {4, 4, 2, 2, 1, 1}, {4, 4, 1, 1, 2, 2},
    {6, 6, 1, 1, 1, 1}, {6, 1, 1, 1, 1, 1}, {12, 1, 1, 2, 1, 1}, {12, 1, 1, 1, 1, 2},
    {1, 12, 2, 1, 1, 1}, {1, 12, 1, 1, 2, 1}};

constexpr int MISMATCH = -1;  // the instance does not fit the arguments

// R (output rows per thread) of each fir_kernel instance: enough rows that
// the kh - 1 halo rows are a small share of what a thread reads, few enough
// that the unrolled window stays in registers (no instance spills). The 4x4
// blur takes 16 rows on planes of 16 rows or more and 8 on the 8 px planes,
// where 16 would leave half of each thread's rows outside the plane.
template <typename T>
cudaError_t launch(int instance, const void* x, void* y, const float* taps, const Params& p,
                   cudaStream_t s) {
  switch (instance) {
    case FIR4X4:
      return p.OH >= 16 ? launch_fir<T, 4, 4, 1, 1, 1, 1, 16>(x, y, taps, p, s)
                        : launch_fir<T, 4, 4, 1, 1, 1, 1, 8>(x, y, taps, p, s);
    case FIR4X4_UP2: return launch_fir<T, 4, 4, 2, 2, 1, 1, 8>(x, y, taps, p, s);
    case FIR4X4_DOWN2: return launch_fir<T, 4, 4, 1, 1, 2, 2, 4>(x, y, taps, p, s);
    case FIR6X6: return launch_fir<T, 6, 6, 1, 1, 1, 1, 16>(x, y, taps, p, s);
    case FIR6Y: return launch_fir<T, 6, 1, 1, 1, 1, 1, 16>(x, y, taps, p, s);
    case FIR12Y_UP2: return launch_fir<T, 12, 1, 1, 2, 1, 1, 16>(x, y, taps, p, s);
    case FIR12Y_DOWN2: return launch_fir<T, 12, 1, 1, 1, 1, 2, 16>(x, y, taps, p, s);
    case FIR12X_UP2: return launch_fir<T, 1, 12, 2, 1, 1, 1, 4>(x, y, taps, p, s);
    case FIR12X_DOWN2: return launch_xdown2<T, 12>(x, y, taps, p, s);
    default: return launch_generic<T>(x, y, taps, p, s);
  }
}

// An instance other than GENERIC takes exactly its family's taps, up and
// down, and contiguous NCHW input and output.
bool fits(int instance, const Params& p) {
  if (instance < 0 || instance >= N_INSTANCES) return false;
  if (instance == GENERIC) return true;
  const Family& f = FAMILIES[instance];
  const bool nchw = p.sxw == 1 && p.sxh == p.W && p.sxc == (long long)p.H * p.W &&
                    p.sxn == (long long)p.C * p.H * p.W && p.syw == 1 && p.syh == p.OW &&
                    p.syc == (long long)p.OH * p.OW && p.syn == (long long)p.C * p.OH * p.OW;
  return nchw && p.kh == f.kh && p.kw == f.kw && p.up_x == f.up_x && p.up_y == f.up_y &&
         p.down_x == f.down_x && p.down_y == f.down_y;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; instance: a code of enum Instance.
// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError() so the caller can raise on a refused launch, or
// MISMATCH (-1) when the instance does not fit the arguments.
extern "C" int upfirdn2d_forward(
    const void* x, void* y, const float* taps, int dtype, int instance,
    int N, int C, int H, int W, int OH, int OW,
    long long sxn, long long sxc, long long sxh, long long sxw,
    long long syn, long long syc, long long syh, long long syw,
    int kh, int kw, int up_x, int up_y, int down_x, int down_y, int p_x0, int p_y0,
    void* stream) {
  Params p;
  p.N = N; p.C = C; p.H = H; p.W = W; p.OH = OH; p.OW = OW;
  p.sxn = sxn; p.sxc = sxc; p.sxh = sxh; p.sxw = sxw;
  p.syn = syn; p.syc = syc; p.syh = syh; p.syw = syw;
  p.kh = kh; p.kw = kw; p.up_x = up_x; p.up_y = up_y;
  p.down_x = down_x; p.down_y = down_y; p.p_x0 = p_x0; p.p_y0 = p_y0;
  if (!fits(instance, p)) return MISMATCH;
  if ((long long)N * C * OH * OW == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(instance, x, y, taps, p, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(instance, x, y, taps, p, s);
  return (int)cudaErrorInvalidValue;
}
