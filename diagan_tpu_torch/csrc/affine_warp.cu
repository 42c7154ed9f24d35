// ADA's affine bilinear warp and its adjoint for Hopper (sm_90a), in two
// source layouts: one interleaved 2x buffer, or its two y-phase planes.
//
// Replaces the JAX package's Pallas kernels
//   diagan_tpu/ops/warp_pallas.py: _gather_fwd_pallas (kernel body
//     _gather_kernel) and _scatter_grad_pallas (_scatter_kernel), the
//     interleaved pair: gather_kernel, and scatter_kernel with
//     scatter_clamped_kernel, below;
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
// reads. The TPU built all four as hat-weight matmuls over static DMA
// windows because it has no vector gather or scatter, and its windows
// truncated reads beyond about 2.5-2.7x scale. The GPU has both gather and
// scatter, so each is a direct kernel, exact bilinear, and nothing truncates.
//
// Bound: bytes. The gathers do ~20 flops per output per channel against 4
// loads and 1 store: the least they move is each touched source pixel read
// once and the output written once (0.0326 ms for either gather at ADA's
// largest pad bucket, batch 16, ADA draws at p = 1: the buffer (16, 3, 1304,
// 1304) or its planes 2 x (16, 3, 652, 1304), win 524; on an NVIDIA H100
// 80GB HBM3 at 700 W and 3.35 TB/s). The adjoints must read g once and write all of dx2 (or both
// planes) once (0.1132 ms there).
//
// All kernels share tap(), whose coordinates use __fmul_rn / __fadd_rn in
// the order of the plain versions (ops/warp.py: affine_gather_plain,
// ops/ada_phase.py: affine_gather2_plain), which rules out FMA contraction:
// the clamp, floor and weights equal the plain versions' bit for bit, and
// with mix()'s blend order the gathers are exact against them.
//
// Both pairs are tiled on one fact: under an affine map q is monotone in i
// and in j (rounded or not), and so are the clamp and the floor, so the taps
// of a rectangle of outputs lie in the box spanned by its four corners'
// taps, and the outputs that reach a rectangle of source pixels lie in the
// preimage of that rectangle. The interleaved pair:
//  - gather_kernel: a block takes a GATHER_TH x GATHER_TW tile of outputs (a
//    lane per column, GATHER_ROWS rows per thread). From the corners' taps it
//    takes the tile's source box and copies the box of each channel plane
//    into shared memory with cp.async (16-byte copies where the rows allow),
//    double-buffered over the channels, so the copy of channel c + 1
//    overlaps the blend of channel c; each thread computes tap() once per
//    output and blends from shared memory. Warps store along output rows. A
//    tile whose box exceeds GATHER_BUF floats (strong zoom-out, degenerate
//    maps) blends from global memory instead, with the same result.
//  - scatter_kernel owns its output: persistent blocks walk the
//    SCATTER_TH x SCATTER_TW tiles of dx2 and write every pixel once with
//    coalesced stores, zeros included: no memset and no global atomic. The
//    outputs whose unclamped q puts a tap in a tile have q in the tile grown
//    by one pixel; tile_geom bounds their indices, and a tile that none
//    reaches (most of dx2) is written as zeros. The others take the cell
//    path: cell (y, x) holds the outputs with floor(q) = (y, x), and their
//    terms land on the pixels (y..y+1, x..x+1). Each warp takes
//    SCATTER_ROWS pixel rows of the tile, a lane per cell column, walks the
//    cell rows, enumerates each cell's outputs from the inverse map (a
//    K x K window, K = 2 or 3), re-derives tap() for each, sums the four
//    corners' terms in registers, and adds each pixel's four cell sums by
//    shuffles. No atomics, no shared memory, no barrier, and a fixed sum
//    order: the tile pass gives the same bits on every run. Where no K <= 3
//    window holds a cell (strong zoom-in, singular maps) the tile takes a
//    fallback: every candidate adds its terms to a shared-memory accumulator
//    with shared atomics. g is read through L1.
//  - scatter_clamped_kernel, next on the stream: an output with a clamped
//    coordinate lands on the border from anywhere in a half-plane, so the
//    tile pass skips it and this pass adds it with global atomicAdd. Only an
//    image whose output-grid corners leave [0, S2 - 1] can have one; the
//    others return at once.
// ops/warp.py mirrors this tile geometry in plain torch (_gather_tile_boxes,
// _scatter_tile_candidates) so that the CPU tests can check it.
//
// The two-phase pair. gather2_kernel is gather_kernel's tile pass under
// another layout policy (InterleavedGather, TwoPhaseGather below): the same
// tiles, corner taps, source boxes, budget and blend, with two address maps
// changed. Box row r is staged from buffer row y = r0 + r, which is row
// y >> 1 of plane y & 1 (phase_row), 16 bytes a copy when S2 is a multiple
// of 4 and both planes are 16-byte aligned; output (i, j) is stored in
// quarter grid (i & 1) * 2 + (j & 1) at (i >> 1, j >> 1). WARPS is even, so
// all rows of a thread have its warp's parity, and a warp's row store is 16
// neighbouring words of quarter grid b = 0 from the even lanes and 16 of
// b = 1 from the odd ones. It replaces _gather2_pallas, which built the four
// quarter grids from hat-weight matmuls over the two planes' DMA windows.
// ops/ada_phase.py mirrors the staging map in plain torch (_phase_box_rows).
// The adjoint is the interleaved adjoint's tile pass and clamped pass with
// two address maps changed, through a layout policy (Interleaved, TwoPhase
// below): the cotangent of output (i, j) is read from quarter grid
// (i & 1) * 2 + (j & 1) at (i >> 1, j >> 1), and buffer row y is written to
// phase_row(y). The tiles,
// candidates, cells and sum order are the same, so scatter2_kernel owns its
// tiles of both planes with no memset and no global atomic, and
// scatter2_clamped_kernel adds the clamped outputs. Where no output is
// clamped and no tile falls back, its planes equal the interleaved adjoint's
// dx2 of the interleaved cotangent, de-interleaved, bit for bit.
//
// The adjoints match the plain versions to fp32 rounding, not bit for bit:
// they sum in another order, and where they use atomics (the clamped
// outputs and the fallback of both adjoints) in an order that changes from
// run to run.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// Tile geometry of the interleaved pair; ops/warp.py holds the same numbers.
constexpr int GATHER_ROWS = 4;              // output rows per thread
constexpr int GATHER_TH = WARPS * GATHER_ROWS;  // tile rows
constexpr int GATHER_TW = 32;               // tile columns, one per lane
constexpr int GATHER_BUF = 4608;            // floats of one channel's source box
constexpr int GATHER_BLOCKS = 4;            // resident gather blocks per SM
constexpr int SCATTER_TH = 32;              // dx2 tile rows, SCATTER_ROWS per warp
constexpr int SCATTER_TW = 32;              // dx2 tile columns, one per lane
constexpr int SCATTER_ROWS = SCATTER_TH / WARPS;  // pixel rows of one warp's strip
constexpr int SCATTER_CH = 3;               // channels per pass of the cell path
constexpr int SCATTER_BLOCKS = 2;           // resident tile-pass blocks per SM
constexpr int CLAMP_BLOCKS = 64;            // blocks per image, clamped-output pass
// a dx2 tile's rows start at an even row, so its row dy has the parity of dy
static_assert(SCATTER_TH % 2 == 0 && SCATTER_TH % WARPS == 0, "scatter tile rows");
// a gather thread's rows first + WARPS * r share first's parity (two-phase stores)
static_assert(WARPS % 2 == 0, "gather rows keep their parity");

struct Q {
  float y, x;  // the unclamped source point
};

struct Tap {
  int y0, y1, x0, x1;        // rows and columns of the 4 neighbours
  float wy0, wy1, wx0, wx1;  // (1 - fy), fy, (1 - fx), fx
};

__device__ __forceinline__ Q coords(const float* cf, float fi, float fj) {
  return {__fadd_rn(__fadd_rn(__fmul_rn(cf[0], fi), __fmul_rn(cf[1], fj)), cf[2]),
          __fadd_rn(__fadd_rn(__fmul_rn(cf[3], fi), __fmul_rn(cf[4], fj)), cf[5])};
}

__device__ __forceinline__ Q coords(const float* cf, int i, int j) {
  return coords(cf, (float)i, (float)j);
}

__device__ __forceinline__ bool inside(Q q, int S2) {
  const float hi = (float)(S2 - 1);
  return q.y >= 0.f && q.y <= hi && q.x >= 0.f && q.x <= hi;
}

__device__ __forceinline__ Tap tap_at(Q q, int S2) {
  const float hi = (float)(S2 - 1);
  const float qy = fminf(fmaxf(q.y, 0.f), hi), qx = fminf(fmaxf(q.x, 0.f), hi);
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

__device__ __forceinline__ Tap tap(const float* cf, int i, int j, int S2) {
  return tap_at(coords(cf, i, j), S2);
}

// The bilinear blend of the four neighbours (top row x0, x1, bottom row x0,
// x1) in the plain version's order.
__device__ __forceinline__ float mix(float t0, float t1, float b0, float b1, const Tap& t) {
  const float a = __fadd_rn(__fmul_rn(t0, t.wx0), __fmul_rn(t1, t.wx1));
  const float b = __fadd_rn(__fmul_rn(b0, t.wx0), __fmul_rn(b1, t.wx1));
  return __fadd_rn(__fmul_rn(a, t.wy0), __fmul_rn(b, t.wy1));
}

// mix() read from global rows `top` and `bot` (pointers to the start of rows
// y0 and y1).
__device__ __forceinline__ float blend(const float* top, const float* bot, const Tap& t) {
  return mix(__ldg(top + t.x0), __ldg(top + t.x1), __ldg(bot + t.x0), __ldg(bot + t.x1), t);
}

__device__ __forceinline__ void add(float* dst, float v) {
  if (v != 0.f) atomicAdd(dst, v);
}

// add() into shared memory, in the shared state space by construction.
__device__ __forceinline__ void add_shared(float* dst, float v) {
  if (v != 0.f) {
    asm volatile("red.shared.add.f32 [%0], %1;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)),
                 "f"(v)
                 : "memory");
  }
}

// The adjoint of mix: g's four weighted terms (y0, x0), (y0, x1), (y1, x0),
// (y1, x1) in the plain version's autograd order, (g * wy) * wx.
struct Terms {
  float v00, v01, v10, v11;
};

__device__ __forceinline__ Terms terms(const Tap& t, float gv) {
  const float a = __fmul_rn(gv, t.wy0), b = __fmul_rn(gv, t.wy1);
  return {__fmul_rn(a, t.wx0), __fmul_rn(a, t.wx1), __fmul_rn(b, t.wx0), __fmul_rn(b, t.wx1)};
}

// The terms added onto global rows `top` and `bot` with atomicAdd.
__device__ __forceinline__ void spread(float* top, float* bot, const Tap& t, float gv) {
  const Terms v = terms(t, gv);
  add(top + t.x0, v.v00);
  add(top + t.x1, v.v01);
  add(bot + t.x0, v.v10);
  add(bot + t.x1, v.v11);
}

__device__ __forceinline__ void load_coef(const float* coef, int n, float* cf) {
#pragma unroll
  for (int k = 0; k < 6; ++k) cf[k] = __ldg(coef + 6 * n + k);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + h) x columns [c0, c0 + w) of a plane; in shared memory the
// box is held with row stride w. Empty when h or w is 0 or less.
struct Box {
  int r0, c0, h, w;
};

// Row y of the S2 x S2 buffer in the two-phase layout: row y >> 1 of plane
// y & 1, planes (S2 / 2) x S2. `base` is the (n, c) offset of both planes.
template <typename T>
__device__ __forceinline__ T* phase_row(T* v0, T* v1, long long base, int y, int S2) {
  return (y & 1 ? v1 : v0) + base + (long long)(y >> 1) * S2;
}

// The gathers' two layouts. A layout says where row y of the S2 x S2 buffer
// lies and where output (i, j) is stored; gather_tiles below takes one as a
// template argument and depends on the layout through it alone:
//  - src(n, c, y): row y of channel c of image n's buffer;
//  - dst(n, i, j): output (i, j) of image n, channel 0; cstep(): the step to
//    the next channel; rstep(): the step from output row i to row i + WARPS
//    of the same column.
// InterleavedGather: x2 (N, C, S2, S2), out (N, C, win, win).
struct InterleavedGather {
  const float* __restrict__ x2;
  float* __restrict__ out;
  int C, S2, win;

  __device__ __forceinline__ const float* src(int n, int c, int y) const {
    return x2 + ((long long)n * C + c) * S2 * S2 + (long long)y * S2;
  }
  __device__ __forceinline__ long long cstep() const { return (long long)win * win; }
  __device__ __forceinline__ long long rstep() const { return (long long)WARPS * win; }
  __device__ __forceinline__ float* dst(int n, int i, int j) const {
    return out + (long long)n * C * cstep() + (long long)i * win + j;
  }
};

// TwoPhaseGather: v0, v1 (N, C, S2/2, S2), buffer row y at phase_row(y); out
// (4, N, C, win/2, win/2), output (i, j) in quarter grid (i & 1) * 2 + (j & 1)
// at (i >> 1, j >> 1). Rows i and i + WARPS have one parity, so rstep stays
// in one quarter grid.
struct TwoPhaseGather {
  const float* __restrict__ v0;
  const float* __restrict__ v1;
  float* __restrict__ out;
  int N, C, S2, win;

  __device__ __forceinline__ const float* src(int n, int c, int y) const {
    return phase_row(v0, v1, ((long long)n * C + c) * (S2 / 2) * S2, y, S2);
  }
  __device__ __forceinline__ int h2() const { return win >> 1; }
  __device__ __forceinline__ long long cstep() const { return (long long)h2() * h2(); }
  __device__ __forceinline__ long long rstep() const { return (long long)(WARPS / 2) * h2(); }
  __device__ __forceinline__ float* dst(int n, int i, int j) const {
    return out + ((long long)((i & 1) * 2 + (j & 1)) * N + n) * C * cstep() +
           (long long)(i >> 1) * h2() + (j >> 1);
  }
};

// Copy box b of channel c of image n (rows from layout L) into `dst` with
// cp.async: 16-byte copies when vec (c0, w and S2 multiples of 4, the
// buffer 16-byte aligned), else 4-byte ones; consecutive threads take
// consecutive words.
template <typename L>
__device__ __forceinline__ void stage(float* dst, const L& lay, int n, int c, const Box& b,
                                      bool vec) {
  const int step = vec ? 4 : 1, wq = b.w / step, words = b.h * wq;
  for (int k = threadIdx.x; k < words; k += THREADS) {
    const int r = k / wq, x = (k - r * wq) * step;
    const float* s = lay.src(n, c, b.r0 + r) + b.c0 + x;
    if (vec) {
      cp_async16(dst + r * b.w + x, s);
    } else {
      cp_async4(dst + r * b.w + x, s);
    }
  }
}

// The source box of the gather tile at (i0, j0): rows and columns spanned by
// the taps of its four corners (columns widened to multiples of 4 when vec).
__device__ __forceinline__ Box gather_box(const float* cf, int i0, int j0, int S2, int win,
                                          bool vec) {
  const int i1 = min(i0 + GATHER_TH, win) - 1, j1 = min(j0 + GATHER_TW, win) - 1;
  const Tap a = tap(cf, i0, j0, S2), b = tap(cf, i0, j1, S2);
  const Tap c = tap(cf, i1, j0, S2), d = tap(cf, i1, j1, S2);
  const int y0 = min(min(a.y0, b.y0), min(c.y0, d.y0)), y1 = max(max(a.y1, b.y1), max(c.y1, d.y1));
  int x0 = min(min(a.x0, b.x0), min(c.x0, d.x0)), x1 = max(max(a.x1, b.x1), max(c.x1, d.x1));
  if (vec) {
    x0 &= ~3;
    x1 = ((x1 + 4) & ~3) - 1;
  }
  return {y0, x0, y1 - y0 + 1, x1 - x0 + 1};
}

// The gather tile pass of layout L: the block takes the tile at (i0, j0) =
// (blockIdx.y * GATHER_TH, blockIdx.x * GATHER_TW) of image blockIdx.z; vec:
// 16-byte copies of the buffer's rows.
template <typename L>
__device__ __forceinline__ void gather_tiles(const L& lay, const float* __restrict__ coef,
                                             bool vec) {
  __shared__ __align__(16) float buf[2][GATHER_BUF];
  const int n = blockIdx.z, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int C = lay.C, S2 = lay.S2, win = lay.win;
  const int i0 = blockIdx.y * GATHER_TH, j0 = blockIdx.x * GATHER_TW, j = j0 + lane;
  float cf[6];
  load_coef(coef, n, cf);
  // this thread's outputs: rows first + WARPS * r of column j
  const int first = i0 + warp;
  const int rows = j < win && first < win ? min(GATHER_ROWS, (win - 1 - first) / WARPS + 1) : 0;
  float* on = lay.dst(n, first, j);
  const long long cstep = lay.cstep(), rstep = lay.rstep();
  const Box b = gather_box(cf, i0, j0, S2, win, vec);
  if (b.h * b.w > GATHER_BUF) {  // the box does not fit: read the buffer from global
#pragma unroll
    for (int r = 0; r < GATHER_ROWS; ++r) {
      if (r < rows) {
        const Tap t = tap(cf, first + WARPS * r, j, S2);
        for (int c = 0; c < C; ++c) {
          on[c * cstep + r * rstep] = blend(lay.src(n, c, t.y0), lay.src(n, c, t.y1), t);
        }
      }
    }
    return;
  }
  // per output: the top-left neighbour's offset in the box, the steps to
  // the right and bottom neighbours (0 where clamped), and fx, fy
  int at[GATHER_ROWS], right[GATHER_ROWS], down[GATHER_ROWS];
  float fx[GATHER_ROWS], fy[GATHER_ROWS];
#pragma unroll
  for (int r = 0; r < GATHER_ROWS; ++r) {
    const Tap t = tap(cf, min(first + WARPS * r, win - 1), min(j, win - 1), S2);
    at[r] = (t.y0 - b.r0) * b.w + t.x0 - b.c0;
    right[r] = t.x1 - t.x0;
    down[r] = (t.y1 - t.y0) * b.w;
    fx[r] = t.wx1;
    fy[r] = t.wy1;
  }
  // channel c is staged in buf[c & 1]; one commit group per channel slot
  stage(buf[0], lay, n, 0, b, vec);
  cp_async_commit();
  if (C > 1) stage(buf[1], lay, n, 1, b, vec);
  cp_async_commit();
  for (int c = 0; c < C; ++c) {
    cp_async_wait<1>();  // channel c has landed (c + 1 may be in flight)
    __syncthreads();
    const float* s = buf[c & 1];
#pragma unroll
    for (int r = 0; r < GATHER_ROWS; ++r) {
      if (r < rows) {
        Tap t;  // the weights, as tap() derives them from fx and fy
        t.wx1 = fx[r];
        t.wy1 = fy[r];
        t.wx0 = __fsub_rn(1.f, fx[r]);
        t.wy0 = __fsub_rn(1.f, fy[r]);
        const float* p = s + at[r];
        on[c * cstep + r * rstep] = mix(p[0], p[right[r]], p[down[r]], p[down[r] + right[r]], t);
      }
    }
    __syncthreads();  // every thread is done with buf[c & 1]
    if (c + 2 < C) stage(buf[c & 1], lay, n, c + 2, b, vec);
    cp_async_commit();
  }
}

// The interleaved gather: grid (ceil(win / GATHER_TW), ceil(win / GATHER_TH),
// N); x2 (N, C, S2, S2), out (N, C, win, win).
__global__ void __launch_bounds__(THREADS, GATHER_BLOCKS)
gather_kernel(const float* __restrict__ x2, const float* __restrict__ coef,
              float* __restrict__ out, int C, int S2, int win, bool vec) {
  gather_tiles(InterleavedGather{x2, out, C, S2, win}, coef, vec);
}

// The two-phase gather: grid as gather_kernel; v0, v1 (N, C, S2/2, S2), out
// (4, N, C, win/2, win/2), quarter grid a * 2 + b first.
__global__ void __launch_bounds__(THREADS, GATHER_BLOCKS)
gather2_kernel(const float* __restrict__ v0, const float* __restrict__ v1,
               const float* __restrict__ coef, float* __restrict__ out, int N, int C, int S2,
               int win, bool vec) {
  gather_tiles(TwoPhaseGather{v0, v1, out, N, C, S2, win}, coef, vec);
}

// The geometry of one dx2 tile, rows [r0, r1] x columns [c0, c1]:
//  - cand: the outputs whose unclamped q can put a tap in the tile, those
//    with floor(q) in [r0 - 1, r1] x [c0 - 1, c1], so q in the rectangle
//    [r0 - 1, r1 + 1] x [c0 - 1, c1 + 1]. Their indices lie in the bounding
//    box of the rectangle's preimage under the map, widened by a margin for
//    q's fp32 rounding (four roundings, each at most half an ulp of the
//    largest term; the margin allows 8 times that) and clipped to
//    [0, win - 1]; the whole grid when the map is singular.
//  - for the cell path: the inverse m of the map's 2x2 part; the preimage
//    (ib, jb) of the tile's first cell corner (r0 - 1, c0 - 1); the offsets
//    di_lo, di_hi (dj_lo, dj_hi) from a cell corner's preimage to the least
//    and greatest output row (column) of the cell, widened by the rounding
//    slack of q and of this fp32 form; and the window K: every cell's outputs
//    lie in K consecutive rows and K consecutive columns (2 or 3; 0 when no
//    such K <= 3 exists or the map is singular: the tile takes the
//    fallback).
// In double with explicit rounding (no contraction), as ops/warp.py
// _scatter_tile_candidates computes it.
struct TileGeom {
  Box cand;
  float m00, m01, m10, m11, ib, jb, di_lo, di_hi, dj_lo, dj_hi;
  int K;
};

__device__ TileGeom tile_geom(const float* cf, int r0, int r1, int c0, int c1, int win) {
  const double ay = cf[0], by = cf[1], cy = cf[2], ax = cf[3], bx = cf[4], cx = cf[5];
  const double det = __dsub_rn(__dmul_rn(ay, bx), __dmul_rn(by, ax));
  const double m00 = __ddiv_rn(bx, det), m01 = __ddiv_rn(-by, det);
  const double m10 = __ddiv_rn(-ax, det), m11 = __ddiv_rn(ay, det);
  const double big = __dadd_rn(__dadd_rn(__dmul_rn(fmax(fabs(ay), fabs(ax)), (double)win),
                                         __dmul_rn(fmax(fabs(by), fabs(bx)), (double)win)),
                               __dadd_rn(fmax(fabs(cy), fabs(cx)), 1.0));
  const double wi = __dadd_rn(fabs(m00), fabs(m01)), wj = __dadd_rn(fabs(m10), fabs(m11));
  const double slack = __dmul_rn(big, 0x1p-20);
  // q's slack in output rows and columns, and 2^-10 more for the fp32 cell
  // arithmetic of scatter_cells
  const double ei = __dadd_rn(__dadd_rn(__dmul_rn(slack, wi), 0x1p-30), 0x1p-10);
  const double ej = __dadd_rn(__dadd_rn(__dmul_rn(slack, wj), 0x1p-30), 0x1p-10);
  const double margin = __dadd_rn(1.0, ceil(__dmul_rn(slack, fmax(wi, wj))));
  bool finite = isfinite(margin);
  double lo_i = 0.0, hi_i = 0.0, lo_j = 0.0, hi_j = 0.0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const double dy = __dsub_rn((double)(k & 1 ? r1 + 1 : r0 - 1), cy);
    const double dx = __dsub_rn((double)(k & 2 ? c1 + 1 : c0 - 1), cx);
    const double i = __dadd_rn(__dmul_rn(m00, dy), __dmul_rn(m01, dx));
    const double j = __dadd_rn(__dmul_rn(m10, dy), __dmul_rn(m11, dx));
    finite = finite && isfinite(i) && isfinite(j);
    lo_i = k ? fmin(lo_i, i) : i;
    hi_i = k ? fmax(hi_i, i) : i;
    lo_j = k ? fmin(lo_j, j) : j;
    hi_j = k ? fmax(hi_j, j) : j;
  }
  TileGeom t;
  if (!finite) {
    t.cand = {0, 0, win, win};
    t.K = 0;
    return t;
  }
  const double top = win - 1.0;
  const double il = fmax(__dsub_rn(floor(lo_i), margin), 0.0);
  const double ih = fmin(__dadd_rn(ceil(hi_i), margin), top);
  const double jl = fmax(__dsub_rn(floor(lo_j), margin), 0.0);
  const double jh = fmin(__dadd_rn(ceil(hi_j), margin), top);
  t.cand = il > ih || jl > jh ? Box{0, 0, 0, 0}
                              : Box{(int)il, (int)jl, (int)ih - (int)il + 1, (int)jh - (int)jl + 1};
  const double span_i = __dadd_rn(wi, __dmul_rn(2.0, ei));
  const double span_j = __dadd_rn(wj, __dmul_rn(2.0, ej));
  t.K = span_i < 2.0 && span_j < 2.0 ? 2 : span_i < 3.0 && span_j < 3.0 ? 3 : 0;
  const double dy = __dsub_rn((double)(r0 - 1), cy), dx = __dsub_rn((double)(c0 - 1), cx);
  t.m00 = (float)m00;
  t.m01 = (float)m01;
  t.m10 = (float)m10;
  t.m11 = (float)m11;
  t.ib = (float)__dadd_rn(__dmul_rn(m00, dy), __dmul_rn(m01, dx));
  t.jb = (float)__dadd_rn(__dmul_rn(m10, dy), __dmul_rn(m11, dx));
  t.di_lo = (float)(fmin(m00, 0.0) + fmin(m01, 0.0) - ei);
  t.di_hi = (float)(fmax(m00, 0.0) + fmax(m01, 0.0) + ei);
  t.dj_lo = (float)(fmin(m10, 0.0) + fmin(m11, 0.0) - ej);
  t.dj_hi = (float)(fmax(m10, 0.0) + fmax(m11, 0.0) + ej);
  return t;
}

// The adjoints' two layouts. A layout says where the cotangent of output
// (i, j) lies in g and where row y of the S2 x S2 buffer lies; the tile pass
// and the clamped pass below take one as a template argument and depend on
// the layout through it alone:
//  - gc(): g's channel stride; image(n): g at image n, channel 0;
//    at(gn, i, j): the cotangent of output (i, j) of the channel at gn;
//  - first(gn, i0, j0), once per cell, and cand(g0, i, j, a, b): the cell
//    path's candidate (i, j) = (i0 + a, j0 + b), indices held as floats;
//  - output(p, i, j), flat(n, c, p): the clamped pass's enumeration of the
//    outputs in g's own order, so that neighbouring threads read
//    neighbouring words;
//  - dst(n, r0, c0).row(c, dy): row r0 + dy of channel c of image n, from
//    column c0 (r0 even).
// Interleaved: g (N, C, win, win), dx2 (N, C, S2, S2).
struct Interleaved {
  const float* __restrict__ g;
  float* __restrict__ dx2;
  int N, C, S2, win;

  struct Dst {
    float* p;
    long long plane;
    int S2;
    __device__ __forceinline__ float* row(int c, int dy) const {
      return p + c * plane + (long long)dy * S2;
    }
  };

  __device__ __forceinline__ long long gc() const { return (long long)win * win; }
  __device__ __forceinline__ const float* image(int n) const { return g + (long long)n * C * gc(); }
  __device__ __forceinline__ const float* at(const float* gn, int i, int j) const {
    return gn + (long long)i * win + j;
  }
  __device__ __forceinline__ const float* first(const float* gn, float i0, float j0) const {
    return gn + ((int)i0 * win + (int)j0);
  }
  __device__ __forceinline__ const float* cand(const float* g0, float, float, int a, int b) const {
    return g0 + a * win + b;
  }
  __device__ __forceinline__ void output(long long p, int& i, int& j) const {
    i = (int)(p / win);
    j = (int)(p % win);
  }
  __device__ __forceinline__ const float* flat(int n, int c, long long p) const {
    return g + ((long long)n * C + c) * gc() + p;
  }
  __device__ __forceinline__ Dst dst(int n, int r0, int c0) const {
    const long long plane = (long long)S2 * S2;
    return {dx2 + (long long)n * C * plane + (long long)r0 * S2 + c0, plane, S2};
  }
};

// TwoPhase: g (4, N, C, win/2, win/2), output (i, j) in quarter grid
// (i & 1) * 2 + (j & 1) at (i >> 1, j >> 1); dv0, dv1 (N, C, S2/2, S2),
// buffer row y at phase_row(y).
struct TwoPhase {
  const float* __restrict__ g;
  float* __restrict__ dv0;
  float* __restrict__ dv1;
  int N, C, S2, win;

  struct Dst {
    float* p0;
    float* p1;
    long long plane;
    int S2;
    __device__ __forceinline__ float* row(int c, int dy) const {
      return phase_row(p0, p1, c * plane, dy, S2);
    }
  };

  __device__ __forceinline__ int h2() const { return win >> 1; }
  __device__ __forceinline__ long long gc() const { return (long long)h2() * h2(); }
  __device__ __forceinline__ const float* image(int n) const { return g + (long long)n * C * gc(); }
  __device__ __forceinline__ const float* at(const float* gn, int i, int j) const {
    return gn + ((i & 1) * 2 + (j & 1)) * ((long long)N * C * gc()) +
           (long long)(i >> 1) * h2() + (j >> 1);
  }
  __device__ __forceinline__ const float* first(const float* gn, float, float) const { return gn; }
  __device__ __forceinline__ const float* cand(const float* gn, float i, float j, int, int) const {
    return at(gn, (int)i, (int)j);
  }
  __device__ __forceinline__ void output(long long p, int& i, int& j) const {
    const int q = (int)(p / gc()), r = (int)(p % gc());
    i = 2 * (r / h2()) + (q >> 1);
    j = 2 * (r % h2()) + (q & 1);
  }
  __device__ __forceinline__ const float* flat(int n, int c, long long p) const {
    const long long q = p / gc();
    return g + ((q * N + n) * C + c) * gc() + (p - q * gc());
  }
  __device__ __forceinline__ Dst dst(int n, int r0, int c0) const {
    const long long plane = (long long)(S2 / 2) * S2;
    const long long off = (long long)n * C * plane + (long long)(r0 >> 1) * S2 + c0;
    return {dv0 + off, dv1 + off, plane, S2};
  }
};

// Write a th x tw tile held with row stride SCATTER_TW in `src` (zeros when
// src is null) at rows 0 .. th - 1 of channel c of `d`, float4 stores when
// vec.
template <typename Dst>
__device__ __forceinline__ void flush(const float* src, const Dst& d, int c, int th, int tw,
                                      bool vec) {
  if (vec) {
    constexpr int Q4 = SCATTER_TW / 4;
    for (int k = threadIdx.x; k < th * Q4; k += THREADS) {
      const int r = k / Q4, col = (k % Q4) * 4;
      if (col < tw) {
        const float4 v = src ? *reinterpret_cast<const float4*>(src + r * SCATTER_TW + col)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(d.row(c, r) + col) = v;
      }
    }
  } else {
    for (int k = threadIdx.x; k < th * SCATTER_TW; k += THREADS) {
      const int r = k / SCATTER_TW, col = k % SCATTER_TW;
      if (col < tw) d.row(c, r)[col] = src ? src[r * SCATTER_TW + col] : 0.f;
    }
  }
}

// The corner sums of cell (cy, cx), the unclamped outputs p with
// floor(q_p) = (cy, cx), for channels [0, nc) of gn (at the first of them):
// s[k] = (S00, S01, S10, S11), the sums of p's terms that land on (cy, cx),
// (cy, cx + 1), (cy + 1, cx), (cy + 1, cx + 1). The cell's outputs lie in K
// consecutive rows from ceil of its least preimage row, and K columns
// likewise (tile_geom); each candidate's q is computed as the gather computes
// it and kept if it lies in [cy, cy + 1) x [cx, cx + 1) and in the buffer.
// Then floor(q) is the cell, so tap()'s weights are q - (cy, cx), and the
// terms are those of terms(). Candidates are taken row by row, so the sums
// come in a fixed order. Zero outside the buffer. Indices are held as floats
// (exact below 2^24), which keeps conversions out of the candidate loop; the
// two-phase layout converts a candidate's indices once, for its g address.
template <int K, typename L>
__device__ __forceinline__ void cell_sums(const L& lay, const float* __restrict__ gn, int nc,
                                          const float* cf, const TileGeom& tg, int r0, int c0,
                                          int cy, int cx, float (&s)[SCATTER_CH][4]) {
  const int S2 = lay.S2, win = lay.win;
  const long long oplane = lay.gc();
#pragma unroll
  for (int k = 0; k < SCATTER_CH; ++k) s[k][0] = s[k][1] = s[k][2] = s[k][3] = 0.f;
  if (cy < 0 || cx < 0 || cy >= S2 || cx >= S2) return;
  const float fy = (float)cy, fx = (float)cx, hi = (float)(S2 - 1), last = (float)(win - 1);
  const float dr = (float)(cy - r0 + 1), dc = (float)(cx - c0 + 1);
  const float ic = fmaf(tg.m01, dc, fmaf(tg.m00, dr, tg.ib));
  const float jc = fmaf(tg.m11, dc, fmaf(tg.m10, dr, tg.jb));
  const float i_lo = fmaxf(ceilf(ic + tg.di_lo), 0.f);
  const float i_hi = fminf(floorf(ic + tg.di_hi), last);
  const float j_lo = fmaxf(ceilf(jc + tg.dj_lo), 0.f);
  const float j_hi = fminf(floorf(jc + tg.dj_hi), last);
  if (i_lo > i_hi || j_lo > j_hi) return;  // the cell holds no output
  const float* g0 = lay.first(gn, i_lo, j_lo);
#pragma unroll
  for (int a = 0; a < K; ++a) {
#pragma unroll
    for (int b = 0; b < K; ++b) {
      const float i = i_lo + a, j = j_lo + b;
      if (i > i_hi || j > j_hi) continue;
      const Q q = coords(cf, i, j);
      const bool in_y = q.y >= fy && q.y < fy + 1.f && q.y <= hi;
      if (!(in_y && q.x >= fx && q.x < fx + 1.f && q.x <= hi)) continue;
      Tap t;  // tap_at(q)'s weights: q is inside and floor(q) = (cy, cx)
      t.wy1 = __fsub_rn(q.y, fy);
      t.wx1 = __fsub_rn(q.x, fx);
      t.wy0 = __fsub_rn(1.f, t.wy1);
      t.wx0 = __fsub_rn(1.f, t.wx1);
      const float* gp = lay.cand(g0, i, j, a, b);
#pragma unroll
      for (int k = 0; k < SCATTER_CH; ++k) {
        if (k < nc) {
          const Terms v = terms(t, __ldg(gp + k * oplane));
          s[k][0] = __fadd_rn(s[k][0], v.v00);
          s[k][1] = __fadd_rn(s[k][1], v.v01);
          s[k][2] = __fadd_rn(s[k][2], v.v10);
          s[k][3] = __fadd_rn(s[k][3], v.v11);
        }
      }
    }
  }
}

// The cell path of one warp: pixel rows [y0, y0 + rows) of the tile at
// (r0, c0), tw columns wide (gn at the image's channel 0, d at the tile's
// origin), without atomics and in a fixed order. Lane l takes cell column
// c0 + l and walks the cell rows y0 - 1 .. y0 + rows - 1; the boundary
// column c0 - 1 is computed first, cell row y0 - 1 + l on lane l.
// Pixel (y, x) adds the corner sums of its four cells,
//   ((S00(y, x) + S01(y, x - 1)) + S10(y - 1, x)) + S11(y - 1, x - 1),
// the left ones by shuffle from the lane to the left (or the boundary), the
// upper ones from the row before, and each warp stores its pixel rows along
// the row: SCATTER_CH channels a pass.
template <int K, typename L>
__device__ void scatter_cells(L lay, const float* __restrict__ gn, typename L::Dst d,
                              const float* cf, const TileGeom& tg, int r0, int c0, int y0,
                              int rows, int tw) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, C = lay.C;
  const long long oplane = lay.gc();
  for (int cg = 0; cg < C; cg += SCATTER_CH) {
    const int nc = min(SCATTER_CH, C - cg);
    const float* gc = gn + (long long)cg * oplane;
    // the boundary column's S01 and S11, and the previous cell row's S10 and S11
    float edge01[SCATTER_CH], edge11[SCATTER_CH], up10[SCATTER_CH], up11[SCATTER_CH];
    float s[SCATTER_CH][4];
    cell_sums<K>(lay, gc, nc, cf, tg, r0, c0, lane <= rows ? y0 - 1 + lane : -1, c0 - 1, s);
#pragma unroll
    for (int k = 0; k < SCATTER_CH; ++k) {
      edge01[k] = s[k][1];
      edge11[k] = s[k][3];
      up10[k] = up11[k] = 0.f;
    }
    for (int rr = 0; rr <= rows; ++rr) {  // cell row y0 - 1 + rr, pixel row y0 - 1 + rr
      const int cy = y0 - 1 + rr;
      cell_sums<K>(lay, gc, nc, cf, tg, r0, c0, cy, c0 + lane, s);
#pragma unroll
      for (int k = 0; k < SCATTER_CH; ++k) {
        float left01 = __shfl_up_sync(full, s[k][1], 1);
        float left11 = __shfl_up_sync(full, up11[k], 1);
        const float e01 = __shfl_sync(full, edge01[k], rr);
        const float e11 = __shfl_sync(full, edge11[k], max(rr - 1, 0));
        if (lane == 0) {
          left01 = e01;
          left11 = rr ? e11 : 0.f;
        }
        const float v = __fadd_rn(__fadd_rn(__fadd_rn(s[k][0], left01), up10[k]), left11);
        if (rr && k < nc && lane < tw) d.row(cg + k, cy - r0)[lane] = v;
        up10[k] = s[k][2];
        up11[k] = s[k][3];
      }
    }
  }
}

// The fallback of one tile, for maps whose cells need a window wider than 3
// (strong zoom-in, singular maps): channel by channel, every candidate's
// terms that land in the tile added to acc with shared atomics (g read
// through L1), then acc flushed.
template <typename L>
__device__ void scatter_atomic(L lay, const float* __restrict__ gn, typename L::Dst d,
                               const float* cf, Box cand, int r0, int c0, int th, int tw,
                               bool dvec, float* acc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, S2 = lay.S2;
  const long long oplane = lay.gc();
  const int runs = (cand.w + 31) / 32;  // each candidate row in runs of 32 columns
  for (int c = 0; c < lay.C; ++c) {
    for (int k = threadIdx.x; k < SCATTER_TH * SCATTER_TW; k += THREADS) acc[k] = 0.f;
    __syncthreads();
    const float* gc = gn + c * oplane;
    for (int it = warp; it < cand.h * runs; it += WARPS) {
      const int i = cand.r0 + it / runs, j = cand.c0 + (it % runs) * 32 + lane;
      if (j >= cand.c0 + cand.w) continue;
      const Q q = coords(cf, i, j);
      if (!inside(q, S2)) continue;
      const int fy = (int)floorf(q.y), fx = (int)floorf(q.x);
      if (fy < r0 - 1 || fy >= r0 + th || fx < c0 - 1 || fx >= c0 + tw) continue;
      const float gv = __ldg(lay.at(gc, i, j));
      if (gv == 0.f) continue;
      // rows y0 = fy and y1 lie in [r0 - 1, r0 + th], columns likewise
      const Tap t = tap_at(q, S2);
      const Terms v = terms(t, gv);
      const int ry0 = t.y0 - r0, ry1 = t.y1 - r0, rx0 = t.x0 - c0, rx1 = t.x1 - c0;
      const bool in_y0 = ry0 >= 0, in_y1 = ry1 < th, in_x0 = rx0 >= 0, in_x1 = rx1 < tw;
      if (in_y0 && in_x0) add_shared(acc + ry0 * SCATTER_TW + rx0, v.v00);
      if (in_y0 && in_x1) add_shared(acc + ry0 * SCATTER_TW + rx1, v.v01);
      if (in_y1 && in_x0) add_shared(acc + ry1 * SCATTER_TW + rx0, v.v10);
      if (in_y1 && in_x1) add_shared(acc + ry1 * SCATTER_TW + rx1, v.v11);
    }
    __syncthreads();
    flush(acc, d, c, th, tw, dvec);
    __syncthreads();  // acc flushed before the next channel zeroes it
  }
}

// The tile pass of layout L: persistent blocks over the N x ceil(S2 /
// SCATTER_TH) x ceil(S2 / SCATTER_TW) tiles of the S2 x S2 buffer (column
// fastest, then row, then image), block b taking tiles b, b + gridDim.x,
// ...; every pixel written once (the outputs with a clamped coordinate are
// left to the clamped pass). Warp 0 computes the geometry of the block's
// next 32 tiles at once, one per lane. A tile that no output reaches is
// written as zeros; on the cell path (window K of 2 or 3) each warp takes
// SCATTER_ROWS pixel rows of the tile on its own, with no barrier; the
// others take the fallback. dvec: S2 a multiple of 4 and the buffer (both
// planes) 16-byte aligned.
template <typename L>
__device__ __forceinline__ void scatter_tiles(L lay, const float* __restrict__ coef, bool dvec) {
  __shared__ __align__(16) float acc[SCATTER_TH * SCATTER_TW];  // the fallback's sums
  __shared__ TileGeom geo[32];
  const int warp = threadIdx.x >> 5;
  const int S2 = lay.S2, win = lay.win;
  const int cols = (S2 + SCATTER_TW - 1) / SCATTER_TW;
  const int per_image = (S2 + SCATTER_TH - 1) / SCATTER_TH * cols, tiles = lay.N * per_image;
  for (int base = blockIdx.x; base < tiles; base += 32 * gridDim.x) {
    if (threadIdx.x < 32) {
      const int tile = base + threadIdx.x * gridDim.x;
      if (tile < tiles) {
        const int n = tile / per_image, t = tile % per_image;
        const int r0 = t / cols * SCATTER_TH, c0 = t % cols * SCATTER_TW;
        float cf[6];
        load_coef(coef, n, cf);
        geo[threadIdx.x] = tile_geom(cf, r0, min(r0 + SCATTER_TH, S2) - 1, c0,
                                     min(c0 + SCATTER_TW, S2) - 1, win);
      }
    }
    __syncthreads();
    for (int k = 0; k < 32; ++k) {
      const int tile = base + k * gridDim.x;
      if (tile >= tiles) break;
      const int n = tile / per_image, t = tile % per_image;
      const int r0 = t / cols * SCATTER_TH, c0 = t % cols * SCATTER_TW;
      const int th = min(SCATTER_TH, S2 - r0), tw = min(SCATTER_TW, S2 - c0);
      const typename L::Dst d = lay.dst(n, r0, c0);
      const TileGeom& tg = geo[k];
      if (tg.cand.h <= 0 || tg.cand.w <= 0) {  // no output reaches this tile
        for (int c = 0; c < lay.C; ++c) flush(nullptr, d, c, th, tw, dvec);
        continue;
      }
      float cf[6];
      load_coef(coef, n, cf);
      const float* gn = lay.image(n);
      const int y0 = r0 + warp * SCATTER_ROWS, strip = min(SCATTER_ROWS, r0 + th - y0);
      if (tg.K == 2) {
        if (strip > 0) scatter_cells<2>(lay, gn, d, cf, tg, r0, c0, y0, strip, tw);
      } else if (tg.K == 3) {
        if (strip > 0) scatter_cells<3>(lay, gn, d, cf, tg, r0, c0, y0, strip, tw);
      } else {
        scatter_atomic(lay, gn, d, cf, tg.cand, r0, c0, th, tw, dvec, acc);
      }
    }
    __syncthreads();  // every thread is done with geo before warp 0 refills it
  }
}

// The clamped pass of layout L, grid (CLAMP_BLOCKS, N), after the tile pass
// on the stream: adds the outputs with a clamped coordinate onto the buffer
// with atomicAdd. q is monotone in i and j, so only an image whose
// output-grid corners leave [0, S2 - 1] has such outputs; the blocks of
// every other image return at once.
template <typename L>
__device__ __forceinline__ void scatter_clamped(L lay, const float* __restrict__ coef) {
  const int n = blockIdx.y, e = lay.win - 1, S2 = lay.S2;
  float cf[6];
  load_coef(coef, n, cf);
  if (inside(coords(cf, 0, 0), S2) && inside(coords(cf, 0, e), S2) &&
      inside(coords(cf, e, 0), S2) && inside(coords(cf, e, e), S2)) {
    return;
  }
  const typename L::Dst d = lay.dst(n, 0, 0);
  const long long outputs = (long long)lay.win * lay.win;
  for (long long p = (long long)blockIdx.x * THREADS + threadIdx.x; p < outputs;
       p += (long long)gridDim.x * THREADS) {
    int i, j;
    lay.output(p, i, j);
    const Q q = coords(cf, i, j);
    if (inside(q, S2)) continue;
    const Tap t = tap_at(q, S2);
    for (int c = 0; c < lay.C; ++c) {
      const float gv = __ldg(lay.flat(n, c, p));
      if (gv == 0.f) continue;
      spread(d.row(c, t.y0), d.row(c, t.y1), t, gv);
    }
  }
}

// The interleaved adjoint: grid (min(tiles, SMs * SCATTER_BLOCKS), 1, 1);
// g (N, C, win, win), dx2 (N, C, S2, S2).
__global__ void __launch_bounds__(THREADS, SCATTER_BLOCKS)
scatter_kernel(const float* __restrict__ g, const float* __restrict__ coef,
               float* __restrict__ dx2, int N, int C, int S2, int win, bool dvec) {
  scatter_tiles(Interleaved{g, dx2, N, C, S2, win}, coef, dvec);
}

// grid (CLAMP_BLOCKS, N), after scatter_kernel on the stream
__global__ void __launch_bounds__(THREADS)
scatter_clamped_kernel(const float* __restrict__ g, const float* __restrict__ coef,
                       float* __restrict__ dx2, int C, int S2, int win) {
  scatter_clamped(Interleaved{g, dx2, (int)gridDim.y, C, S2, win}, coef);
}

// The two-phase adjoint: grid as scatter_kernel; g (4, N, C, win/2, win/2),
// dv0, dv1 (N, C, S2/2, S2).
__global__ void __launch_bounds__(THREADS, SCATTER_BLOCKS)
scatter2_kernel(const float* __restrict__ g, const float* __restrict__ coef,
                float* __restrict__ dv0, float* __restrict__ dv1, int N, int C, int S2, int win,
                bool dvec) {
  scatter_tiles(TwoPhase{g, dv0, dv1, N, C, S2, win}, coef, dvec);
}

// grid (CLAMP_BLOCKS, N), after scatter2_kernel on the stream
__global__ void __launch_bounds__(THREADS)
scatter2_clamped_kernel(const float* __restrict__ g, const float* __restrict__ coef,
                        float* __restrict__ dv0, float* __restrict__ dv1, int C, int S2,
                        int win) {
  scatter_clamped(TwoPhase{g, dv0, dv1, (int)gridDim.y, C, S2, win}, coef);
}

bool aligned16(const void* p) { return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0; }

// The gathers' grid: one block per GATHER_TH x GATHER_TW output tile.
dim3 gather_grid(int N, int win) {
  return dim3((unsigned)((win + GATHER_TW - 1) / GATHER_TW),
              (unsigned)((win + GATHER_TH - 1) / GATHER_TH), (unsigned)N);
}

// The adjoints' tile-pass grid: one persistent block per tile, at most
// SCATTER_BLOCKS per SM.
cudaError_t tile_blocks(int N, int S2, unsigned* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tiles = (long long)N * ((S2 + SCATTER_TH - 1) / SCATTER_TH) *
                          ((S2 + SCATTER_TW - 1) / SCATTER_TW);
  *blocks = (unsigned)std::min<long long>(tiles, (long long)sms * SCATTER_BLOCKS);
  return err;
}

}  // namespace

// Every entry point launches on `stream` (PyTorch's current stream), takes
// contiguous fp32 buffers, and returns cudaGetLastError() so the caller can
// raise on a refused launch.
extern "C" int affine_warp_gather(const float* x2, const float* coef, float* out,
                                  int N, int C, int S2, int win, void* stream) {
  if ((long long)N * C * win == 0) return (int)cudaGetLastError();
  if (N > 65535) return (int)cudaErrorInvalidValue;
  gather_kernel<<<gather_grid(N, win), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x2, coef, out, C, S2, win, (S2 & 3) == 0 && aligned16(x2));
  return (int)cudaGetLastError();
}

// dx2 is written whole by the tile pass (no memset); the clamped-output
// pass follows it on the stream.
extern "C" int affine_warp_scatter(const float* g, const float* coef, float* dx2,
                                   int N, int C, int S2, int win, void* stream) {
  if ((long long)N * C * S2 == 0) return (int)cudaGetLastError();
  if (N > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned blocks = 0;
  cudaError_t err = tile_blocks(N, S2, &blocks);
  if (err != cudaSuccess) return (int)err;
  scatter_kernel<<<blocks, THREADS, 0, s>>>(g, coef, dx2, N, C, S2, win,
                                            (S2 & 3) == 0 && aligned16(dx2));
  err = cudaGetLastError();
  if (err != cudaSuccess || win == 0) return (int)err;
  scatter_clamped_kernel<<<dim3(CLAMP_BLOCKS, (unsigned)N), THREADS, 0, s>>>(
      g, coef, dx2, C, S2, win);
  return (int)cudaGetLastError();
}

// The two-phase pair: S2 and win even; v0, v1, dv0, dv1 (N, C, S2/2, S2);
// out and g (4, N, C, win/2, win/2).
extern "C" int affine_warp2_gather(const float* v0, const float* v1, const float* coef,
                                   float* out, int N, int C, int S2, int win, void* stream) {
  if ((S2 | win) & 1) return (int)cudaErrorInvalidValue;
  if ((long long)N * C * win == 0) return (int)cudaGetLastError();
  if (N > 65535) return (int)cudaErrorInvalidValue;
  gather2_kernel<<<gather_grid(N, win), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      v0, v1, coef, out, N, C, S2, win, (S2 & 3) == 0 && aligned16(v0) && aligned16(v1));
  return (int)cudaGetLastError();
}

// Both planes are written whole by the tile pass (no memset); the
// clamped-output pass follows it on the stream.
extern "C" int affine_warp2_scatter(const float* g, const float* coef, float* dv0, float* dv1,
                                    int N, int C, int S2, int win, void* stream) {
  if ((S2 | win) & 1) return (int)cudaErrorInvalidValue;
  if ((long long)N * C * S2 == 0) return (int)cudaGetLastError();
  if (N > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned blocks = 0;
  cudaError_t err = tile_blocks(N, S2, &blocks);
  if (err != cudaSuccess) return (int)err;
  scatter2_kernel<<<blocks, THREADS, 0, s>>>(
      g, coef, dv0, dv1, N, C, S2, win, (S2 & 3) == 0 && aligned16(dv0) && aligned16(dv1));
  err = cudaGetLastError();
  if (err != cudaSuccess || win == 0) return (int)err;
  scatter2_clamped_kernel<<<dim3(CLAMP_BLOCKS, (unsigned)N), THREADS, 0, s>>>(
      g, coef, dv0, dv1, C, S2, win);
  return (int)cudaGetLastError();
}
