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
//   10   fir24x_up4     1x24  4,1     1,1       StyleGAN3-T x up-pass, float32 only (64,256,150,150)
//   11   fir24y_up4     24x1  1,4     1,1       StyleGAN3-T y up-pass, float32 only (64,256,150,562)
//   0    generic        any   any     any       anything else, channels-last included
//
// Instances 1-8 on float32, and 2-8 on bfloat16, are fir_kernel; its design
// against the bytes bound:
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
// Instances 10 and 11 are fir_up4x_kernel and fir_up4y_kernel, the 24-tap
// up-4 passes of StyleGAN3-T's filtered leaky ReLU (the crops (-6, -9) of
// its L3, L5, L7 and L10). Their outputs are four times their inputs, so
// the bound is mostly the write. Polyphase, as fir_kernel at up 2, with the
// taps, the factor and the loops fixed at compile time:
// - x pass: lane l owns the four phases of one input position, four
//   consecutive outputs from 7 input columns (6 taps each: the 18 taps
//   that would hit stuffed zeros are dropped at compile time), stored as
//   one 16-byte vector where the four are aligned (two 8-byte ones where
//   they are 8-byte aligned, as every other row of an output of width 2
//   mod 4 is); a pad that is not a multiple of 4 shifts the tiling by
//   -pad mod 4 outputs, as an odd pad shifts fir_kernel's at up 2. A
//   thread walks R rows of its column, all their loads started together;
// - y pass: lane l owns two adjacent columns, one 8-byte load and store a
//   row where the pair is so aligned (every row of an even width), so every
//   load and store is coalesced; a thread owns R output rows, R a multiple
//   of 4, and reads each of its (R + 22) / 4 + 1 input rows once into a
//   register, from which all four phases take it;
// - no shared memory, no barrier: one warp per (plane, row band, column
//   tile), the bands of a column tile in one block, so that the input rows
//   two bands of the y pass share are read from L1.
// The products of an output are summed in the order of the generic tile
// body (input rows, then columns, ascending), from 0.
// fp32 accumulation in every instance; T is float or bfloat16.
//
// Instance 1 on bfloat16 (the 4x4 blurs of a --bf16 step) is
// fir_vec_kernel. fir_kernel's lane issues one 2-byte load per input column
// and row, and KW lanes load each column again: a warp's load moves 64
// bytes where an fp32 one moves 128 for the same instructions, so bf16 ran
// no faster than fp32 with half the bytes. Bound: bytes, (N*C*H*W +
// N*C*OH*OW) * 2 at 3.35 TB/s (0.1609 ms on the 256 px G upsample blur,
// (16, 128, 257, 257) -> (16, 128, 256, 256)). The design:
// - lane l owns V = 8 adjacent output columns and reads the row segment
//   they need with aligned 16-byte loads (uint4, 8 values):
//   the chunk at or below the segment's first element and the next ones
//   the segment reaches (2-3 a row). Rows of odd width start at alternating
//   alignments, so the segment is shifted into place in registers by its
//   offset s in the chunk: two selects by s / 2 words, one byte permute by
//   s % 2 (shift_pairs); no run-time index, so no local memory. A lane
//   whose chunks could leave the tensor (the first and last rows of the
//   tensor) clamps them to its first or last chunk (their values lie
//   outside the row); columns outside the row are masked to zero with
//   per-lane word masks;
// - rows as in fir_kernel: R output rows a lane, each input row loaded once
//   and one row ahead of its use, converted to fp32 once, and kept while an
//   output row needs it (a window of KH rows, row r in slot r % KH); each
//   output row is summed when its last input row arrives, in fir_kernel's
//   order (input rows ascending, then columns ascending: ky-major, then
//   kx), from 0 in fp32 and rounded to bfloat16 once, so the result is
//   fir_kernel's bit for bit. The rows are a loop of KH-row steps, not
//   unrolled: the fully unrolled 16-row body was ~170 KB of code, past the
//   instruction cache;
// - tiling: a row of 2^k + 1 outputs (the pad (2, 2) outputs and the G
//   blur's backward) gives its last lane one more output, where a tile of
//   its own would cost a whole warp for one column; a row narrower than a
//   warp's 32 runs shares the warp with other (plane, band) tasks, so 128
//   and 129 px rows keep every lane busy;
// - stores: every V-element chunk of the output row that lies inside the
//   lane's group is written whole by one lane, its values gathered from
//   that lane and the next (one shuffle, then shift_pairs); at most V
//   outputs at each end of the group's run are written as scalars, by its
//   first lane and its last two. Row bounds are kept in the lane's own
//   32-bit coordinates. No TMA and no 16-byte cp.async: rows of odd width
//   have no 16-byte stride.
// Instances 2 and 3 on bfloat16 (~6 us a call, about a launch's cost) stay
// on fir_kernel: this scheme made them slower.
//
// The generic instance takes contiguous NCHW input and anything the
// families do not, in two bodies. Channels-last input and output whose
// channel vectors are 16-byte aligned (C * sizeof(T) a multiple of 16, the
// NHWC layout of the JAX package's _fir2d_nhwc #2 and _fir2d_pair #3) take
// fir_cl_kernel: the lanes of a warp hold consecutive 16-byte channel
// vectors (4 fp32 or 8 bf16 values) of consecutive output pixels, so every
// load and store is one coalesced 16-byte access, and a thread walks
// CL_R output rows of one output column. Bound: bytes, one read of the
// input and one write of the output (0.3218 ms fp32 and 0.1609 ms bf16 on
// the channels-last 256 px G upsample blur). Taps, up and down are read at
// run time: each output reads the input pixels of the taps that land on
// real pixels (first_tap skips the stuffed zeros), the kh - 1 rows shared
// with the thread's next output row and the kw - 1 columns shared with the
// neighbouring warps from L1. That is 16 loads an output at 4x4 and up =
// down = 1 (#2's shape), where it ran at 0.39 of the bound on an H100; there
// fir_cl_fixed_kernel, with the sizes fixed at compile time, loads each
// input pixel once per thread and adds it into every output row it feeds
// (CL_R + 3 input rows for CL_R output rows), at 0.70. Anything else (NCHW
// with other taps, up 3, channels-last with C * sizeof(T) not a multiple of
// 16) keeps the first design: a block computes a 32x32 output
// tile of one plane from an input window staged in shared memory, with kh,
// kw, up and down read at run time and strides carrying the layout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

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
// Instance 1 on bfloat16: fir_vec_kernel
// ---------------------------------------------------------------------------
constexpr int VEC_BYTES = 16;  // one aligned load: 8 bfloat16 values
constexpr int V = VEC_BYTES / 2;  // output columns a lane, and values a load

// The tensors as aligned chunks: x_off and y_off are the elements between
// the pointer rounded down to VEC_BYTES and element 0, x_last the last
// chunk that holds an element of x. Element indices below count from the
// rounded-down pointers.
struct VecSpan {
  long long x_off, x_last, y_off;
};

// f(std::integral_constant<int, I>{}) for I = B .. E - 1, unrolled at compile
// time: the loop index is a constant expression in f.
template <int B, int E, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (B < E) {
    f(std::integral_constant<int, B>{});
    static_for<B + 1, E>(f);
  }
}

// dst[j] = the bfloat16 pair at elements s + 2j, s + 2j + 1 of src (element
// e is the low half of word e / 2 when e is even, the high half when it is
// odd), for s in [0, 8): two selects by the word offset s / 2, then one byte
// permute by s % 2. Nothing is indexed by a run-time value, so src and dst
// stay in registers.
template <int NIN, int NOUT>
__device__ __forceinline__ void shift_pairs(const unsigned (&src)[NIN], int s,
                                            unsigned (&dst)[NOUT]) {
  static_assert(NIN >= NOUT + 4, "shift_pairs reads NOUT + 4 words");
  const bool by4 = s & 4, by2 = s & 2;
  const unsigned sel = (s & 1) ? 0x5432u : 0x3210u;
  unsigned t[NOUT + 2], u[NOUT + 1];
#pragma unroll
  for (int k = 0; k < NOUT + 2; ++k) t[k] = by4 ? src[k + 2] : src[k];
#pragma unroll
  for (int k = 0; k < NOUT + 1; ++k) u[k] = by2 ? t[k + 1] : t[k];
#pragma unroll
  for (int j = 0; j < NOUT; ++j) dst[j] = __byte_perm(u[j], u[j + 1], sel);
}

// The NV chunks of one input row whose element at column ix0 sits at byte
// address `at`, as words: chunk k only where the row's NX elements reach it
// (the rest read as 0). `safe`: every chunk the lane reads lies inside the
// tensor; otherwise each chunk is clamped to the tensor's chunks [xv,
// xv + x_last] (what a clamped chunk holds lies outside the row, and the
// caller masks it).
template <int NX, int NV>
__device__ __forceinline__ void load_chunks(const char* at, bool safe, const uint4* xv,
                                            long long x_last, unsigned (&w)[4 * NV]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(at);
  const int s = (int)((a >> 1) & 7);
  const uint4* c = reinterpret_cast<const uint4*>(a & ~(uintptr_t)(VEC_BYTES - 1));
  const long long i0 = c - xv;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    uint4 q = make_uint4(0u, 0u, 0u, 0u);
    if (V * k <= s + NX - 1) {
      if (safe) {
        q = __ldg(c + k);
      } else {
        const long long i = i0 + k;
        q = __ldg(xv + (i < 0 ? 0 : (i > x_last ? x_last : i)));
      }
    }
    w[4 * k] = q.x;
    w[4 * k + 1] = q.y;
    w[4 * k + 2] = q.z;
    w[4 * k + 3] = q.w;
  }
}

// Two fp32 values as one word of bfloat16 pairs (round to nearest even, as
// __float2bfloat16).
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// One output row of a lane's group. yl points at the lane's output 0 in
// this row; the lane holds outputs 0 .. V - 1 as bf16 pairs (pk), and the
// last lane of a row that leaves one column over also output V (`extra`,
// in the low half of xw). The group's outputs in this row are [a, b) in the
// lane's own coordinates (empty for a lane or row without outputs). Each
// V-element chunk inside [a, b) is stored whole by the lane whose run it
// ends in, its values gathered from that lane and the next (or the extra
// output); the outputs before the first such chunk and after the last, at
// most V at each end and only in lanes that `edge` marks (the first lane of
// a group and its last two, or the row's last two), as scalars. Every lane of the warp takes part
// (the shuffle).
template <bool EXTRA>
__device__ __forceinline__ void store_row(__nv_bfloat16* yl, const unsigned (&pk)[V / 2],
                                          bool extra, unsigned xw, int a, int b, bool edge) {
  constexpr int VW = V / 2;
  const int so = (int)((reinterpret_cast<uintptr_t>(yl) >> 1) & (V - 1));
  unsigned out[VW];
  if (__any_sync(0xffffffffu, so != 0)) {
    unsigned src[VW + 4];
#pragma unroll
    for (int k = 0; k < VW; ++k) {
      src[k] = pk[k];
      const unsigned next = __shfl_down_sync(0xffffffffu, pk[k], 1);
      src[VW + k] = EXTRA && extra ? (k == 0 ? xw : 0u) : next;
    }
#pragma unroll
    for (int k = 2 * VW; k < VW + 4; ++k) src[k] = 0u;
    shift_pairs<VW + 4, VW>(src, so == 0 ? 0 : V - so, out);
  } else {
#pragma unroll
    for (int k = 0; k < VW; ++k) out[k] = pk[k];
  }
  const int c0 = so == 0 ? 0 : V - so;  // this lane's chunk, aligned
  if (c0 >= a && c0 + V <= b)
    *reinterpret_cast<uint4*>(yl + c0) = make_uint4(out[0], out[1], out[2], out[3]);
  if (edge) {
    // whole chunks cover [lo_al, hi_al) of [a, b)
    const int lo_al = a + ((-(so + a)) & (V - 1));
    int hi_al = b - ((so + b) & (V - 1));
    if (hi_al < lo_al) hi_al = lo_al;
    unsigned short* ys = reinterpret_cast<unsigned short*>(yl);
#pragma unroll
    for (int f = 0; f < V + EXTRA; ++f) {
      if (f >= a && f < b && (f < lo_al || f >= hi_al) && (f < V || extra))
        ys[f] = (unsigned short)((f < V ? pk[f >> 1] >> (16 * (f & 1)) : xw) & 0xffffu);
    }
  }
}

// Output tiling of fir_vec_kernel. A row of an output plane is `runs` runs
// of V columns, lane by lane; when the row leaves one column over (widths
// of 2^k + 1: the pad (2, 2) outputs and the G blur's backward), the last
// lane takes it too (the kernel's EXTRA), where a tile of its own would
// cost a whole warp. A column tile is 32 runs. When one tile holds the row,
// a warp holds `groups` tasks of `cw` lanes, a task being (plane, band of R
// rows), numbered band fastest; otherwise a warp holds one task of one tile.
// `edges`: whether any row can need scalar stores (it cannot when every row
// starts on a chunk and is whole chunks long).
struct VecTiling {
  int runs, tx, cw, groups, ty, edges;
  long long tasks;  // planes * ty
};

// Taps (KH, KW) fixed, up = down = 1; R output rows and V output columns
// a lane (V + 1 for the last lane of a row when EXTRA). Input row r lives
// in slot r % KH of the window; each row's loads go out one row ahead of
// its use. The rows are a loop of KH-row steps (the slots return every KH
// rows), which keeps the code within the instruction cache.
template <int KH, int KW, int R, bool EXTRA>
__global__ void __launch_bounds__(32 * WARPS, 2)
fir_vec_kernel(const uint4* __restrict__ xv, __nv_bfloat16* __restrict__ y,
               const float* __restrict__ taps, Params p, VecTiling vt, VecSpan sp) {
  static_assert(R % KH == 0, "row steps");
  constexpr int VE = V + EXTRA;         // outputs a lane computes
  constexpr int NX = VE + KW - 1;       // input columns a lane reads
  constexpr int NW = (NX + 1) / 2;      // ... as bf16 pairs
  constexpr int NV = (NW + 4 + 3) / 4;  // aligned chunks a row
  constexpr int NY = R + KH - 1;        // input rows a lane reads

  const long long warp = (long long)blockIdx.x * WARPS + threadIdx.y;
  const int col = (int)(warp % vt.tx);
  const long long task0 = warp / vt.tx * vt.groups;
  if (task0 >= vt.tasks) return;  // the whole warp
  const int lane = threadIdx.x;
  const int grp = lane / vt.cw, cl = lane % vt.cw, run = col * 32 + cl;
  const long long task = task0 + grp;
  // a lane with outputs; the others take part in the shuffles only
  const bool live = grp < vt.groups && task < vt.tasks && run < vt.runs;
  const long long z = live ? task / vt.ty : 0;
  const int band = live ? (int)(task % vt.ty) : 0;
  const bool extra = EXTRA && live && run == vt.runs - 1;
  const bool edge = vt.edges && (cl == 0 || cl >= vt.cw - 2 || run >= vt.runs - 2);
  const int ox0 = run * V, oy0 = band * R;
  const int ix0 = ox0 - p.p_x0, iy0 = oy0 - p.p_y0;
  // the group's outputs of each row, in the lane's coordinates
  const int out_a = col * 32 * V - ox0;
  int out_b = (col * 32 + vt.cw) * V + (EXTRA && col == vt.tx - 1 ? 1 : 0);
  out_b = (out_b < p.OW ? out_b : p.OW) - ox0;
  if (!live) out_b = out_a;

  float tf[KH][KW];  // flipped, as fir_kernel
#pragma unroll
  for (int ky = 0; ky < KH; ++ky)
#pragma unroll
    for (int kx = 0; kx < KW; ++kx) tf[ky][kx] = __ldg(taps + (KH - 1 - ky) * KW + (KW - 1 - kx));
  unsigned keep[NW];  // the halves of each input pair that lie inside the row
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const bool lo = (unsigned)(ix0 + 2 * j) < (unsigned)p.W;
    const bool hi = 2 * j + 1 < NX && (unsigned)(ix0 + 2 * j + 1) < (unsigned)p.W;
    keep[j] = (lo ? 0x0000ffffu : 0u) | (hi ? 0xffff0000u : 0u);
  }

  // byte address of input (row iy0, column ix0) and of output (oy0, ox0)
  const long long gx = sp.x_off + z * p.H * p.W + (long long)iy0 * p.W + ix0;
  const char* xr = reinterpret_cast<const char*>(xv) + 2 * gx;
  const long long xs = 2LL * p.W;  // row strides in bytes
  __nv_bfloat16* yr = y + sp.y_off + z * p.OH * p.OW + (long long)oy0 * p.OW + ox0;
  // whether every chunk of the lane's rows inside the plane lies inside the
  // tensor (all but the first and last rows of the tensor)
  const int r_lo = iy0 < 0 ? -iy0 : 0;
  const int r_hi = (iy0 + NY - 1 < p.H ? NY - 1 : p.H - 1 - iy0);
  const bool safe = ((gx + (long long)r_lo * p.W) >> 3) >= 0 &&
                    ((gx + (long long)r_hi * p.W) >> 3) + NV - 1 <= sp.x_last;

  unsigned raw[KH][4 * NV];  // input row r's chunks, in slot r % KH
  float v[KH][NX];           // input row r, masked, in fp32, in slot r % KH
  auto row_in = [&](int r) { return live && (unsigned)(iy0 + r) < (unsigned)p.H; };
  auto load = [&](int r, auto slot) {
    if (row_in(r))
      load_chunks<NX, NV>(xr + r * xs, safe, xv, sp.x_last, raw[decltype(slot)::value]);
  };
  auto extract = [&](int r, auto slot) {
    constexpr int k = decltype(slot)::value;
    if (row_in(r)) {
      unsigned pr[NW];
      shift_pairs<4 * NV, NW>(raw[k], (int)((reinterpret_cast<uintptr_t>(xr + r * xs) >> 1) & 7),
                              pr);
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        const unsigned m = pr[j] & keep[j];
        v[k][2 * j] = __uint_as_float(m << 16);
        if (2 * j + 1 < NX) v[k][2 * j + 1] = __uint_as_float(m & 0xffff0000u);
      }
    } else {
#pragma unroll
      for (int c = 0; c < NX; ++c) v[k][c] = 0.f;
    }
  };
  // output row e from input rows K .. K + KH - 1 of the step (slot r2 % KH),
  // input (r2, c) feeding output (e, f) through tap (r2 - K, c - f), in
  // fir_kernel's order
  auto emit = [&](int e, auto first) {
    constexpr int K = decltype(first)::value;
    float acc[VE];
#pragma unroll
    for (int f = 0; f < VE; ++f) acc[f] = 0.f;
#pragma unroll
    for (int r2 = K; r2 < K + KH; ++r2) {
#pragma unroll
      for (int f = 0; f < VE; ++f)
#pragma unroll
        for (int c = 0; c < NX; ++c) {
          const int kx = c - f;
          if (kx >= 0 && kx < KW) acc[f] += tf[r2 - K][kx] * v[r2 % KH][c];
        }
    }
    unsigned pk[V / 2];
#pragma unroll
    for (int k = 0; k < V / 2; ++k) pk[k] = pack_bf16x2(acc[2 * k], acc[2 * k + 1]);
    const bool row = (unsigned)(oy0 + e) < (unsigned)p.OH;
    store_row<EXTRA>(yr + (long long)e * p.OW, pk, extra, pack_bf16x2(acc[VE - 1], 0.f),
                        out_a, row ? out_b : out_a, edge);
  };
  using std::integral_constant;
  // rows 0 .. KH - 2 fill the window; then each step of KH rows emits KH
  // outputs, output e from rows e .. e + KH - 1
  load(0, integral_constant<int, 0>{});
  static_for<0, KH - 1>([&](auto ri) {
    constexpr int r = decltype(ri)::value;
    load(r + 1, integral_constant<int, (r + 1) % KH>{});
    extract(r, integral_constant<int, r % KH>{});
  });
#pragma unroll 1
  for (int e0 = 0; e0 < R; e0 += KH) {
    static_for<0, KH>([&](auto ki) {
      constexpr int k = decltype(ki)::value;
      const int r = e0 + KH - 1 + k;
      if (r + 1 < NY) load(r + 1, integral_constant<int, k % KH>{});
      extract(r, integral_constant<int, (KH - 1 + k) % KH>{});
      // rows e0 + k .. e0 + k + KH - 1 sit in the slots of rows k .. k + KH - 1
      emit(e0 + k, integral_constant<int, k>{});
    });
  }
}

template <int KH, int KW, int R>
cudaError_t launch_vec(const void* x, void* y, const float* taps, const Params& p,
                       cudaStream_t s) {
  VecTiling vt;
  const bool extra = p.OW % V == 1 && p.OW > 1;
  vt.runs = (p.OW - extra + V - 1) / V;
  vt.tx = (vt.runs + 31) / 32;
  vt.cw = vt.runs < 32 ? vt.runs : 32;
  vt.groups = vt.tx == 1 ? 32 / vt.cw : 1;
  vt.ty = (p.OH + R - 1) / R;
  vt.tasks = (long long)p.N * p.C * vt.ty;
  const long long warps = vt.tx * ((vt.tasks + vt.groups - 1) / vt.groups);
  const long long blocks = (warps + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x), ya = reinterpret_cast<uintptr_t>(y);
  VecSpan sp;
  sp.x_off = (long long)(xa % VEC_BYTES) / 2;
  sp.x_last = (sp.x_off + (long long)p.N * p.C * p.H * p.W - 1) / V;
  sp.y_off = (long long)(ya % VEC_BYTES) / 2;
  vt.edges = !(p.OW % V == 0 && sp.y_off % V == 0);
  const dim3 grid((unsigned)blocks), block(32, WARPS);
  const uint4* xv = reinterpret_cast<const uint4*>(xa - xa % VEC_BYTES);
  __nv_bfloat16* yv = reinterpret_cast<__nv_bfloat16*>(ya - ya % VEC_BYTES);
  if (extra)
    fir_vec_kernel<KH, KW, R, true><<<grid, block, 0, s>>>(xv, yv, taps, p, vt, sp);
  else
    fir_vec_kernel<KH, KW, R, false><<<grid, block, 0, s>>>(xv, yv, taps, p, vt, sp);
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
// Instances 10-11: fir_up4x_kernel, fir_up4y_kernel (K taps along one axis,
// up 4 along it, down 1; float32)
// ---------------------------------------------------------------------------
constexpr int UP4 = 4;

// Four consecutive outputs of one row at yr (output column ox0 .. ox0 + 3 of
// a row of ow): one 16-byte store, or two 8-byte ones, where the four lie in
// the row and are so aligned; otherwise one by one, inside the row.
__device__ __forceinline__ void store_quad(float* yr, const float (&a)[UP4], int ox0, int ow) {
  if (ox0 >= 0 && ox0 + UP4 <= ow) {
    const uintptr_t at = reinterpret_cast<uintptr_t>(yr);
    if ((at & 15) == 0) {
      *reinterpret_cast<float4*>(yr) = make_float4(a[0], a[1], a[2], a[3]);
      return;
    }
    if ((at & 7) == 0) {
      *reinterpret_cast<float2*>(yr) = make_float2(a[0], a[1]);
      *reinterpret_cast<float2*>(yr + 2) = make_float2(a[2], a[3]);
      return;
    }
  }
#pragma unroll
  for (int f = 0; f < UP4; ++f)
    if ((unsigned)(ox0 + f) < (unsigned)ow) yr[f] = a[f];
}

// The x pass: taps (1, K), up (4, 1). Tiles of 128 x R outputs, numbered as
// fir_kernel's (row band fastest, then column tile, then plane).
template <int K, int R>
__global__ void __launch_bounds__(32 * WARPS)
fir_up4x_kernel(const float* __restrict__ x, float* __restrict__ y,
                const float* __restrict__ taps, Params p, Tiling tl) {
  constexpr int NX = (UP4 - 1 + K - 1) / UP4 + 1;  // input columns a lane reads
  const long long warp = (long long)blockIdx.x * WARPS + threadIdx.y;
  const long long per_plane = (long long)tl.tx * tl.ty;
  const long long z = warp / per_plane;
  if (z >= (long long)p.N * p.C) return;
  const int t = (int)(warp - z * per_plane);
  const int band = t % tl.ty, col = t / tl.ty;
  // the crop's phase: every lane's first output sits on a real input position
  const int sx = -p.p_x0 & (UP4 - 1);
  const int ox0 = (col * 32 + (int)threadIdx.x) * UP4 - sx;
  if (ox0 >= p.OW) return;
  const int ix0 = (ox0 - p.p_x0) / UP4;  // exact: a multiple of 4

  float tf[K];  // the taps, flipped
#pragma unroll
  for (int k = 0; k < K; ++k) tf[k] = __ldg(taps + K - 1 - k);
  bool col_in[NX];
#pragma unroll
  for (int c = 0; c < NX; ++c) col_in[c] = (unsigned)(ix0 + c) < (unsigned)p.W;
  const float* xb = x + z * p.H * p.W + ix0;
  float* yb = y + z * p.OH * p.OW + ox0;
#pragma unroll
  for (int e = 0; e < R; ++e) {
    const int oy = band * R + e;
    const bool out_in = oy < p.OH;
    const int iy = oy - p.p_y0;  // kh = 1, up = down = 1 along y
    const bool row_in = out_in && (unsigned)iy < (unsigned)p.H;
    float v[NX];
#pragma unroll
    for (int c = 0; c < NX; ++c)
      v[c] = (row_in && col_in[c]) ? __ldg(xb + (long long)iy * p.W + c) : 0.f;
    // input c feeds output f through tap 4c - f
    float acc[UP4];
#pragma unroll
    for (int f = 0; f < UP4; ++f) {
      acc[f] = 0.f;
#pragma unroll
      for (int c = 0; c < NX; ++c) {
        const int kx = c * UP4 - f;
        if (kx >= 0 && kx < K) acc[f] += tf[kx] * v[c];
      }
    }
    if (out_in) store_quad(yb + (long long)oy * p.OW, acc, ox0, p.OW);
  }
}

// Two neighbouring values of one row at p: one 8-byte access where both
// lie in the row (`both`) and p is 8-byte aligned, else one by one (`in`:
// which lie in the row; the others read as 0 and are not written).
__device__ __forceinline__ float2 load_two(const float* p, bool both, const bool (&in)[2]) {
  if (both && (reinterpret_cast<uintptr_t>(p) & 7) == 0)
    return __ldg(reinterpret_cast<const float2*>(p));
  return make_float2(in[0] ? __ldg(p) : 0.f, in[1] ? __ldg(p + 1) : 0.f);
}
__device__ __forceinline__ void store_two(float* p, float2 v, bool both, const bool (&in)[2]) {
  if (both && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    *reinterpret_cast<float2*>(p) = v;
    return;
  }
  if (in[0]) p[0] = v.x;
  if (in[1]) p[1] = v.y;
}

// The y pass: taps (K, 1), up (1, 4). Tiles of 64 x R outputs, two
// adjacent columns a lane, numbered as fir_kernel's.
template <int K, int R>
__global__ void __launch_bounds__(32 * WARPS)
fir_up4y_kernel(const float* __restrict__ x, float* __restrict__ y,
                const float* __restrict__ taps, Params p, Tiling tl) {
  static_assert(R % UP4 == 0, "instance shape");
  constexpr int NY = (R - 1 + K - 1) / UP4 + 1;  // input rows a thread reads
  const long long warp = (long long)blockIdx.x * WARPS + threadIdx.y;
  const long long per_plane = (long long)tl.tx * tl.ty;
  const long long z = warp / per_plane;
  if (z >= (long long)p.N * p.C) return;
  const int t = (int)(warp - z * per_plane);
  const int band = t % tl.ty, col = t / tl.ty;
  const int ox0 = (col * 32 + (int)threadIdx.x) * 2;
  if (ox0 >= p.OW) return;
  // the crop's phase: every thread's first output row sits on a real input row
  const int sy = -p.p_y0 & (UP4 - 1);
  const int oy0 = band * R - sy;
  const int iy0 = (oy0 - p.p_y0) / UP4;  // exact: a multiple of 4
  const int ix0 = ox0 - p.p_x0;          // kw = 1, up = down = 1 along x

  float tf[K];  // flipped
#pragma unroll
  for (int k = 0; k < K; ++k) tf[k] = __ldg(taps + K - 1 - k);
  const bool col_in[2] = {(unsigned)ix0 < (unsigned)p.W, (unsigned)(ix0 + 1) < (unsigned)p.W};
  const bool out_in[2] = {true, ox0 + 1 < p.OW};
  const float* xb = x + z * p.H * p.W + ix0;
  float2 acc[R];
#pragma unroll
  for (int e = 0; e < R; ++e) acc[e] = make_float2(0.f, 0.f);
#pragma unroll
  for (int r = 0; r < NY; ++r) {
    const int iy = iy0 + r;
    const float2 v = (unsigned)iy < (unsigned)p.H
                         ? load_two(xb + (long long)iy * p.W, col_in[0] && col_in[1], col_in)
                         : make_float2(0.f, 0.f);
    // input row r feeds output row e through tap 4r - e
#pragma unroll
    for (int e = 0; e < R; ++e) {
      const int ky = r * UP4 - e;
      if (ky < 0 || ky >= K) continue;
      acc[e].x += tf[ky] * v.x;
      acc[e].y += tf[ky] * v.y;
    }
  }
  float* yb = y + z * p.OH * p.OW + ox0;
#pragma unroll
  for (int e = 0; e < R; ++e) {
    const int oy = oy0 + e;
    if ((unsigned)oy < (unsigned)p.OH)
      store_two(yb + (long long)oy * p.OW, acc[e], out_in[1], out_in);
  }
}

// R of the up-4 passes: RX rows a thread of the x pass, RY of the y pass
// (12 input rows for 24 output rows; 40 and 76 registers, no spill). On an
// H100 at StyleGAN3-T's shapes, batch 64, the 8 passes took 26.9 ms against
// a bytes bound of 18.9: RX, RY = 4, 16 28.4 ms; 1, 8 28.2; 16, 16 27.9;
// 4, 32 31.3; one column a lane in the y pass 35.0; column tiles fastest or
// streaming stores within 0.7% either way. A plain fill of the card reached
// 2.84 TB/s (85% of 3.35), and the pair runs at 70% of the bound.
constexpr int UP4_RX = 8, UP4_RY = 24;

template <int K>
cudaError_t launch_up4x(const void* x, void* y, const float* taps, const Params& p,
                        cudaStream_t s) {
  Tiling tl;
  tl.tx = (p.OW + (-p.p_x0 & (UP4 - 1)) + 32 * UP4 - 1) / (32 * UP4);
  tl.ty = (p.OH + UP4_RX - 1) / UP4_RX;
  const long long blocks = ((long long)p.N * p.C * tl.tx * tl.ty + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  fir_up4x_kernel<K, UP4_RX><<<(unsigned)blocks, dim3(32, WARPS), 0, s>>>(
      static_cast<const float*>(x), static_cast<float*>(y), taps, p, tl);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_up4y(const void* x, void* y, const float* taps, const Params& p,
                        cudaStream_t s) {
  Tiling tl;
  tl.tx = (p.OW + 63) / 64;
  tl.ty = (p.OH + (-p.p_y0 & (UP4 - 1)) + UP4_RY - 1) / UP4_RY;
  const long long blocks = ((long long)p.N * p.C * tl.tx * tl.ty + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  fir_up4y_kernel<K, UP4_RY><<<(unsigned)blocks, dim3(32, WARPS), 0, s>>>(
      static_cast<const float*>(x), static_cast<float*>(y), taps, p, tl);
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

// ---------------------------------------------------------------------------
// The generic instance on channels-last input: fir_cl_kernel, fir_cl_fixed_kernel
// ---------------------------------------------------------------------------
constexpr int CL_BYTES = 16;  // a lane's channel vector
constexpr int CL_R = 8;       // output rows a thread walks

template <typename T>
__host__ __device__ constexpr int cl_vec() { return CL_BYTES / (int)sizeof(T); }  // values a vector

// Threads: channel vector fastest, then output column, row band of CL_R
// rows, image.
struct ClTiling {
  int cvs, bands;  // channel vectors a pixel, row bands an image
};

__device__ __forceinline__ void unpack(const uint4& c, float (&v)[4]) {
  v[0] = __uint_as_float(c.x); v[1] = __uint_as_float(c.y);
  v[2] = __uint_as_float(c.z); v[3] = __uint_as_float(c.w);
}
__device__ __forceinline__ void unpack(const uint4& c, float (&v)[8]) {
  const unsigned w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack(const float (&a)[4]) {
  return make_uint4(__float_as_uint(a[0]), __float_as_uint(a[1]), __float_as_uint(a[2]),
                    __float_as_uint(a[3]));
}
__device__ __forceinline__ uint4 pack(const float (&a)[8]) {
  return make_uint4(pack_bf16x2(a[0], a[1]), pack_bf16x2(a[2], a[3]), pack_bf16x2(a[4], a[5]),
                    pack_bf16x2(a[6], a[7]));
}

// The thread's channel vector, output column, band and image; false past
// the last image.
__device__ __forceinline__ bool cl_thread(const Params& p, const ClTiling& tl, int& cv, int& ox,
                                          int& band, int& n) {
  long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  cv = (int)(q % tl.cvs);
  q /= tl.cvs;
  ox = (int)(q % p.OW);
  q /= p.OW;
  band = (int)(q % tl.bands);
  q /= tl.bands;
  n = (int)q;
  return q < p.N;
}

// Taps, up and down read at run time: each output sums the input pixels of
// the taps that land on real pixels (first_tap), read from L1, in the tile
// body's order (ky-major, then kx).
template <typename T>
__global__ void __launch_bounds__(256)
fir_cl_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ taps,
              Params p, ClTiling tl) {
  constexpr int VEC = cl_vec<T>();
  int cv, ox, band, n;
  if (!cl_thread(p, tl, cv, ox, band, n)) return;
  const T* xn = x + n * p.sxn + cv * VEC;
  T* yo = y + n * p.syn + cv * VEC + ox * p.syw;
  int kx0, ix0;
  first_tap(ox * p.down_x - p.p_x0, p.up_x, kx0, ix0);
#pragma unroll
  for (int j = 0; j < CL_R; ++j) {
    const int oy = band * CL_R + j;
    if (oy >= p.OH) break;
    int ky0, iy0;
    first_tap(oy * p.down_y - p.p_y0, p.up_y, ky0, iy0);
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    for (int ky = ky0, iy = iy0; ky < p.kh; ky += p.up_y, ++iy) {
      if ((unsigned)iy >= (unsigned)p.H) continue;
      const float* trow = taps + (p.kh - 1 - ky) * p.kw + (p.kw - 1);
      const T* xr = xn + iy * p.sxh;
      for (int kx = kx0, ix = ix0; kx < p.kw; kx += p.up_x, ++ix) {
        if ((unsigned)ix >= (unsigned)p.W) continue;
        float v[VEC];
        unpack(__ldg(reinterpret_cast<const uint4*>(xr + ix * p.sxw)), v);
        const float t = __ldg(trow - kx);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] += t * v[i];
      }
    }
    *reinterpret_cast<uint4*>(yo + oy * p.syh) = pack(acc);
  }
}

// 4x4 taps at up = down = 1 (#2's shape), sizes fixed at compile time: each
// input pixel is loaded once per thread and added into every output row of
// the band that it feeds, in the order of fir_cl_kernel.
template <typename T, int KH, int KW>
__global__ void __launch_bounds__(256)
fir_cl_fixed_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ taps,
                    Params p, ClTiling tl) {
  constexpr int VEC = cl_vec<T>();
  int cv, ox, band, n;
  if (!cl_thread(p, tl, cv, ox, band, n)) return;
  const T* xn = x + n * p.sxn + cv * VEC;
  T* yo = y + n * p.syn + cv * VEC + ox * p.syw;
  const int ix0 = ox - p.p_x0, iy0 = band * CL_R - p.p_y0;
  float tf[KH][KW];  // flipped
#pragma unroll
  for (int ky = 0; ky < KH; ++ky)
#pragma unroll
    for (int kx = 0; kx < KW; ++kx) tf[ky][kx] = __ldg(taps + (KH - 1 - ky) * KW + (KW - 1 - kx));
  float acc[CL_R][VEC];
#pragma unroll
  for (int e = 0; e < CL_R; ++e)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[e][i] = 0.f;
#pragma unroll
  for (int r = 0; r < CL_R + KH - 1; ++r) {
    const int iy = iy0 + r;
    if ((unsigned)iy >= (unsigned)p.H) continue;
    const T* xr = xn + iy * p.sxh;
#pragma unroll
    for (int c = 0; c < KW; ++c) {
      const int ix = ix0 + c;
      if ((unsigned)ix >= (unsigned)p.W) continue;
      float v[VEC];
      unpack(__ldg(reinterpret_cast<const uint4*>(xr + ix * p.sxw)), v);
#pragma unroll
      for (int e = 0; e < CL_R; ++e) {
        const int ky = r - e;
        if (ky < 0 || ky >= KH) continue;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[e][i] += tf[ky][c] * v[i];
      }
    }
  }
#pragma unroll
  for (int e = 0; e < CL_R; ++e) {
    const int oy = band * CL_R + e;
    if (oy < p.OH) *reinterpret_cast<uint4*>(yo + oy * p.syh) = pack(acc[e]);
  }
}

// Channels-last input and output with every channel vector 16-byte aligned:
// unit channel strides, C and the other strides multiples of the vector,
// both pointers 16-byte aligned.
template <typename T>
bool channels_last_vec(const Params& p, const void* x, const void* y) {
  constexpr long long VEC = cl_vec<T>();
  return p.sxc == 1 && p.syc == 1 && p.C % VEC == 0 && p.sxw % VEC == 0 &&
         p.sxh % VEC == 0 && p.sxn % VEC == 0 && p.syw % VEC == 0 && p.syh % VEC == 0 &&
         p.syn % VEC == 0 && reinterpret_cast<uintptr_t>(x) % CL_BYTES == 0 &&
         reinterpret_cast<uintptr_t>(y) % CL_BYTES == 0;
}

// Launches of fir_cl_kernel [0] and fir_cl_fixed_kernel [1] since the
// library was loaded (upfirdn2d_cl_launches): which body the generic
// instance took is not visible to the caller otherwise.
long long cl_launches[2] = {0, 0};

template <typename T>
cudaError_t launch_cl(const void* x, void* y, const float* taps, const Params& p,
                      cudaStream_t s) {
  ClTiling tl;
  tl.cvs = p.C / cl_vec<T>();
  tl.bands = (p.OH + CL_R - 1) / CL_R;
  const long long blocks = ((long long)p.N * tl.bands * p.OW * tl.cvs + 255) / 256;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const bool fixed =
      p.kh == 4 && p.kw == 4 && p.up_x == 1 && p.up_y == 1 && p.down_x == 1 && p.down_y == 1;
  if (fixed)
    fir_cl_fixed_kernel<T, 4, 4><<<(unsigned)blocks, 256, 0, s>>>(xt, yt, taps, p, tl);
  else
    fir_cl_kernel<T><<<(unsigned)blocks, 256, 0, s>>>(xt, yt, taps, p, tl);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++cl_launches[fixed];
  return err;
}

template <typename T>
cudaError_t launch_generic(const void* x, void* y, const float* taps, const Params& p,
                           cudaStream_t s) {
  if (channels_last_vec<T>(p, x, y)) return launch_cl<T>(x, y, taps, p, s);
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
  FIR12Y_UP2, FIR12Y_DOWN2, FIR12X_UP2, FIR12X_DOWN2, FIR24X_UP4, FIR24Y_UP4, N_INSTANCES
};

struct Family {
  int kh, kw, up_x, up_y, down_x, down_y;
};

// Indexed by Instance; GENERIC's row is unused.
constexpr Family FAMILIES[N_INSTANCES] = {
    {0, 0, 0, 0, 0, 0}, {4, 4, 1, 1, 1, 1}, {4, 4, 2, 2, 1, 1}, {4, 4, 1, 1, 2, 2},
    {6, 6, 1, 1, 1, 1}, {6, 1, 1, 1, 1, 1}, {12, 1, 1, 2, 1, 1}, {12, 1, 1, 1, 1, 2},
    {1, 12, 2, 1, 1, 1}, {1, 12, 1, 1, 2, 1}, {1, 24, 4, 1, 1, 1}, {24, 1, 1, 4, 1, 1}};

constexpr int MISMATCH = -1;  // the instance does not fit the arguments

// R (output rows per thread) of each fir_kernel instance: enough rows that
// the kh - 1 halo rows are a small share of what a thread reads, few enough
// that the unrolled window stays in registers (no instance spills). The 4x4
// blur takes 16 rows on planes of 16 rows or more and 8 on the 8 px planes,
// where 16 would leave half of each thread's rows outside the plane.
// bf16 instance 1 takes fir_vec_kernel, with R as fir_kernel's.
template <typename T>
cudaError_t launch(int instance, const void* x, void* y, const float* taps, const Params& p,
                   cudaStream_t s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (instance == FIR4X4)
      return p.OH >= 16 ? launch_vec<4, 4, 16>(x, y, taps, p, s)
                        : launch_vec<4, 4, 8>(x, y, taps, p, s);
  }
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
    default: break;
  }
  if constexpr (std::is_same<T, float>::value) {  // fits() keeps bfloat16 from these
    if (instance == FIR24X_UP4) return launch_up4x<24>(x, y, taps, p, s);
    if (instance == FIR24Y_UP4) return launch_up4y<24>(x, y, taps, p, s);
  }
  return launch_generic<T>(x, y, taps, p, s);
}

// An instance other than GENERIC takes exactly its family's taps, up and
// down, and contiguous NCHW input and output; the up-4 pair float32 alone.
bool fits(int instance, int dtype, const Params& p) {
  if (instance < 0 || instance >= N_INSTANCES) return false;
  if (instance == GENERIC) return true;
  if ((instance == FIR24X_UP4 || instance == FIR24Y_UP4) && dtype != 0) return false;
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
  if (!fits(instance, dtype, p)) return MISMATCH;
  if ((long long)N * C * OH * OW == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(instance, x, y, taps, p, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(instance, x, y, taps, p, s);
  return (int)cudaErrorInvalidValue;
}

// Launches of the generic instance's channels-last bodies: fir_cl_kernel
// (fixed = 0) or fir_cl_fixed_kernel (fixed = 1).
extern "C" long long upfirdn2d_cl_launches(int fixed) { return cl_launches[fixed != 0]; }
