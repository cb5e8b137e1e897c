// The Q4 dequant lab: K12 q4_lab_gemv, K13 q4_lab_dma and K14 pair_bitcast.
//
// K12 replaces the Pallas probe bodies of tools/kernel_lab.py:variant_matmul
// (:489; _k_i32 :76, _k_u16 :96, _k_f32x :121, _k_f32f :145, _k_f32xf :173,
// _k_i32f :202), tools/pair_lab.py:variant_matmul (:117; _k_f32b :53,
// _pair_kernel :77 as pairA and pairB), tools/pair_sweep.py:pair_matmul
// (:87, :104; _k_pairA :41, _k_pairC :58) and tools/pair_probe.py:80
// (k_pairA :38, pairA with unit scales).  y[n, O] = x[n, K] . W for n <= 32
// rows of bf16 x and an interleaved ("i" layout) Q4 weight: packed row c
// holds elements 2c (low nibble) and 2c + 1 (high nibble), scale row c/16.
// One GEMV skeleton, templated on the dequant math (the table in
// vsim_tpu_torch/ops/q4_lab.py), so that the maths differ only in the
// instruction sequence that turns a nibble and its scale into a weight.
//
// Bound on the H100: the weight bytes (0.5625 B a parameter) at n = 1; the
// f32 multiply-adds (two a weight and row) from a few rows up, earlier for
// the maths with the longer dequant sequences.  Design, K2's GEMV (csrc/
// q4_matmul_ps.cu) moved to the "i" layout: a thread owns 4 neighbouring
// output columns and reads one 4-byte word of a packed row a step, so a
// warp reads 128 contiguous bytes of the K-major row; up to 8 rows a group
// (16 packed rows, one scale row) is loaded into registers while the
// previous group computes, past 8 rows (bound by the multiply-adds) the rows
// are loaded as they go, 4 in flight.  Rows: all n rows of a call are one pass over the weight, so
// every weight byte is read once a call: a thread holds NR x 4 f32 sums,
// NR = 1, 8, 16 or 32, the least that holds n (rows past n are zeros in
// shared memory and are never stored); x sits in shared memory as (even,
// odd) float pairs, 16 KB a slab of groups (fewer groups for more rows).
// 32 rows take 128 sums a thread, one block of 256 threads an SM: read
// ptxas's report (-Xptxas -v, printed by the build) for the spills.  Too
// few 1024-column tiles for 132 SMs is met by splitting K across blockIdx.y
// in whole groups; the splits write f32 partials that a second pass sums in
// split order (deterministic, no atomics).  pairC folds its correction into
// the sums: after each group, acc += (-136 xs) s, with -136 xs exact in f32.
//
// K13 replaces tools/kernel_lab.py:_k_dma (:58, "i" layout) and
// tools/gi_sweep.py:_k_giw_dma (:24, dispatched at :47, "ps" layout with
// both scale planes): DMA-only probes whose bodies touch 8 rows of each
// tile.  On the GPU a load that no instruction consumes moves no bytes, so
// K13 computes two things: the Pallas body's touch output exactly (one
// thread sums an output element over the k tiles in grid order, in f32,
// left to right as the body writes it), and a checksum that reads every
// byte: per column, the int32 sum of the packed bytes and of the raw bf16
// scale bits, exact in any order.  Bound: the bytes.  Design: the packed
// rows and the scale rows are cut into units of one 512-byte row of a tile
// (a warp's 32 x 16-byte loads), packed tiles first, and each of 4 x SMs
// blocks takes an equal share of the units, so no SM waits on another
// whatever the shape and the scale rows are read beside the packed ones;
// each of a block's 8 warps takes every 8th row of its share of a tile, 8
// rows in flight a thread; bytes are summed two at a time in 16-bit lanes
// (at most 256 rows a thread), the 8 warps are reduced in shared memory and
// added to the zeroed checksum with one coalesced integer atomic a column
// (exact, so the order does not matter).  The touch output has blocks of
// its own at the head of the grid, two elements a thread.  The launch
// zeroes the checksum first (a memset on the stream).  A flat read of the
// same bytes, which sums them without columns, is faster at every shape;
// vsim_tpu_torch/tools/read_designs.py times it beside K13 and the designs
// K13 was chosen from.
//
// K14 replaces tools/pair_probe.py:53 (k_bitcast :31): [KH, O] u8 ->
// [2 KH, O] f32, row 2c = 128 + lo and row 2c + 1 = 128 + hi of packed row
// c, read from the bf16 halves of the pair word that K12's pairA builds.
// An elementwise pass, bound by its bytes: a thread reads 4 bytes and
// writes two float4.

#include "column_sums.cuh"
#include "common.cuh"

namespace {

// the lab maths, in the order of vsim_tpu_torch/ops/q4_lab.py:LAB_MATHS
enum LabMath { kI32, kU16, kF32x, kF32f, kF32xf, kI32f, kF32b, kPairA, kPairB,
               kPairC, kNumMaths };

constexpr int kThreads = 256;
constexpr int kCols = 4;                   // output columns per thread
constexpr int kTileO = kThreads * kCols;   // 1024 columns per block
constexpr int kGroupRows = 16;             // packed rows a scale row covers

// The pair word of byte b: 0x43004300 | lo | hi << 16, bf16 128 + lo in the
// low half and 128 + hi in the high (pairA, pairC, K14); HI_FIRST swaps the
// nibbles (pairB).
template <bool HI_FIRST>
__device__ __forceinline__ uint32_t pair_word(uint32_t b) {
  const uint32_t bits = HI_FIRST ? (((b >> 4) & 0x0Fu) | ((b & 0x0Fu) << 16))
                                 : ((b & 0x0Fu) | ((b & 0xF0u) << 12));
  return bits | 0x43004300u;
}

// A group's 4 scales, in the forms the maths take.
struct GroupScales {
  uint2 raw;             // bf16 pairs (s0, s1), (s2, s3)
  float f[kCols];        // s as f32
  float bexp[kCols];     // f32f: f32(-(2^23 + 8) s), rounded as the body does
  uint32_t dup[kCols];   // pair maths: the bf16 pair (s_j, s_j)
};

__device__ __forceinline__ GroupScales group_scales(uint2 sw) {
  GroupScales s;
  s.raw = sw;
  unpack_bf16x2(sw.x, s.f[0], s.f[1]);
  unpack_bf16x2(sw.y, s.f[2], s.f[3]);
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    s.bexp[j] = __fmul_rn(s.f[j], -8388616.f);
    const uint32_t h = (j < 2 ? sw.x : sw.y) >> (16 * (j & 1)) & 0xFFFFu;
    s.dup[j] = h | (h << 16);
  }
  return s;
}

// The weights of elements 2c (we) and 2c + 1 (wo) of the 4 columns of
// packed word w, under math M.
template <int M>
__device__ __forceinline__ void dequant(uint32_t w, const GroupScales& s,
                                        float (&we)[kCols],
                                        float (&wo)[kCols]) {
  const uint32_t lo4 = w & 0x0F0F0F0Fu, hi4 = (w >> 4) & 0x0F0F0F0Fu;
  if constexpr (M == kI32 || M == kI32f) {
    // int subtract, convert, multiply (i32: then round to bf16)
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      we[j] = static_cast<float>(static_cast<int>((w >> (8 * j)) & 0xFu) - 8) * s.f[j];
      wo[j] = static_cast<float>(static_cast<int>((w >> (8 * j + 4)) & 0xFu) - 8) * s.f[j];
      if (M == kI32) round2_bf16(we[j], wo[j]);
    }
  } else if constexpr (M == kU16) {
    // 0x4300 | v as bf16 (128 + v), minus 136, times s: bf16 pairs of
    // neighbouring columns, one rounding (dequant_bf16x2)
    unpack_bf16x2(dequant_bf16x2<0>(lo4, s.raw.x), we[0], we[1]);
    unpack_bf16x2(dequant_bf16x2<2>(lo4, s.raw.y), we[2], we[3]);
    unpack_bf16x2(dequant_bf16x2<0>(hi4, s.raw.x), wo[0], wo[1]);
    unpack_bf16x2(dequant_bf16x2<2>(hi4, s.raw.y), wo[2], wo[3]);
  } else if constexpr (M == kF32x || M == kF32xf) {
    // 0x4B000000 | v (2^23 + v), minus 2^23 + 8, times s (f32x: round)
    we[0] = nib_f<0>(lo4) * s.f[0];
    we[1] = nib_f<1>(lo4) * s.f[1];
    we[2] = nib_f<2>(lo4) * s.f[2];
    we[3] = nib_f<3>(lo4) * s.f[3];
    wo[0] = nib_f<0>(hi4) * s.f[0];
    wo[1] = nib_f<1>(hi4) * s.f[1];
    wo[2] = nib_f<2>(hi4) * s.f[2];
    wo[3] = nib_f<3>(hi4) * s.f[3];
    if (M == kF32x) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) round2_bf16(we[j], wo[j]);
    }
  } else if constexpr (M == kF32f || M == kF32b) {
    // (2^23 + v) s + f32(-(2^23 + 8) s) in one fma, one rounding: XLA
    // contracts the body's lo * sexp + bexp on the CPU (f32b: then round)
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float l = __uint_as_float(__byte_perm(lo4, 0x4B000000u, 0x7440 + j));
      const float h = __uint_as_float(__byte_perm(hi4, 0x4B000000u, 0x7440 + j));
      we[j] = __fmaf_rn(l, s.f[j], s.bexp[j]);
      wo[j] = __fmaf_rn(h, s.f[j], s.bexp[j]);
      if (M == kF32b) round2_bf16(we[j], wo[j]);
    }
  } else {
    // one 32-bit pair word gives both weights of a byte as a bf16 pair:
    // (128 + v - 136) s, one rounding (pairA, pairB); (128 + v) s (pairC)
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const uint32_t u = pair_word<M == kPairB>((w >> (8 * j)) & 0xFFu);
      const uint32_t t = M == kPairC ? u
                                     : fma_bf16x2(u, 0x3F803F80u, 0xC308C308u);
      unpack_bf16x2(fma_bf16x2(t, s.dup[j], 0x80008000u), we[j], wo[j]);
    }
  }
}

template <int M, int NR>
__global__ void __launch_bounds__(kThreads, NR >= 16 ? 1 : 2)
lab_gemv_kernel(const uint16_t* __restrict__ x,      // [n, K] bf16
                const uint16_t* __restrict__ xsum,   // pairC: [n, K/32] bf16
                const uint8_t* __restrict__ packed,  // [K/2, O]
                const uint16_t* __restrict__ scales, // [K/32, O] bf16
                float* __restrict__ dst,  // [n, O] (splits == 1) or [splits, n, O]
                int n, int K, int O, int splits) {
  constexpr int kSlabG = NR <= 8 ? 16 : 128 / NR;  // 16 KB of x pairs a slab
  constexpr bool kBuffered = NR <= 8;
  __shared__ __align__(16) float2 xs[NR][kSlabG * kGroupRows];
  __shared__ float xc[NR][kSlabG];  // pairC: -136 times x's block sums
  const int G = K / 32;
  const int split = blockIdx.y;
  const int g_begin = static_cast<int>(static_cast<long long>(G) * split / splits);
  const int g_end = static_cast<int>(static_cast<long long>(G) * (split + 1) / splits);
  const int col = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  const bool active = col < O;  // O % 4 == 0: a thread is all in or all out

  float acc[NR][kCols];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  // acc += x . W over packed row r of group gg of the slab, word w
  auto row_step = [&](uint32_t w, const GroupScales& s, int gg, int r) {
    float we[kCols], wo[kCols];
    dequant<M>(w, s, we, wo);
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const float2 xp = xs[i][gg * kGroupRows + r];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        acc[i][j] = fmaf(xp.y, wo[j], fmaf(xp.x, we[j], acc[i][j]));
    }
  };
  auto scale_pair = [&](int g) {
    return __ldg(reinterpret_cast<const uint2*>(scales + static_cast<size_t>(g) * O + col));
  };
  auto word = [&](int g, int r) {
    return __ldg(reinterpret_cast<const unsigned int*>(
        packed + (static_cast<size_t>(g) * kGroupRows + r) * O + col));
  };
  // up to 8 rows (memory-bound): a group's 16 words in registers, the next
  // group's in flight while this one computes; past 8 rows (bound by the
  // multiply-adds) the words are loaded as the rows go, 4 in flight
  uint32_t wc[kBuffered ? kGroupRows : 1], wn[kBuffered ? kGroupRows : 1];
  uint2 sc = make_uint2(0, 0), sn = make_uint2(0, 0);
  auto load_group = [&](uint32_t (&w)[kBuffered ? kGroupRows : 1], uint2& sw,
                        int g) {
#pragma unroll
    for (int r = 0; r < kGroupRows; ++r) w[kBuffered ? r : 0] = word(g, r);
    sw = scale_pair(g);
  };
  if constexpr (kBuffered) {
    if (active && g_begin < g_end) load_group(wc, sc, g_begin);
  }

  for (int g0 = g_begin; g0 < g_end; g0 += kSlabG) {
    const int ng = min(kSlabG, g_end - g0);
    const int pairs = ng * kGroupRows;
    __syncthreads();  // the previous slab is consumed
    for (int idx = threadIdx.x; idx < NR * pairs; idx += kThreads) {
      const int i = idx / pairs, c = idx - i * pairs;
      float e = 0.f, o = 0.f;
      if (i < n) {
        const uint32_t xp = reinterpret_cast<const uint32_t*>(
            x + static_cast<size_t>(i) * K)[g0 * kGroupRows + c];
        unpack_bf16x2(xp, e, o);
      }
      xs[i][c] = make_float2(e, o);
    }
    if (M == kPairC) {
      for (int idx = threadIdx.x; idx < NR * ng; idx += kThreads) {
        const int i = idx / ng, gg = idx - i * ng;
        xc[i][gg] = i < n ? -136.f * bf16_to_float(
                                xsum[static_cast<size_t>(i) * G + g0 + gg])
                          : 0.f;
      }
    }
    __syncthreads();
    if (!active) continue;
    for (int gg = 0; gg < ng; ++gg) {
      const int g = g0 + gg;
      GroupScales s;
      if constexpr (kBuffered) {
        if (g + 1 < g_end) load_group(wn, sn, g + 1);
        s = group_scales(sc);
#pragma unroll
        for (int r = 0; r < kGroupRows; ++r) row_step(wc[r], s, gg, r);
#pragma unroll
        for (int r = 0; r < kGroupRows; ++r) wc[r] = wn[r];
        sc = sn;
      } else {
        s = group_scales(scale_pair(g));
#pragma unroll 4
        for (int r = 0; r < kGroupRows; ++r) row_step(word(g, r), s, gg, r);
      }
      if (M == kPairC) {
#pragma unroll
        for (int i = 0; i < NR; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            acc[i][j] = fmaf(xc[i][gg], s.f[j], acc[i][j]);
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    if (i >= n) break;
    const float4 o = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    float* d = dst + (static_cast<size_t>(splits == 1 ? 0 : split) * n + i) * O + col;
    *reinterpret_cast<float4*>(d) = o;
  }
}

// Second pass of a split K: out = the partials summed in split order.
__global__ void lab_split_reduce_kernel(const float* __restrict__ partial,
                                        float* __restrict__ out, int total,
                                        int splits) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[static_cast<size_t>(k) * total + idx];
  out[idx] = s;
}

template <int M, int NR>
void gemv_launch_t(const uint16_t* x, const uint16_t* xsum, const uint8_t* packed,
                   const uint16_t* scales, float* partial, float* out, int n,
                   int K, int O, int splits, cudaStream_t s) {
  const dim3 grid((O + kTileO - 1) / kTileO, splits);
  lab_gemv_kernel<M, NR><<<grid, kThreads, 0, s>>>(
      x, xsum, packed, scales, splits == 1 ? out : partial, n, K, O, splits);
}

template <int M>
void gemv_launch_rows(const uint16_t* x, const uint16_t* xsum,
                      const uint8_t* packed, const uint16_t* scales,
                      float* partial, float* out, int n, int K, int O,
                      int splits, cudaStream_t s) {
  if (n == 1)
    gemv_launch_t<M, 1>(x, xsum, packed, scales, partial, out, n, K, O, splits, s);
  else if (n <= 8)
    gemv_launch_t<M, 8>(x, xsum, packed, scales, partial, out, n, K, O, splits, s);
  else if (n <= 16)
    gemv_launch_t<M, 16>(x, xsum, packed, scales, partial, out, n, K, O, splits, s);
  else
    gemv_launch_t<M, 32>(x, xsum, packed, scales, partial, out, n, K, O, splits, s);
}

template <int M = 0>
void gemv_dispatch(int math, const uint16_t* x, const uint16_t* xsum,
                   const uint8_t* packed, const uint16_t* scales,
                   float* partial, float* out, int n, int K, int O,
                   int splits, cudaStream_t s) {
  if constexpr (M < kNumMaths) {
    if (math == M)
      gemv_launch_rows<M>(x, xsum, packed, scales, partial, out, n, K, O,
                          splits, s);
    else
      gemv_dispatch<M + 1>(math, x, xsum, packed, scales, partial, out, n, K,
                           O, splits, s);
  }
}

// ---------------------------------------------------------------------------
// K13: a read of every byte
// ---------------------------------------------------------------------------

constexpr int kDmaWarps = 8;
constexpr int kDmaThreads = kDmaWarps * 32;

// The touch output, from blocks [0, tb): a thread owns whole elements and
// sums their k tiles in grid order, as the Pallas body adds them.
__device__ __forceinline__ void dma_touch(const uint16_t* __restrict__ x,
                                          const uint8_t* __restrict__ packed,
                                          const uint16_t* __restrict__ scales,
                                          float* __restrict__ touch, int ps, int n,
                                          int K, int O, int block_kh, int tb) {
  const int KH = K / 2;
  const int r = min(8, n);
  const int nk = KH / block_kh;
  const int srows = ps ? block_kh / 32 : min(8, block_kh / kGroupRows);
  const bool per_row = srows >= r;
  const int stride = tb * kDmaThreads;
  for (int idx = blockIdx.x * kDmaThreads + threadIdx.x; idx < n * O; idx += stride) {
    const int i = idx / O, c = idx - i * O;
    float o = 0.f;
    if (i < r) {
      const int si = per_row ? i : 0;
#pragma unroll 8
      for (int k = 0; k < nk; ++k) {
        const float pv = static_cast<float>(
            packed[(static_cast<size_t>(k) * block_kh + i) * O + c]);
        float t;
        if (ps) {
          const int g = k * (block_kh / 32) + si;
          t = __fadd_rn(__fadd_rn(pv, bf16_to_float(scales[static_cast<size_t>(g) * O + c])),
                        bf16_to_float(scales[static_cast<size_t>(KH / 32 + g) * O + c]));
          t = __fadd_rn(t, bf16_to_float(x[static_cast<size_t>(i) * K]));
        } else {
          const int g = k * (block_kh / kGroupRows) + si;
          t = __fadd_rn(pv, bf16_to_float(scales[static_cast<size_t>(g) * O + c]));
          t = __fadd_rn(t, bf16_to_float(x[static_cast<size_t>(i) * K + 2 * k * block_kh]));
        }
        o = __fadd_rn(o, t);
      }
    }
    touch[static_cast<size_t>(i) * O + c] = o;
  }
}

// Blocks [0, tb) write the touch output; block tb + b of the rest takes
// share b of the checksum's units (column_sums.cuh: one 512-byte tile row a
// unit, a warp's 32 x 16-byte loads).
__global__ void __launch_bounds__(kDmaThreads)
lab_dma_kernel(const uint16_t* __restrict__ x,       // [n, K] bf16
               const uint8_t* __restrict__ packed,   // [K/2, O]
               const uint16_t* __restrict__ scales,  // [K/32, O] bf16
               float* __restrict__ touch,            // [n, O]
               int* __restrict__ checksum,           // [2, O], zeroed
               int ps, int n, int K, int O, int block_kh, int tb) {
  __shared__ __align__(16) int red[kDmaThreads * 16];
  if (static_cast<int>(blockIdx.x) < tb) {
    dma_touch(x, packed, scales, touch, ps, n, K, O, block_kh, tb);
    return;
  }
  checksum_share<kDmaThreads, 32>(packed, scales, checksum, K, O, blockIdx.x - tb,
                                  gridDim.x - tb, red);
}

// ---------------------------------------------------------------------------
// K14: the pair word's halves as floats
// ---------------------------------------------------------------------------

__global__ void pair_bitcast_kernel(const uint8_t* __restrict__ packed,
                                    float* __restrict__ out, int KH, int O) {
  const int quads = O / 4;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(KH) * quads) return;
  const int c = static_cast<int>(idx / quads);
  const int col = static_cast<int>(idx - static_cast<long long>(c) * quads) * 4;
  const uint32_t w = *reinterpret_cast<const uint32_t*>(
      packed + static_cast<size_t>(c) * O + col);
  float e[4], o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    unpack_bf16x2(pair_word<false>((w >> (8 * j)) & 0xFFu), e[j], o[j]);
  *reinterpret_cast<float4*>(out + static_cast<size_t>(2 * c) * O + col) =
      make_float4(e[0], e[1], e[2], e[3]);
  *reinterpret_cast<float4*>(out + static_cast<size_t>(2 * c + 1) * O + col) =
      make_float4(o[0], o[1], o[2], o[3]);
}

}  // namespace

// K12: math is the index in LAB_MATHS; xsum only for pairC.
extern "C" int q4_lab_gemv_launch(const void* x, const void* xsum,
                                  const void* packed, const void* scales,
                                  void* partial, void* out, int n, int K,
                                  int O, int splits, int math, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > 32 || K % 32 || O % 4 || splits < 1 || math < 0 ||
      math >= kNumMaths || (math == kPairC) != (xsum != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto op = static_cast<float*>(out);
  auto part = static_cast<float*>(partial);
  gemv_dispatch(math, static_cast<const uint16_t*>(x),
                static_cast<const uint16_t*>(xsum),
                static_cast<const uint8_t*>(packed),
                static_cast<const uint16_t*>(scales), part, op, n, K, O,
                splits, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int total = n * O;
  lab_split_reduce_kernel<<<(total + 255) / 256, 256, 0, s>>>(part, op, total,
                                                              splits);
  return static_cast<int>(cudaGetLastError());
}

// K13: ps = 1 for the plane-split touch (both scale planes, x column 0);
// blocks: the checksum's blocks (the launch adds the touch's).
extern "C" int q4_lab_dma_launch(const void* x, const void* packed,
                                 const void* scales, void* touch,
                                 void* checksum, int ps, int n, int K, int O,
                                 int block_kh, int blocks, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > 32 || K % 32 || O % 16 || block_kh < 16 ||
      (K / 2) % block_kh || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(checksum, 0, sizeof(int) * 2 * O, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // two touched elements a thread
  const int tb = (min(8, n) * O + 2 * kDmaThreads - 1) / (2 * kDmaThreads);
  lab_dma_kernel<<<tb + blocks, kDmaThreads, 0, s>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const uint16_t*>(scales), static_cast<float*>(touch),
      static_cast<int*>(checksum), ps, n, K, O, block_kh, tb);
  return static_cast<int>(cudaGetLastError());
}

// K14.
extern "C" int pair_bitcast_launch(const void* packed, void* out, int KH,
                                   int O, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (KH < 1 || O % 4) return static_cast<int>(cudaErrorInvalidValue);
  const long long words = static_cast<long long>(KH) * (O / 4);
  const int blocks = static_cast<int>((words + 255) / 256);
  pair_bitcast_kernel<<<blocks, 256, 0, s>>>(static_cast<const uint8_t*>(packed),
                                             static_cast<float*>(out), KH, O);
  return static_cast<int>(cudaGetLastError());
}
