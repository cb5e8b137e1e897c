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
// K12 also computes four other operand layouts of kernel_lab and
// decode_lab, each under f32x (bf16((v - 8) s)), the maths' shared
// function: "res" (tools/kernel_lab.py:_k_res :225, res_matmul :259) is the
// "i" instance launched with K never split, each block walking all of K for
// its columns (the TPU's resident x has no counterpart at 16 rows of K =
// 16384: x is staged slab by slab as for "i"); the other three are a
// template parameter of the same skeleton: "w32" (_k_w32 :281, w32_matmul
// :344) reads a [K/8, O] int32 weight whose word holds packed rows 4r' ..
// 4r' + 3 of one column (pack_w32): a thread loads one 16-byte word row of
// its 4 columns and byte-transposes it into four "i" rows; "ps" (_k_ps
// :384, ps_matmul :439) reads the plane-split repack, byte c = elements c
// and c + K/2, with raw x: the pair (x[c], x[K/2 + c]) and two scale rows
// a group, c / 32 and K/64 + c / 32; "v2" (tools/decode_lab.py:_k_v2 :55,
// v2_matmul :88) is a stacked "i" weight [L, K/2, O] whose layer the kernel
// reads from an int32 on the device (clamped to [0, L), as K10 does), so a
// call neither slices a layer nor syncs with the host.
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
// K13 was chosen from.  Two more touch outputs, on the "ps" repack, are
// tools/batch_lab.py's: "2d" (_k2d_dma :141, run_2d :174: o[i] += p[tile
// row i] + s[i] + x[i, 0], the first 8 scale rows of the whole array) and
// "band" (_kband's dma math :207, run_band :251: o[i] += p[tile row i] +
// s[the tile's scale row i] + x[i, k block_kh]), both over 8 rows, n <= 128.
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

// K12's operand layouts, in the order of vsim_tpu_torch/ops/q4_lab.py:
// _KERNEL_LAYOUTS ("res" is kLayI in one split, which the wrapper sets)
enum LabLayout { kLayI, kLayW32, kLayPs, kLayV2 };

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
// ``sh`` is the high nibbles' scales: ``s`` but in the "ps" layout, whose
// two planes take different scale rows (f32x only).
template <int M>
__device__ __forceinline__ void dequant(uint32_t w, const GroupScales& s,
                                        const GroupScales& sh,
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
    wo[0] = nib_f<0>(hi4) * sh.f[0];
    wo[1] = nib_f<1>(hi4) * sh.f[1];
    wo[2] = nib_f<2>(hi4) * sh.f[2];
    wo[3] = nib_f<3>(hi4) * sh.f[3];
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

// Packed rows 4q .. 4q + 3 of group g, columns col .. col + 3, one word a
// row (byte j = column col + j), in the layout LAY.
template <int LAY>
__device__ __forceinline__ void load_quad(const uint8_t* __restrict__ packed,
                                          int g, int q, int O, int col,
                                          uint32_t* w) {
  if constexpr (LAY == kLayW32) {
    // word row 4g + q of columns col .. col + 3: byte j of column c's word
    // is packed row 4 (4g + q) + j; transposed into the four rows' words
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(
        packed + (static_cast<size_t>(4 * g + q) * O + col) * 4));
    const uint32_t xy_lo = __byte_perm(u.x, u.y, 0x5140);  // x0 y0 x1 y1
    const uint32_t xy_hi = __byte_perm(u.x, u.y, 0x7362);  // x2 y2 x3 y3
    const uint32_t zw_lo = __byte_perm(u.z, u.w, 0x5140);
    const uint32_t zw_hi = __byte_perm(u.z, u.w, 0x7362);
    w[0] = __byte_perm(xy_lo, zw_lo, 0x5410);
    w[1] = __byte_perm(xy_lo, zw_lo, 0x7632);
    w[2] = __byte_perm(xy_hi, zw_hi, 0x5410);
    w[3] = __byte_perm(xy_hi, zw_hi, 0x7632);
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      w[r] = __ldg(reinterpret_cast<const unsigned int*>(
          packed + (static_cast<size_t>(g) * kGroupRows + 4 * q + r) * O + col));
  }
}

template <int M, int NR, int LAY>
__global__ void __launch_bounds__(kThreads, NR >= 16 ? 1 : 2)
lab_gemv_kernel(const uint16_t* __restrict__ x,      // [n, K] bf16
                const uint16_t* __restrict__ xsum,   // pairC: [n, K/32] bf16
                const uint8_t* __restrict__ packed,  // [(L,) K/2, O]; w32: [K/8, O] words
                const uint16_t* __restrict__ scales, // [(L,) K/32, O] bf16
                const int* __restrict__ il,          // v2: the layer, else null
                int n_layers,
                float* __restrict__ dst,  // [n, O] (splits == 1) or [splits, n, O]
                int n, int K, int O, int splits) {
  constexpr int kSlabG = NR <= 8 ? 16 : 128 / NR;  // 16 KB of x pairs a slab
  constexpr bool kBuffered = NR <= 8;
  constexpr bool kPs = LAY == kLayPs;
  __shared__ __align__(16) float2 xs[NR][kSlabG * kGroupRows];
  __shared__ float xc[NR][kSlabG];  // pairC: -136 times x's block sums
  const int G = K / 32;
  if (LAY == kLayV2) {  // select the layer on the device
    const int l = min(max(*il, 0), n_layers - 1);
    packed += static_cast<size_t>(l) * (K / 2) * O;
    scales += static_cast<size_t>(l) * G * O;
  }
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
  auto row_step = [&](uint32_t w, const GroupScales& s, const GroupScales& sh,
                      int gg, int r) {
    float we[kCols], wo[kCols];
    dequant<M>(w, s, sh, we, wo);
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const float2 xp = xs[i][gg * kGroupRows + r];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        acc[i][j] = fmaf(xp.y, wo[j], fmaf(xp.x, we[j], acc[i][j]));
    }
  };
  // the scale row of group g's low nibbles (hi: of its high nibbles): row g,
  // or in "ps" rows g / 2 and K/64 + g / 2 (32 packed rows a scale row)
  auto scale_pair = [&](int g, bool hi) {
    const int row = kPs ? (hi ? G / 2 : 0) + g / 2 : g;
    return __ldg(reinterpret_cast<const uint2*>(scales + static_cast<size_t>(row) * O + col));
  };
  // up to 8 rows (memory-bound): a group's 16 words in registers, the next
  // group's in flight while this one computes; past 8 rows (bound by the
  // multiply-adds) the words are loaded as the rows go, a quad of rows at
  // a time
  uint32_t wc[kBuffered ? kGroupRows : 1], wn[kBuffered ? kGroupRows : 1];
  uint2 sc = make_uint2(0, 0), sn = make_uint2(0, 0);
  uint2 shc = make_uint2(0, 0), shn = make_uint2(0, 0);
  auto load_group = [&](uint32_t (&w)[kBuffered ? kGroupRows : 1], uint2& sw,
                        uint2& shw, int g) {
    if constexpr (kBuffered) {
#pragma unroll
      for (int q = 0; q < 4; ++q) load_quad<LAY>(packed, g, q, O, col, w + 4 * q);
    }
    sw = scale_pair(g, false);
    if (kPs) shw = scale_pair(g, true);
  };
  if constexpr (kBuffered) {
    if (active && g_begin < g_end) load_group(wc, sc, shc, g_begin);
  }

  for (int g0 = g_begin; g0 < g_end; g0 += kSlabG) {
    const int ng = min(kSlabG, g_end - g0);
    const int pairs = ng * kGroupRows;
    __syncthreads();  // the previous slab is consumed
    for (int idx = threadIdx.x; idx < NR * pairs; idx += kThreads) {
      const int i = idx / pairs, c = idx - i * pairs;
      float e = 0.f, o = 0.f;
      if (i < n) {
        const uint16_t* xr = x + static_cast<size_t>(i) * K;
        const int pc = g0 * kGroupRows + c;  // the packed row
        if (kPs) {  // elements c and K/2 + c
          e = bf16_to_float(xr[pc]);
          o = bf16_to_float(xr[K / 2 + pc]);
        } else {    // elements 2c and 2c + 1
          unpack_bf16x2(reinterpret_cast<const uint32_t*>(xr)[pc], e, o);
        }
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
      GroupScales s, sh;
      if constexpr (kBuffered) {
        if (g + 1 < g_end) load_group(wn, sn, shn, g + 1);
        s = group_scales(sc);
        sh = kPs ? group_scales(shc) : s;
#pragma unroll
        for (int r = 0; r < kGroupRows; ++r) row_step(wc[r], s, sh, gg, r);
#pragma unroll
        for (int r = 0; r < kGroupRows; ++r) wc[r] = wn[r];
        sc = sn;
        shc = shn;
      } else {
        s = group_scales(scale_pair(g, false));
        sh = kPs ? group_scales(scale_pair(g, true)) : s;
#pragma unroll 1
        for (int q = 0; q < 4; ++q) {
          uint32_t w4[4];
          load_quad<LAY>(packed, g, q, O, col, w4);
#pragma unroll
          for (int r = 0; r < 4; ++r) row_step(w4[r], s, sh, gg, 4 * q + r);
        }
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

// The operands of a K12 launch.
struct GemvArgs {
  const uint16_t* x;
  const uint16_t* xsum;
  const uint8_t* packed;
  const uint16_t* scales;
  const int* il;
  int n_layers;
  float* partial;
  float* out;
  int n, K, O, splits;
};

template <int M, int NR, int LAY>
void gemv_launch_t(const GemvArgs& a, cudaStream_t s) {
  const dim3 grid((a.O + kTileO - 1) / kTileO, a.splits);
  lab_gemv_kernel<M, NR, LAY><<<grid, kThreads, 0, s>>>(
      a.x, a.xsum, a.packed, a.scales, a.il, a.n_layers,
      a.splits == 1 ? a.out : a.partial, a.n, a.K, a.O, a.splits);
}

template <int M, int LAY>
void gemv_launch_rows(const GemvArgs& a, cudaStream_t s) {
  if (a.n == 1)
    gemv_launch_t<M, 1, LAY>(a, s);
  else if (a.n <= 8)
    gemv_launch_t<M, 8, LAY>(a, s);
  else if (a.n <= 16)
    gemv_launch_t<M, 16, LAY>(a, s);
  else
    gemv_launch_t<M, 32, LAY>(a, s);
}

// the "i" layout under math ``math``
template <int M = 0>
void gemv_dispatch(int math, const GemvArgs& a, cudaStream_t s) {
  if constexpr (M < kNumMaths) {
    if (math == M)
      gemv_launch_rows<M, kLayI>(a, s);
    else
      gemv_dispatch<M + 1>(math, a, s);
  }
}

// ---------------------------------------------------------------------------
// K13: a read of every byte
// ---------------------------------------------------------------------------

constexpr int kDmaWarps = 8;
constexpr int kDmaThreads = kDmaWarps * 32;

// The touch modes, in the order of vsim_tpu_torch/ops/q4_lab.py:DMA_LAYOUTS.
enum DmaMode { kDmaI, kDmaPs, kDma2d, kDmaBand };

// The touch output, from blocks [0, tb): a thread owns whole elements and
// sums their k tiles in grid order, as the Pallas body adds them.
__device__ __forceinline__ void dma_touch(const uint16_t* __restrict__ x,
                                          const uint8_t* __restrict__ packed,
                                          const uint16_t* __restrict__ scales,
                                          float* __restrict__ touch, int mode,
                                          int n, int K, int O, int block_kh,
                                          int tb) {
  const int KH = K / 2;
  const int r = mode >= kDma2d ? 8 : min(8, n);
  const int nk = KH / block_kh;
  const int srows = mode == kDmaI ? min(8, block_kh / kGroupRows) : block_kh / 32;
  const bool per_row = srows >= r;
  const int stride = tb * kDmaThreads;
  for (int idx = blockIdx.x * kDmaThreads + threadIdx.x; idx < n * O; idx += stride) {
    const int i = idx / O, c = idx - i * O;
    float o = 0.f;
    if (i < r) {
      const int si = per_row ? i : 0;
      const uint16_t* xr = x + static_cast<size_t>(i) * K;
#pragma unroll 8
      for (int k = 0; k < nk; ++k) {
        const float pv = static_cast<float>(
            packed[(static_cast<size_t>(k) * block_kh + i) * O + c]);
        float t;
        if (mode == kDmaPs) {
          const int g = k * (block_kh / 32) + si;
          t = __fadd_rn(__fadd_rn(pv, bf16_to_float(scales[static_cast<size_t>(g) * O + c])),
                        bf16_to_float(scales[static_cast<size_t>(KH / 32 + g) * O + c]));
          t = __fadd_rn(t, bf16_to_float(xr[0]));
        } else if (mode == kDma2d) {  // the whole array's scale row i, x column 0
          t = __fadd_rn(pv, bf16_to_float(scales[static_cast<size_t>(i) * O + c]));
          t = __fadd_rn(t, bf16_to_float(xr[0]));
        } else if (mode == kDmaBand) {  // the tile's scale row i, its first x
          const int g = k * (block_kh / 32) + i;
          t = __fadd_rn(pv, bf16_to_float(scales[static_cast<size_t>(g) * O + c]));
          t = __fadd_rn(t, bf16_to_float(xr[k * block_kh]));
        } else {
          const int g = k * (block_kh / kGroupRows) + si;
          t = __fadd_rn(pv, bf16_to_float(scales[static_cast<size_t>(g) * O + c]));
          t = __fadd_rn(t, bf16_to_float(xr[2 * k * block_kh]));
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
               int mode, int n, int K, int O, int block_kh, int tb) {
  __shared__ __align__(16) int red[kDmaThreads * 16];
  if (static_cast<int>(blockIdx.x) < tb) {
    dma_touch(x, packed, scales, touch, mode, n, K, O, block_kh, tb);
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

// K12: math is the index in LAB_MATHS, layout the index in _KERNEL_LAYOUTS;
// xsum only for pairC, il (and n_layers) only for "v2"; the layouts other
// than "i" take f32x only.
extern "C" int q4_lab_gemv_launch(const void* x, const void* xsum,
                                  const void* packed, const void* scales,
                                  const void* il, int n_layers, void* partial,
                                  void* out, int n, int K, int O, int splits,
                                  int math, int layout, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > 32 || K % 32 || O % 4 || splits < 1 || math < 0 ||
      math >= kNumMaths || (math == kPairC) != (xsum != nullptr) ||
      layout < kLayI || layout > kLayV2 ||
      (layout != kLayI && math != kF32x) ||
      (layout == kLayPs && K % 64) || (layout == kLayV2) != (il != nullptr) ||
      (layout == kLayV2 && n_layers < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const GemvArgs a{static_cast<const uint16_t*>(x),
                   static_cast<const uint16_t*>(xsum),
                   static_cast<const uint8_t*>(packed),
                   static_cast<const uint16_t*>(scales),
                   static_cast<const int*>(il), n_layers,
                   static_cast<float*>(partial), static_cast<float*>(out),
                   n, K, O, splits};
  switch (layout) {
    case kLayI: gemv_dispatch(math, a, s); break;
    case kLayW32: gemv_launch_rows<kF32x, kLayW32>(a, s); break;
    case kLayPs: gemv_launch_rows<kF32x, kLayPs>(a, s); break;
    default: gemv_launch_rows<kF32x, kLayV2>(a, s); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int total = n * O;
  lab_split_reduce_kernel<<<(total + 255) / 256, 256, 0, s>>>(a.partial, a.out,
                                                              total, splits);
  return static_cast<int>(cudaGetLastError());
}

// K13: mode is the touch's index in DMA_LAYOUTS ("i", "ps", "2d", "band");
// blocks: the checksum's blocks (the launch adds the touch's).
extern "C" int q4_lab_dma_launch(const void* x, const void* packed,
                                 const void* scales, void* touch,
                                 void* checksum, int mode, int n, int K, int O,
                                 int block_kh, int blocks, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > 128 || K % 32 || O % 16 || block_kh < 16 ||
      (K / 2) % block_kh || blocks < 1 || mode < kDmaI || mode > kDmaBand ||
      (mode != kDmaI && block_kh % 32) || (mode >= kDma2d && n < 8) ||
      (mode == kDmaBand && block_kh < 256) || (mode == kDma2d && K < 256))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(checksum, 0, sizeof(int) * 2 * O, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // two touched elements a thread
  const int tb = (min(8, n) * O + 2 * kDmaThreads - 1) / (2 * kDmaThreads);
  lab_dma_kernel<<<tb + blocks, kDmaThreads, 0, s>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const uint16_t*>(scales), static_cast<float*>(touch),
      static_cast<int*>(checksum), mode, n, K, O, block_kh, tb);
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
