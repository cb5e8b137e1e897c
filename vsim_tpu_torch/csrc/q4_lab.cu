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
// One kernel, templated on the dequant math (the table in
// vsim_tpu_torch/ops/q4_lab.py), so that the maths differ only in the
// instruction sequence that turns a nibble and its scale into a weight.
//
// Bound on the H100: the weight bytes (0.5625 B a parameter) at these n.
// Design: the tensor-core "i"-layout core of K9/K10 (q4_matmul_i.cu on
// q4_core.cuh), with the math's own sequence building the mma.sync weight
// operand in registers:
//
// * Thread (g, t) = (lane / 4, lane % 4) reads packed rows 4t .. 4t + 3 of
//   each 16-row group, 2J contiguous columns, so a warp reads 16J contiguous
//   bytes of a row; x is the n = 8 operand (rows past n zero), the weight
//   the 16-column one (columns 2Jg + 2j and 2Jg + 2j + 1 its rows g and
//   g + 8).  A unit of work is two groups (32 packed rows), the next unit's
//   loads in flight while one computes.
// * bf16 weights (i32, u16, f32x, f32b, pairA, pairB, pairC's w): one
//   register is a byte's k pair (2c, 2c + 1) of one column; m16n8k16 bf16
//   -> f32 takes rows 4t + 2h and 4t + 2h + 1 as its k pairs t and t + 4.
//   The products are exact, so only the sum order differs from the plain
//   version.  i32 converts and rounds each pair (cvt.rn.bf16x2), f32x and
//   f32b likewise from the 2^23 magic, u16 builds bf16 pairs of
//   neighbouring columns as it always did (dequant_bf16x2) and swaps their
//   halves into k pairs (two prmt), the pair maths take the byte's pair word
//   as the register.
// * f32 weights (f32xf, i32f, f32f): m16n8k8 TF32 -> f32, each packed row
//   one MMA (k slot t its element 2c, t + 4 its element 2c + 1, for A and
//   for x alike).  With bf16 scales every (v - 8) s holds at most 11
//   significant bits, so it is exact in TF32, and so is a bf16 x.  So is
//   f32f's weight, (2^23 + v) s + f32(-(2^23 + 8) s) rounded once: (v - 8) s
//   plus the second term's rounding error, a multiple of s's leading power
//   of two, still at most 11 bits, so it needs no split into two TF32 terms
//   (tests/test_torch_q4_lab.py checks every math's weight under every
//   finite bf16 scale).  Again only the sum order differs.
// * pairC adds its correction acc += (-136 xs) s after each group, as
//   before (-136 xs exact in f32).
// * The operand layouts are loaders of the same kernel: "i"; "w32" (a
//   [K/8, O] int32 weight whose word holds packed rows 4r' .. 4r' + 3 of one
//   column, pack_w32: thread t's four rows of a group are one word row,
//   byte-transposed into four "i" rows); "ps" (the plane-split repack, byte c
//   = elements c and K/2 + c, with raw x: the pair (x[c], x[K/2 + c]) built by
//   prmt and the lo/hi planes' scale rows c / 32 and K/64 + c / 32, one each
//   a unit); "v2" (a stacked "i" weight [L, K/2, O] whose layer the kernel
//   reads from an int32 on the device, clamped to [0, L) as K10 does).  "res"
//   is "i" with K never split across the grid (a cluster of one block,
//   ops/q4_lab.py:lab_plan; its 4 warps may split it inside a block at
//   n <= 8), in 64-column tiles a warp at every n so that its blocks fill
//   the card.
// * n <= 8 (one n-tile): J = 8, x read from global memory by row g's
//   threads; 9-32 rows (2 or 4 n-tiles): J = 4, x staged in shared memory
//   a unit ahead (cp.async; "ps" builds its pairs on the way), each weight
//   fragment run through every n-tile, all 4 warps on neighbouring columns.
// * K split over the block's warps and a cluster of up to 8 blocks; the
//   partials meet in (distributed) shared memory in a fixed order
//   (q4core::cluster_sum_store): one launch, no partials in HBM, no
//   atomics, the same bits run to run.  ops/q4_lab.py:lab_plan picks (NT,
//   wc, C) as K9's i_plan does.
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
#include "q4_core.cuh"

namespace {

namespace cg = cooperative_groups;

// the lab maths, in the order of vsim_tpu_torch/ops/q4_lab.py:LAB_MATHS
enum LabMath { kI32, kU16, kF32x, kF32f, kF32xf, kI32f, kF32b, kPairA, kPairB,
               kPairC, kNumMaths };

// K12's operand layouts, in the order of vsim_tpu_torch/ops/q4_lab.py:
// _KERNEL_LAYOUTS (kLayV2 launches the kLayI instances with a layer index;
// kLayRes reads as kLayI, in narrower column tiles at one n-tile)
enum LabLayout { kLayI, kLayW32, kLayPs, kLayV2, kLayRes };

constexpr int kGroupRows = 16;  // packed rows a scale row covers
constexpr int kGThreads = q4core::kThreads;  // K12: 4 warps a block
constexpr int kGWarps = q4core::kWarps;

// the maths whose weight is f32 (TF32 MMAs); the others build bf16
__host__ __device__ constexpr bool tf32_math(int m) {
  return m == kF32f || m == kF32xf || m == kI32f;
}

// Column pairs a thread takes at NT n-tiles of x: 2J columns (128 or 64 a
// warp, ops/q4_lab.py:lab_tile_o); "res" takes 64 at every NT, so that its
// unsplit K still fills the card with blocks
__host__ __device__ constexpr int lab_cols_j(int nt, int lay) {
  return nt == 1 && lay != kLayRes ? 8 : 4;
}

// prmt in inline PTX, as q4_matmul_i.cu writes it
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// The pair word of byte b: 0x43004300 | lo | hi << 16, bf16 128 + lo in the
// low half and 128 + hi in the high (pairA, pairC, K14); HI_FIRST swaps the
// nibbles (pairB).
template <bool HI_FIRST>
__device__ __forceinline__ uint32_t pair_word(uint32_t b) {
  const uint32_t bits = HI_FIRST ? (((b >> 4) & 0x0Fu) | ((b & 0x0Fu) << 16))
                                 : ((b & 0x0Fu) | ((b & 0xF0u) << 12));
  return bits | 0x43004300u;
}

// nibble v of byte ``byte`` of nib (each byte < 16) as 2^23 + v in f32 bits
__device__ __forceinline__ float magic(uint32_t nib, int byte) {
  return __uint_as_float(__byte_perm(nib, 0x4B000000u, 0x7440 + byte));
}

// the low (k = 0) or high (k = 1) bf16 of a pair as f32
__device__ __forceinline__ float half_f(uint32_t pair, int k) {
  return __uint_as_float(k ? pair & 0xFFFF0000u : pair << 16);
}

// Under a bf16 math M, the weight operands of columns 2j and 2j + 1 (bytes
// 2jj and 2jj + 1 of the row word w, jj = j & 1): each a bf16 pair (element
// 2c, element 2c + 1).  s2: the columns' bf16 scales (s_2j, s_2j+1); sh2:
// the high nibbles' ("ps": the hi plane's), else s2.
template <int M>
__device__ __forceinline__ void weights_bf16(uint32_t w, int jj, uint32_t s2,
                                             uint32_t sh2, uint32_t& a0,
                                             uint32_t& a1) {
  const uint32_t lo4 = w & 0x0F0F0F0Fu, hi4 = (w >> 4) & 0x0F0F0F0Fu;
  if constexpr (M == kU16) {
    // 0x4300 | v as bf16 (128 + v), minus 136, times s: bf16 pairs of the
    // two columns, one rounding (dequant_bf16x2), halves swapped into k pairs
    const uint32_t plo = jj ? dequant_bf16x2<2>(lo4, s2)
                            : dequant_bf16x2<0>(lo4, s2);
    const uint32_t phi = jj ? dequant_bf16x2<2>(hi4, s2)
                            : dequant_bf16x2<0>(hi4, s2);
    a0 = prmt(plo, phi, 0x5410);
    a1 = prmt(plo, phi, 0x7632);
    return;
  }
  uint32_t out[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int byte = 2 * jj + k;
    const float s = half_f(s2, k), sh = half_f(sh2, k);
    if constexpr (M == kI32) {
      // int subtract, convert, multiply, round to bf16
      const float we = static_cast<float>(static_cast<int>((w >> (8 * byte)) & 0xFu) - 8) * s;
      const float wo = static_cast<float>(static_cast<int>((w >> (8 * byte + 4)) & 0xFu) - 8) * s;
      out[k] = pack_bf16(we, wo);
    } else if constexpr (M == kF32x) {
      // 0x4B000000 | v (2^23 + v), minus 2^23 + 8, times s, round
      out[k] = pack_bf16((magic(lo4, byte) - 8388616.f) * s,
                         (magic(hi4, byte) - 8388616.f) * sh);
    } else if constexpr (M == kF32b) {
      // f32f's one fma, then round to bf16
      const float bexp = __fmul_rn(s, -8388616.f);
      out[k] = pack_bf16(__fmaf_rn(magic(lo4, byte), s, bexp),
                         __fmaf_rn(magic(hi4, byte), s, bexp));
    } else {
      // the byte's pair word: (128 + v - 136) s in one rounding (pairA,
      // pairB), (128 + v) s (pairC)
      const uint32_t u = pair_word<M == kPairB>((w >> (8 * byte)) & 0xFFu);
      const uint32_t tt = M == kPairC ? u
                                      : fma_bf16x2(u, 0x3F803F80u, 0xC308C308u);
      const uint32_t dup = __byte_perm(s2, 0u, k ? 0x3232 : 0x1010);
      out[k] = fma_bf16x2(tt, dup, 0x80008000u);
    }
  }
  a0 = out[0];
  a1 = out[1];
}

// Under an f32 math M, the weights of elements 2c (we) and 2c + 1 (wo) of
// columns 2j, 2j + 1 (k = 0, 1) of the row word w.
template <int M>
__device__ __forceinline__ void weights_f32(uint32_t w, int jj, uint32_t s2,
                                            float (&we)[2], float (&wo)[2]) {
  const uint32_t lo4 = w & 0x0F0F0F0Fu, hi4 = (w >> 4) & 0x0F0F0F0Fu;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int byte = 2 * jj + k;
    const float s = half_f(s2, k);
    if constexpr (M == kI32f) {  // int subtract, convert, multiply
      we[k] = static_cast<float>(static_cast<int>((w >> (8 * byte)) & 0xFu) - 8) * s;
      wo[k] = static_cast<float>(static_cast<int>((w >> (8 * byte + 4)) & 0xFu) - 8) * s;
    } else if constexpr (M == kF32xf) {  // the magic, minus 2^23 + 8, times s
      we[k] = (magic(lo4, byte) - 8388616.f) * s;
      wo[k] = (magic(hi4, byte) - 8388616.f) * s;
    } else {  // f32f: (2^23 + v) s + f32(-(2^23 + 8) s), one rounding
      const float bexp = __fmul_rn(s, -8388616.f);
      we[k] = __fmaf_rn(magic(lo4, byte), s, bexp);
      wo[k] = __fmaf_rn(magic(hi4, byte), s, bexp);
    }
  }
}

// A unit of one thread: rows 4t .. 4t + 3 of two groups, 2J columns, their
// scales, (NT = 1) x row g's pairs of those rows, (pairC) -136 xs.
template <int J, int NT>
struct LabUnit {
  uint32_t w[2][4][J / 2];  // [group][row 4t + i][word: columns 4e .. 4e + 3]
  uint32_t s[2][J];         // [group, or "ps" plane][pair j]: (s_2j, s_2j+1)
  uint32_t x[2][NT == 1 ? 4 : 1];  // [group][row 4t + i]: bf16 pair
  float xc[2][NT][2];       // pairC: -136 xs of x rows 8nt + 2t, 8nt + 2t + 1
};

template <int M, int LAY, int J, int NT>
__device__ __forceinline__ void load_unit(
    LabUnit<J, NT>& U, const uint16_t* __restrict__ x,
    const uint16_t* __restrict__ xsum, const uint8_t* __restrict__ packed,
    const uint16_t* __restrict__ scales, int u, int G, int n, int K, int O,
    int col, bool vec, int g, int t) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int grp = 2 * u + q;
    const bool ok = grp < G;  // K = 32 * odd: the last unit's second half
    if constexpr (LAY == kLayW32) {
      // word row 4 grp + t: a 16-byte word of 4 columns x 4 rows at a time
      const uint4* p = reinterpret_cast<const uint4*>(packed) +
                       (static_cast<size_t>(4 * grp + t) * O + col) / 4;
#pragma unroll
      for (int e = 0; e < J / 2; ++e) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (ok && col + 4 * e < O) v = q4core::ld_stream16(p + e);
        const uint32_t xy_lo = __byte_perm(v.x, v.y, 0x5140);  // x0 y0 x1 y1
        const uint32_t xy_hi = __byte_perm(v.x, v.y, 0x7362);  // x2 y2 x3 y3
        const uint32_t zw_lo = __byte_perm(v.z, v.w, 0x5140);
        const uint32_t zw_hi = __byte_perm(v.z, v.w, 0x7362);
        U.w[q][0][e] = __byte_perm(xy_lo, zw_lo, 0x5410);
        U.w[q][1][e] = __byte_perm(xy_lo, zw_lo, 0x7632);
        U.w[q][2][e] = __byte_perm(xy_hi, zw_hi, 0x5410);
        U.w[q][3][e] = __byte_perm(xy_hi, zw_hi, 0x7632);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint8_t* p =
            packed + static_cast<size_t>(grp * kGroupRows + 4 * t + i) * O + col;
        const unsigned int* pw = reinterpret_cast<const unsigned int*>(p);
        if (vec) {
          if constexpr (J == 8) {  // 16 bytes
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (ok && col < O) v = q4core::ld_stream16(p);
            U.w[q][i][0] = v.x;
            U.w[q][i][1] = v.y;
            U.w[q][i][2] = v.z;
            U.w[q][i][3] = v.w;
          } else {  // J = 4: 8 bytes
            uint2 v = make_uint2(0u, 0u);
            if (ok && col < O) v = __ldg(reinterpret_cast<const uint2*>(p));
            U.w[q][i][0] = v.x;
            U.w[q][i][1] = v.y;
          }
        } else {
#pragma unroll
          for (int e = 0; e < J / 2; ++e)
            U.w[q][i][e] = ok && col + 4 * e < O ? __ldg(pw + e) : 0u;
        }
      }
    }
    // the scales: row grp, or in "ps" row u of the lo plane (q = 0) and
    // row K/64 + u of the hi plane (q = 1), both for both groups
    const int srow = LAY == kLayPs ? (q == 0 ? u : G / 2 + u) : grp;
    const bool sok = LAY == kLayPs || ok;
    const uint16_t* s = scales + static_cast<size_t>(srow) * O + col;
    if (vec) {
#pragma unroll
      for (int e = 0; e < J / 4; ++e) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (sok && col + 8 * e < O)
          v = __ldg(reinterpret_cast<const uint4*>(s + 8 * e));
        U.s[q][4 * e] = v.x;
        U.s[q][4 * e + 1] = v.y;
        U.s[q][4 * e + 2] = v.z;
        U.s[q][4 * e + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < J / 2; ++e) {
        uint2 v = make_uint2(0u, 0u);
        if (sok && col + 4 * e < O)
          v = __ldg(reinterpret_cast<const uint2*>(s + 4 * e));
        U.s[q][2 * e] = v.x;
        U.s[q][2 * e + 1] = v.y;
      }
    }
    if constexpr (NT == 1) {  // x row g: the pairs of rows 4t .. 4t + 3
      const bool xok = ok && g < n;
      const uint16_t* xr = x + static_cast<size_t>(g < n ? g : 0) * K;
      if constexpr (LAY == kLayPs) {  // (x[c], x[K/2 + c])
        const int c0 = grp * kGroupRows + 4 * t;
        uint2 lo = make_uint2(0u, 0u), hi = lo;
        if (xok) {
          lo = __ldg(reinterpret_cast<const uint2*>(xr + c0));
          hi = __ldg(reinterpret_cast<const uint2*>(xr + K / 2 + c0));
        }
        U.x[q][0] = prmt(lo.x, hi.x, 0x5410);
        U.x[q][1] = prmt(lo.x, hi.x, 0x7632);
        U.x[q][2] = prmt(lo.y, hi.y, 0x5410);
        U.x[q][3] = prmt(lo.y, hi.y, 0x7632);
      } else {  // elements 8t .. 8t + 7 of the group
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (xok)
          v = __ldg(reinterpret_cast<const uint4*>(xr + grp * 32 + 8 * t));
        U.x[q][0] = v.x;
        U.x[q][1] = v.y;
        U.x[q][2] = v.z;
        U.x[q][3] = v.w;
      }
    }
    if constexpr (M == kPairC) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = 8 * nt + 2 * t + e;
          U.xc[q][nt][e] =
              ok && row < n
                  ? -136.f * bf16_to_float(xsum[static_cast<size_t>(row) * G + grp])
                  : 0.f;
        }
    }
  }
}

// Stage the rows of x of unit u for NT > 1: xs[group][row][32 values] as
// bf16 pairs in k order, rows past n and a missing group zero.  "i" and
// "w32" copy by cp.async (committed, not waited for); "ps" builds its
// (x[c], x[K/2 + c]) pairs on the way, synchronously.
template <int NR, int LAY>
__device__ __forceinline__ void stage_x(uint16_t* xs,
                                        const uint16_t* __restrict__ x, int u,
                                        int G, int n, int K) {
  for (int idx = threadIdx.x; idx < 8 * NR; idx += kGThreads) {
    const int c8 = idx & 3, row = (idx >> 2) & (NR - 1), q = idx / (4 * NR);
    const int grp = 2 * u + q;
    const bool ok = row < n && grp < G;
    uint16_t* dst = xs + (q * NR + row) * 32 + 8 * c8;
    if constexpr (LAY == kLayPs) {
      uint2 lo = make_uint2(0u, 0u), hi = lo;
      if (ok) {
        const uint16_t* xr =
            x + static_cast<size_t>(row) * K + grp * kGroupRows + 4 * c8;
        lo = __ldg(reinterpret_cast<const uint2*>(xr));
        hi = __ldg(reinterpret_cast<const uint2*>(xr + K / 2));
      }
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(prmt(lo.x, hi.x, 0x5410), prmt(lo.x, hi.x, 0x7632),
                     prmt(lo.y, hi.y, 0x5410), prmt(lo.y, hi.y, 0x7632));
    } else {
      const size_t k = ok ? static_cast<size_t>(row) * K + grp * 32 + 8 * c8 : 0;
      cp_async16(dst, x + k, ok);
    }
  }
  if constexpr (LAY != kLayPs) cp_async_commit();
}

// acc += a unit's products: x's pairs of each n-tile (from the unit's
// registers, or the staged copy xs), then column pair by column pair the
// math's weight operands, run through every n-tile; pairC's correction
// after each group.
template <int M, int LAY, int NT, int J>
__device__ __forceinline__ void compute_unit(float (&acc)[NT][J][4],
                                             const LabUnit<J, NT>& U,
                                             const uint16_t* xs, int g,
                                             int t) {
  constexpr int NR = 8 * NT;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    uint32_t xw[NT][4];  // [n-tile][row 4t + i]: x row 8nt + g's pair
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if constexpr (NT == 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) xw[0][i] = U.x[q][i];
      } else {
        const uint4 v = *reinterpret_cast<const uint4*>(
            xs + (q * NR + 8 * nt + g) * 32 + 8 * t);
        xw[nt][0] = v.x;
        xw[nt][1] = v.y;
        xw[nt][2] = v.z;
        xw[nt][3] = v.w;
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int jj = j & 1;
      const uint32_t s2 = U.s[LAY == kLayPs ? 0 : q][j];
      const uint32_t sh2 = U.s[LAY == kLayPs ? 1 : q][j];
      if constexpr (tf32_math(M)) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float we[2], wo[2];
          weights_f32<M>(U.w[q][i][j >> 1], jj, s2, we, wo);
          // A: (column 2j, k slot t = element 2c), (2j + 1, t),
          //    (2j, t + 4 = element 2c + 1), (2j + 1, t + 4)
          const uint32_t a[4] = {__float_as_uint(we[0]), __float_as_uint(we[1]),
                                 __float_as_uint(wo[0]), __float_as_uint(wo[1])};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_tf32(acc[nt][j], a, xw[nt][i] << 16, xw[nt][i] & 0xFFFF0000u);
        }
      } else {
        uint32_t a[2][4];  // [h]: rows 4t + 2h (k pair t), 4t + 2h + 1 (t + 4)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          weights_bf16<M>(U.w[q][2 * h][j >> 1], jj, s2, sh2, a[h][0], a[h][1]);
          weights_bf16<M>(U.w[q][2 * h + 1][j >> 1], jj, s2, sh2, a[h][2],
                          a[h][3]);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_bf16(acc[nt][j], a[0], xw[nt][0], xw[nt][1]);
          mma_bf16(acc[nt][j], a[1], xw[nt][2], xw[nt][3]);
        }
      }
    }
    if constexpr (M == kPairC) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const float s0 = half_f(U.s[q][j], 0), s1 = half_f(U.s[q][j], 1);
          acc[nt][j][0] = fmaf(U.xc[q][nt][0], s0, acc[nt][j][0]);
          acc[nt][j][1] = fmaf(U.xc[q][nt][1], s0, acc[nt][j][1]);
          acc[nt][j][2] = fmaf(U.xc[q][nt][0], s1, acc[nt][j][2]);
          acc[nt][j][3] = fmaf(U.xc[q][nt][1], s1, acc[nt][j][3]);
        }
    }
  }
}

template <int NT, int LAY>
constexpr size_t lab_smem() {
  constexpr int NR = 8 * NT, TW = 16 * lab_cols_j(NT, LAY);
  constexpr size_t xs = 2 * size_t(2) * NR * 32 * 2;
  constexpr size_t red = size_t(kGWarps) * NR * (TW + 4) * 4;
  return NT == 1 ? 0 : (xs > red ? xs : red);
}

// Launched as clusters of C blocks along x: cluster i owns column tiles
// [wc * i, wc * i + wc) of 16J columns each (wc = 1 << lwc; 4 when NT > 1).
// Splits take units round-robin.  vec: 16-byte weight loads (O % 16 == 0,
// 16-byte aligned weight and scales).
template <int M, int LAY, int NT>
__global__ void __launch_bounds__(kGThreads, 2)
lab_gemv_kernel(const uint16_t* __restrict__ x,      // [n, K] bf16
                const uint16_t* __restrict__ xsum,   // pairC: [n, K/32] bf16
                const uint8_t* __restrict__ packed,  // [(L,) K/2, O]; w32: [K/8, O] words
                const uint16_t* __restrict__ scales, // [(L,) K/32, O] bf16
                const int* __restrict__ il_ptr,      // v2: the layer, else null
                int n_layers, float* __restrict__ out,  // [n, O]
                int n, int K, int O, int lwc, int vec) {
  constexpr int J = lab_cols_j(NT, LAY), TW = 16 * J, NR = 8 * NT;
  __shared__ __align__(16) float red1[NT == 1 ? kGWarps * NR * (TW + 4) : 4];
  extern __shared__ __align__(16) uint4 dyn[];  // NT > 1: x, then partials
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  uint32_t cluster_id;
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(cluster_id));
  const int wc = 1 << lwc, wk = kGWarps >> lwc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int G = K / 32;  // Q4 groups
  if (il_ptr != nullptr) {  // v2: select the layer on the device
    const int il = min(max(*il_ptr, 0), n_layers - 1);
    packed += static_cast<size_t>(il) * (K / 2) * O;
    scales += static_cast<size_t>(il) * G * O;
  }
  const int tile0 = static_cast<int>(cluster_id) << lwc;
  const int wcol = (tile0 + (warp & (wc - 1))) * TW;
  const int col = wcol + 2 * J * g;
  const int units = (G + 1) >> 1;
  const int splits = C * wk;
  int u = rank * wk + (warp >> lwc);
  const int ue = NT > 1 || wcol < O ? units : u;
  uint16_t* xs0 = reinterpret_cast<uint16_t*>(dyn);
  uint16_t* xs1 = xs0 + 2 * NR * 32;

  float acc[NT][J][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // two register units, the next one's loads in flight while one computes;
  // NT > 1: two staged copies of x, each staged a unit ahead, one barrier a
  // unit (K9/K10's order)
  LabUnit<J, NT> A, B;
  if (u < ue) {
    load_unit<M, LAY, J, NT>(A, x, xsum, packed, scales, u, G, n, K, O, col,
                             vec, g, t);
    if constexpr (NT > 1) stage_x<NR, LAY>(xs0, x, u, G, n, K);
  }
  for (; u < ue; u += 2 * splits) {
    const int u1 = u + splits, u2 = u1 + splits;
    if (u1 < ue)
      load_unit<M, LAY, J, NT>(B, x, xsum, packed, scales, u1, G, n, K, O,
                               col, vec, g, t);
    if constexpr (NT > 1) {
      cp_async_wait<0>();
      __syncthreads();  // u's x is in xs0 for every warp; xs1 is free
      if (u1 < ue) stage_x<NR, LAY>(xs1, x, u1, G, n, K);
    }
    compute_unit<M, LAY, NT, J>(acc, A, xs0, g, t);
    if (u2 < ue)
      load_unit<M, LAY, J, NT>(A, x, xsum, packed, scales, u2, G, n, K, O,
                               col, vec, g, t);
    if (u1 < ue) {
      if constexpr (NT > 1) {
        cp_async_wait<0>();
        __syncthreads();  // u1's x is in xs1; xs0 is free
        if (u2 < ue) stage_x<NR, LAY>(xs0, x, u2, G, n, K);
      }
      compute_unit<M, LAY, NT, J>(acc, B, xs1, g, t);
    }
  }

  // acc[nt][j]: (column 2Jg + 2j, x row 8nt + 2t), (2Jg + 2j, 8nt + 2t + 1),
  //             (2Jg + 2j + 1, 8nt + 2t), (2Jg + 2j + 1, 8nt + 2t + 1)
  float* red = NT == 1 ? red1 : reinterpret_cast<float*>(dyn);
  if constexpr (NT > 1) __syncthreads();  // red overlays the staged x
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < J; ++j) {
      float* r = red + (warp * NR + 8 * nt + 2 * t) * (TW + 4) + 2 * J * g +
                 2 * j;
      *reinterpret_cast<float2*>(r) = make_float2(acc[nt][j][0], acc[nt][j][2]);
      *reinterpret_cast<float2*>(r + TW + 4) =
          make_float2(acc[nt][j][1], acc[nt][j][3]);
    }
  __syncthreads();
  q4core::cluster_sum_store<q4core::kActNone, TW, NR, TW + 4>(
      red, n, lwc, tile0 * TW, O, nullptr, out);
}

// The operands of a K12 launch.
struct GemvArgs {
  const uint16_t* x;
  const uint16_t* xsum;
  const uint8_t* packed;
  const uint16_t* scales;
  const int* il;
  int n_layers;
  float* out;
  int n, K, O, wc, C, vec;
  cudaStream_t stream;
};

// An instance's launch, and its clusters that fit on the card at once.
struct GemvLaunch {
  const GemvArgs& a;
  template <int M, int LAY, int NT>
  cudaError_t run() const {
    auto kern = lab_gemv_kernel<M, LAY, NT>;
    constexpr size_t smem = lab_smem<NT, LAY>();
    constexpr int TW = 16 * lab_cols_j(NT, LAY);
    const int tiles = (a.O + TW - 1) / TW;
    q4core::ClusterLaunch l(((tiles + a.wc - 1) / a.wc) * a.C, a.C, smem,
                            a.stream);
    const int lwc = a.wc == 4 ? 2 : a.wc - 1;
    return cudaLaunchKernelEx(&l.cfg, kern, a.x, a.xsum, a.packed, a.scales,
                              a.il, a.n_layers, a.out, a.n, a.K, a.O, lwc,
                              a.vec);
  }
};

struct GemvMaxClusters {
  int C;
  template <int M, int LAY, int NT>
  int run() const {
    return q4core::max_active_clusters(lab_gemv_kernel<M, LAY, NT>, C,
                                       lab_smem<NT, LAY>());
  }
};

template <int M, int LAY, class Op>
auto with_nt(const Op& op, int nt) {
  switch (nt) {
    case 1: return op.template run<M, LAY, 1>();
    case 2: return op.template run<M, LAY, 2>();
    default: return op.template run<M, LAY, 4>();
  }
}

// the "i" layout under math ``math``
template <int M = 0, class Op>
auto with_math(const Op& op, int math, int nt) {
  if constexpr (M + 1 < kNumMaths) {
    if (math != M) return with_math<M + 1>(op, math, nt);
  }
  return with_nt<M, kLayI>(op, nt);
}

// The instance of (math, layout, nt); every argument was checked.
template <class Op>
auto with_instance(const Op& op, int math, int layout, int nt) {
  switch (layout) {
    case kLayW32: return with_nt<kF32x, kLayW32>(op, nt);
    case kLayPs: return with_nt<kF32x, kLayPs>(op, nt);
    case kLayRes: return with_nt<kF32x, kLayRes>(op, nt);
    default: return with_math(op, math, nt);
  }
}

bool valid_lab_nt(int nt) { return nt == 1 || nt == 2 || nt == 4; }

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
// than "i" and "v2" take f32x only.  One launch under the plan (nt, wc,
// cluster) of ops/q4_lab.py:lab_plan ("res": a cluster of one).
extern "C" int q4_lab_gemv_launch(const void* x, const void* xsum,
                                  const void* packed, const void* scales,
                                  const void* il, int n_layers, void* out,
                                  int n, int K, int O, int math, int layout,
                                  int nt, int wc, int cluster, void* stream) {
  if (!valid_lab_nt(nt) || n < 1 || n > 8 * nt || K <= 0 || K % 32 ||
      O <= 0 || O % 4 || math < 0 || math >= kNumMaths ||
      (math == kPairC) != (xsum != nullptr) || layout < kLayI ||
      layout > kLayRes || (layout == kLayRes && cluster != 1) ||
      ((layout == kLayW32 || layout == kLayPs || layout == kLayRes) &&
       math != kF32x) ||
      (layout == kLayPs && K % 64) || (layout == kLayV2) != (il != nullptr) ||
      n_layers < 1 || cluster < 1 || cluster > 8 ||
      !(nt == 1 ? (wc == 1 || wc == 2 || wc == 4) : wc == 4))
    return static_cast<int>(cudaErrorInvalidValue);
  auto aligned16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const GemvArgs a{static_cast<const uint16_t*>(x),
                   static_cast<const uint16_t*>(xsum),
                   static_cast<const uint8_t*>(packed),
                   static_cast<const uint16_t*>(scales),
                   static_cast<const int*>(il), n_layers,
                   static_cast<float*>(out), n, K, O, wc, cluster,
                   O % 16 == 0 && aligned16(packed) && aligned16(scales),
                   static_cast<cudaStream_t>(stream)};
  const cudaError_t err = with_instance(GemvLaunch{a}, math, layout, nt);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of `cluster` blocks of an instance the card holds at once
// (ops/q4_lab.py's plan keeps a launch to one wave).
extern "C" int q4_lab_gemv_max_clusters(int math, int layout, int nt,
                                        int cluster) {
  if (!valid_lab_nt(nt) || cluster < 1 || cluster > 8 || math < 0 ||
      math >= kNumMaths || layout < kLayI || layout > kLayRes)
    return 0;
  return with_instance(GemvMaxClusters{cluster}, math, layout, nt);
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
