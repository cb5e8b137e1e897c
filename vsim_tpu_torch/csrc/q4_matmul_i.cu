// K9 q4_matmul_i and K10 q4_matmul_stacked: y[n, O] = x[n, K] . W^T (+ bias)
// for an interleaved ("i" layout) Q4_0 weight, n <= 128 rows of bf16 or f32
// activations.  K10 takes a stacked [L, K/2, O] weight and reads the layer
// index il from an int32 on the device (clamped to [0, L)), so a decode step
// neither slices a layer nor syncs with the host.
//
// Replaces vsim_tpu/ops/pallas_q4.py:_kernel (:110, pallas_q4_matmul: the lm
// head of the stacked engine and any per-layer "i" weight) and
// _kernel_stacked (:953, pallas_q4_matmul_stacked: qkv, wo, fc and proj of
// the stacked-layer engine, il by scalar prefetch), with _dequant_planes
// (:84): packed byte c holds elements 2c (low nibble) and 2c + 1 (high
// nibble), both under scale row c / 16, each dequantized to (v - 8) * s.
// Two contracts (ops/matmul.py:stacked_round_planes; K9 always the first):
//   f32 planes: x . ((v - 8) s) in f32;
//   bf16 planes (ROUND: K10 under the i32/f32x maths): the planes and x
//   rounded to bf16 as the Pallas kernel casts them, the products summed in
//   f32.
//
// Bound on the H100: the weight bytes (0.5625 B a parameter) at decode; the
// multiply-adds at 128 rows.  The design is K1's core (q4_core.cuh) in the
// "i" layout:
//
// * mma.sync m16n8k16 bf16 -> f32: the weight is the 16-column operand, x
//   the n = 8 one (rows past n zero).  A byte is one register of the weight
//   operand, the k pair (2c, 2c + 1) of one column: one prmt of a word and
//   the word shifted right by 4 puts the low nibbles of two neighbouring
//   bytes at bits 0-3 and 8-11 and their high ones at bits 16-19 and
//   24-27; a lop3 (of it, or of it shifted by 8) sets exponent 0x43 (bf16
//   128 + v) and fma.rn.bf16x2 subtracts 136: v - 8, exact, no conversion
//   instruction.  f32 planes: a fresh f32 fragment sums each 16-row Q4 group
//   (two k16 MMAs) and s * fragment is added after, as K1 does; f32 x enters
//   as three bf16 pieces (q4core::split3), the smallest first.  bf16 planes:
//   mul.rn.bf16x2 of (v - 8) and (s, s) is the plain version's plane bit for
//   bit (the f32 product is exact, so its one rounding is the plane's), x is
//   rounded to bf16, and one f32 accumulator runs across the groups.
// * Thread (g, t) = (lane / 4, lane % 4) reads rows 4t .. 4t + 3 of a group,
//   2J contiguous bytes of each, so a warp reads 16J contiguous bytes of a
//   row.  MMA (h, j) takes rows 4t + 2h and 4t + 2h + 1 as the k pairs t and
//   t + 4 (which rows share an MMA is free inside a group) and columns
//   2Jg + 2j and 2Jg + 2j + 1 as the operand rows g and g + 8, so x's
//   operand for a group is x[8t .. 8t + 7]: one 16-byte load.  A unit of
//   work is two groups (32 packed rows, 64 values of K); for K = 32 * odd
//   the last unit holds one, its second half loaded as zeros.  The next
//   unit's loads are in flight while one computes.
// * n <= 8 (NT = 1 n-tile): K1's geometry.  J = 8 (a warp takes 128
//   columns, 16 bytes a thread a row), row g's threads read x from global
//   memory, K is split over the block's 4 warps and a cluster of up to 8
//   blocks, and nothing synchronises before the end.
// * 9-128 rows (NT = 2, 4, 8 or 16 n-tiles of 8 rows): one read of the
//   weight.  A weight fragment is dequantized once and run through every
//   n-tile.  The unit's rows of x are staged in shared memory as bf16 pieces
//   (copied by cp.async, or rounded or split in three), in two copies, a
//   unit ahead, one barrier a unit, and read back 16 bytes a thread a
//   tile.  A warp takes fewer columns as n grows (J = 4 up to 32 rows, 2
//   past), so its NT * J * 4 accumulators stay in registers.  The 4 warps of
//   a block take neighbouring columns and the same units; a cluster splits K.
// * The splits' partials meet in (distributed) shared memory
//   (q4core::cluster_sum_store): one launch, no atomics, no partials in HBM,
//   the same bits run to run.  ops/q4_cuda.py:i_plan picks (NT, wc, C) from
//   the shape and the card.
//
// VEC (NT = 1 only): 16-byte loads (O % 16 == 0 and 16-byte aligned
// weights); otherwise 4-byte words, each masked against O (O % 4 == 0).

#include "q4_core.cuh"

namespace {

namespace cg = cooperative_groups;
using q4core::kThreads;
using q4core::kWarps;

// Column pairs (one MMA each) a thread takes at NT n-tiles: 2J columns.
__host__ __device__ constexpr int cols_j(int nt) {
  return nt == 1 ? 8 : (nt <= 4 ? 4 : 2);
}

// The bf16 pieces x enters the MMAs as.
__host__ __device__ constexpr int pieces(bool xf32, bool round) {
  return xf32 && !round ? 3 : 1;
}

// prmt and q4core::nib_pair's lop3 in inline PTX: written in C++, this
// file's nibble code is rewritten by the compiler into more instructions,
// and the decode shapes ran slower on the H100.
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// The nibbles at bits 0-3 and 16-19 of u as the bf16 pair (v0 - 8, v1 - 8):
// 128 + v under exponent 0x43 (one lop3), minus 136 (exact).
__device__ __forceinline__ uint32_t nibs_bf16(uint32_t u) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n"  // (u & 0x000F000F) | 0x43004300
      : "=r"(r) : "r"(u), "r"(0x000F000Fu), "r"(0x43004300u));
  return fma_bf16x2(r, 0x3F803F80u, 0xC308C308u);
}

// A unit of one thread: rows 4t .. 4t + 3 of two groups, 2J columns, their
// scales, and (NT = 1) x[g][8t .. 8t + 7] of each group.
template <int J, int XW>
struct Unit {
  uint32_t w[2][4][J / 2];  // [group][row 4t + i][word]
  uint32_t s[2][J];         // [group][column pair j]: bf16 (s[2j], s[2j + 1])
  uint32_t x[2][XW];        // [group]: bf16 (XW = 4) or f32 (8) values
};

template <int J, int XW, bool VEC>
__device__ __forceinline__ void load_unit(
    Unit<J, XW>& U, const void* __restrict__ xv,
    const uint8_t* __restrict__ packed, const uint16_t* __restrict__ scales,
    int u, int G, int K, int O, int col, bool xrow_ok, int xrow, int t) {
  static_assert(!VEC || J == 8, "16-byte loads take 16 columns a thread");
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int grp = 2 * u + q;
    const bool ok = grp < G;  // K = 32 * odd: the last unit's second half
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint8_t* p =
          packed + static_cast<size_t>(grp * 16 + 4 * t + i) * O + col;
      if constexpr (VEC) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (ok && col < O) v = q4core::ld_stream16(p);
        U.w[q][i][0] = v.x;
        U.w[q][i][1] = v.y;
        U.w[q][i][2] = v.z;
        U.w[q][i][3] = v.w;
      } else {
        const unsigned int* pw = reinterpret_cast<const unsigned int*>(p);
#pragma unroll
        for (int e = 0; e < J / 2; ++e)
          U.w[q][i][e] = ok && col + 4 * e < O ? __ldg(pw + e) : 0u;
      }
    }
    const uint16_t* s = scales + static_cast<size_t>(grp) * O + col;
    if constexpr (VEC) {
      uint4 a = make_uint4(0u, 0u, 0u, 0u), b = a;
      if (ok && col < O) {
        a = __ldg(reinterpret_cast<const uint4*>(s));
        b = __ldg(reinterpret_cast<const uint4*>(s + 8));
      }
      U.s[q][0] = a.x; U.s[q][1] = a.y; U.s[q][2] = a.z; U.s[q][3] = a.w;
      U.s[q][4] = b.x; U.s[q][5] = b.y; U.s[q][6] = b.z; U.s[q][7] = b.w;
    } else {
#pragma unroll
      for (int e = 0; e < J / 2; ++e) {
        uint2 v = make_uint2(0u, 0u);
        if (ok && col + 4 * e < O)
          v = __ldg(reinterpret_cast<const uint2*>(s + 4 * e));
        U.s[q][2 * e] = v.x;
        U.s[q][2 * e + 1] = v.y;
      }
    }
    if constexpr (XW == 8) {
      const float4* p = reinterpret_cast<const float4*>(
          static_cast<const float*>(xv) + static_cast<size_t>(xrow) * K +
          grp * 32 + 8 * t);
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (xrow_ok && ok) {
        a = __ldg(p);
        b = __ldg(p + 1);
      }
      U.x[q][0] = __float_as_uint(a.x); U.x[q][1] = __float_as_uint(a.y);
      U.x[q][2] = __float_as_uint(a.z); U.x[q][3] = __float_as_uint(a.w);
      U.x[q][4] = __float_as_uint(b.x); U.x[q][5] = __float_as_uint(b.y);
      U.x[q][6] = __float_as_uint(b.z); U.x[q][7] = __float_as_uint(b.w);
    } else if constexpr (XW == 4) {
      uint4 a = make_uint4(0u, 0u, 0u, 0u);
      if (xrow_ok && ok)
        a = __ldg(reinterpret_cast<const uint4*>(
            static_cast<const uint16_t*>(xv) + static_cast<size_t>(xrow) * K +
            grp * 32 + 8 * t));
      U.x[q][0] = a.x; U.x[q][1] = a.y; U.x[q][2] = a.z; U.x[q][3] = a.w;
    }
  }
}

// x's operand of group q as P bf16 pieces, the smallest first: word 2h is
// the k pair t of MMA h, word 2h + 1 its k pair t + 4.
template <int P, bool XF32, bool ROUND>
__device__ __forceinline__ void x_pieces(uint32_t (&xb)[P][4],
                                         const uint32_t* x) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (!XF32) {
      xb[0][i] = x[i];
    } else if constexpr (ROUND) {
      xb[0][i] = pack_bf16(__uint_as_float(x[2 * i]),
                           __uint_as_float(x[2 * i + 1]));
    } else {
      uint32_t p[3];
      q4core::split3(__uint_as_float(x[2 * i]), __uint_as_float(x[2 * i + 1]),
                     p);
      xb[0][i] = p[2];
      xb[1][i] = p[1];
      xb[2][i] = p[0];
    }
  }
}

// The weight operands of column pair j of group q, both k16 halves;
// ROUND: each plane rounded to bf16 as the plain version's.
template <int J, int XW, bool ROUND>
__device__ __forceinline__ void weight_frags(uint32_t (&a)[2][4],
                                             const Unit<J, XW>& U, int q,
                                             int j) {
  // bytes b, b + 1 of a row's word and of it shifted right by 4: the low
  // nibbles of columns 2j, 2j + 1 at bits 0-3 and 8-11, their high ones at
  // bits 16-19 and 24-27
  const uint32_t sel = (j & 1) ? 0x7632u : 0x5410u;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t w0 = U.w[q][2 * h][j >> 1], w1 = U.w[q][2 * h + 1][j >> 1];
    const uint32_t p0 = prmt(w0, w0 >> 4, sel), p1 = prmt(w1, w1 >> 4, sel);
    a[h][0] = nibs_bf16(p0);       // column 2j, pair t
    a[h][1] = nibs_bf16(p0 >> 8);  // column 2j + 1, pair t
    a[h][2] = nibs_bf16(p1);       // column 2j, pair t + 4
    a[h][3] = nibs_bf16(p1 >> 8);  // column 2j + 1, pair t + 4
  }
  if constexpr (ROUND) {
    const uint32_t s0 = __byte_perm(U.s[q][j], 0u, 0x1010);  // (s_2j, s_2j)
    const uint32_t s1 = __byte_perm(U.s[q][j], 0u, 0x3232);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      a[h][0] = mul_bf16x2(a[h][0], s0);
      a[h][1] = mul_bf16x2(a[h][1], s1);
      a[h][2] = mul_bf16x2(a[h][2], s0);
      a[h][3] = mul_bf16x2(a[h][3], s1);
    }
  }
}

// acc (columns 2j, 2j + 1 by rows 2t, 2t + 1 of an n-tile) += the group's
// products; s2 the columns' bf16 scales
template <int P, bool ROUND>
__device__ __forceinline__ void mma_group(float (&acc)[4],
                                          const uint32_t (&a)[2][4],
                                          const uint32_t (&xb)[P][4],
                                          uint32_t s2) {
  if constexpr (ROUND) {
    mma_bf16(acc, a[0], xb[0][0], xb[0][1]);
    mma_bf16(acc, a[1], xb[0][2], xb[0][3]);
  } else {
    float f[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int p = 0; p < P; ++p)
        mma_bf16(f, a[h], xb[p][2 * h], xb[p][2 * h + 1]);
    float s0, s1;
    unpack_bf16x2(s2, s0, s1);
    acc[0] = fmaf(s0, f[0], acc[0]);
    acc[1] = fmaf(s0, f[1], acc[1]);
    acc[2] = fmaf(s1, f[2], acc[2]);
    acc[3] = fmaf(s1, f[3], acc[3]);
  }
}

// Stage the rows of x of unit u for NT > 1 as P bf16 pieces:
// xs[piece][group][row][32 values], rows past n and a missing group zero.
// bf16 x is copied by cp.async (committed, not waited for); f32 x is
// rounded or split on the way, synchronously.
template <int NR, int P, bool XF32>
__device__ __forceinline__ void stage_x(uint16_t* xs,
                                        const void* __restrict__ xv, int u,
                                        int G, int n, int K) {
  for (int idx = threadIdx.x; idx < 8 * NR; idx += kThreads) {
    const int c8 = idx & 3, row = (idx >> 2) & (NR - 1), q = idx / (4 * NR);
    const int grp = 2 * u + q;
    const bool ok = row < n && grp < G;
    const size_t k = ok ? static_cast<size_t>(row) * K + grp * 32 + 8 * c8 : 0;
    if constexpr (!XF32) {
      cp_async16(xs + (q * NR + row) * 32 + 8 * c8,
                 static_cast<const uint16_t*>(xv) + k, ok);
    } else {
      uint32_t v[P][4] = {};
      if (ok) {
        const float4* p =
            reinterpret_cast<const float4*>(static_cast<const float*>(xv) + k);
        const float4 a = __ldg(p), b = __ldg(p + 1);
        const float f[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (P == 1) {
            v[0][i] = pack_bf16(f[2 * i], f[2 * i + 1]);
          } else {
            uint32_t pc[3];
            q4core::split3(f[2 * i], f[2 * i + 1], pc);
            v[0][i] = pc[2];
            v[1][i] = pc[1];
            v[2][i] = pc[0];
          }
        }
      }
#pragma unroll
      for (int p = 0; p < P; ++p)
        *reinterpret_cast<uint4*>(xs + ((p * 2 + q) * NR + row) * 32 + 8 * c8) =
            make_uint4(v[p][0], v[p][1], v[p][2], v[p][3]);
    }
  }
  if constexpr (!XF32) cp_async_commit();
}

// acc += a unit's products.  NT = 1: x's operand from the unit's
// registers, each column pair's weight fragments made just before its MMAs;
// NT > 1: x from its staged copy xs, each weight fragment made once and run
// through every n-tile.
template <int NT, bool XF32, bool ROUND, int J, int XW>
__device__ __forceinline__ void compute_unit(float (&acc)[NT][J][4],
                                             const Unit<J, XW>& U,
                                             const uint16_t* xs, int g,
                                             int t) {
  constexpr int P = pieces(XF32, ROUND), NR = 8 * NT;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if constexpr (NT == 1) {
      uint32_t xb[P][4];
      x_pieces<P, XF32, ROUND>(xb, U.x[q]);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        uint32_t a[2][4];
        weight_frags<J, XW, ROUND>(a, U, q, j);
        mma_group<P, ROUND>(acc[0][j], a, xb, U.s[q][j]);
      }
    } else {
      uint32_t a[J][2][4];
#pragma unroll
      for (int j = 0; j < J; ++j) weight_frags<J, XW, ROUND>(a[j], U, q, j);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t xb[P][4];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const uint4 v = *reinterpret_cast<const uint4*>(
              xs + ((p * 2 + q) * NR + 8 * nt + g) * 32 + 8 * t);
          xb[p][0] = v.x; xb[p][1] = v.y; xb[p][2] = v.z; xb[p][3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < J; ++j)
          mma_group<P, ROUND>(acc[nt][j], a[j], xb, U.s[q][j]);
      }
    }
  }
}

template <int NT, bool XF32, bool ROUND>
constexpr size_t dyn_smem() {
  constexpr int NR = 8 * NT, TW = 16 * cols_j(NT);
  constexpr size_t xs = 2 * size_t(pieces(XF32, ROUND)) * 2 * NR * 32 * 2;
  constexpr size_t red = size_t(kWarps) * NR * (TW + 4) * 4;
  return NT == 1 ? 0 : (xs > red ? xs : red);
}

// Launched as clusters of C blocks along x: cluster i owns column tiles
// [wc * i, wc * i + wc) of 16J columns each (wc = 1 << lwc; 4 when NT > 1).
// Splits take units round-robin: no runtime integer divide.
template <int NT, bool XF32, bool ROUND, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
q4_i_kernel(const void* __restrict__ x,            // [n, K] bf16 or f32
            const uint8_t* __restrict__ packed,    // [(L,) K/2, O]
            const uint16_t* __restrict__ scales,   // [(L,) K/32, O] bf16
            const int* __restrict__ il_ptr,        // K10's layer, or null
            int n_layers,
            const float* __restrict__ bias,        // [O] or null
            float* __restrict__ out,               // [n, O]
            int n, int K, int O, int lwc) {
  constexpr int J = cols_j(NT), TW = 16 * J, NR = 8 * NT;
  constexpr int P = pieces(XF32, ROUND);
  constexpr int XW = NT > 1 ? 1 : (XF32 ? 8 : 4);
  __shared__ __align__(16) float red1[NT == 1 ? kWarps * NR * (TW + 4) : 4];
  extern __shared__ __align__(16) uint4 dyn[];  // NT > 1: x, then partials
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  uint32_t cluster_id;
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(cluster_id));
  const int wc = 1 << lwc, wk = kWarps >> lwc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int G = K / 32;  // Q4 groups
  if (il_ptr != nullptr) {  // K10: select the layer on the device
    const int il = min(max(*il_ptr, 0), n_layers - 1);
    packed += static_cast<size_t>(il) * (K / 2) * O;
    scales += static_cast<size_t>(il) * G * O;
  }
  const int tile0 = static_cast<int>(cluster_id) << lwc;
  const int wcol = (tile0 + (warp & (wc - 1))) * TW;
  const int col = wcol + 2 * J * g;
  const int units = (G + 1) >> 1;
  // split s of C * wk takes units s, s + splits, s + 2 splits, ...; when
  // NT > 1 every warp of a block has the same split (wk = 1) and stages x
  const int splits = C * wk;
  int u = rank * wk + (warp >> lwc);
  const int ue = NT > 1 || wcol < O ? units : u;
  const bool xrow_ok = g < n;
  const int xrow = xrow_ok ? g : 0;
  uint16_t* xs = reinterpret_cast<uint16_t*>(dyn);

  float acc[NT][J][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // two register units: the next unit's loads in flight while one
  // computes.  NT > 1: two staged copies of x, A's unit's in xs0 and B's in
  // xs1, each staged a unit ahead; one barrier a unit.
  uint16_t* xs0 = xs;
  uint16_t* xs1 = xs + P * 2 * NR * 32;
  Unit<J, XW> A, B;
  if (u < ue) {
    load_unit<J, XW, VEC>(A, x, packed, scales, u, G, K, O, col, xrow_ok,
                          xrow, t);
    if constexpr (NT > 1) stage_x<NR, P, XF32>(xs0, x, u, G, n, K);
  }
  for (; u < ue; u += 2 * splits) {
    const int u1 = u + splits, u2 = u1 + splits;
    if (u1 < ue)
      load_unit<J, XW, VEC>(B, x, packed, scales, u1, G, K, O, col, xrow_ok,
                            xrow, t);
    if constexpr (NT > 1) {
      cp_async_wait<0>();
      __syncthreads();  // u's x is in xs0 for every warp; xs1 is free
      if (u1 < ue) stage_x<NR, P, XF32>(xs1, x, u1, G, n, K);
    }
    compute_unit<NT, XF32, ROUND>(acc, A, xs0, g, t);
    if (u2 < ue)
      load_unit<J, XW, VEC>(A, x, packed, scales, u2, G, K, O, col, xrow_ok,
                            xrow, t);
    if (u1 < ue) {
      if constexpr (NT > 1) {
        cp_async_wait<0>();
        __syncthreads();  // u1's x is in xs1; xs0 is free
        if (u2 < ue) stage_x<NR, P, XF32>(xs0, x, u2, G, n, K);
      }
      compute_unit<NT, XF32, ROUND>(acc, B, xs1, g, t);
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
      red, n, lwc, tile0 * TW, O, bias, out);
}

struct Args {
  const void* x;
  const uint8_t* packed;
  const uint16_t* scales;
  const int* il;
  int n_layers;
  const float* bias;
  float* out;
  int n, K, O, wc, C;
  cudaStream_t stream;
};

// An instance's launch, and its clusters that fit on the card at once.
struct Launch {
  const Args& a;
  template <int NT, bool XF32, bool ROUND, bool VEC>
  cudaError_t run() const {
    auto kern = q4_i_kernel<NT, XF32, ROUND, VEC>;
    constexpr size_t smem = dyn_smem<NT, XF32, ROUND>();
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
    constexpr int TW = 16 * cols_j(NT);
    const int tiles = (a.O + TW - 1) / TW;
    q4core::ClusterLaunch l(((tiles + a.wc - 1) / a.wc) * a.C, a.C, smem,
                            a.stream);
    const int lwc = a.wc == 4 ? 2 : a.wc - 1;
    return cudaLaunchKernelEx(&l.cfg, kern, a.x, a.packed, a.scales, a.il,
                              a.n_layers, a.bias, a.out, a.n, a.K, a.O, lwc);
  }
};

struct MaxClusters {
  int C;
  template <int NT, bool XF32, bool ROUND, bool VEC>
  int run() const {
    auto kern = q4_i_kernel<NT, XF32, ROUND, VEC>;
    constexpr size_t smem = dyn_smem<NT, XF32, ROUND>();
    if (smem > 48 * 1024 &&
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess) {
      cudaGetLastError();
      return 0;
    }
    return q4core::max_active_clusters(kern, C, smem);
  }
};

template <int NT, bool XF32, bool ROUND, class Op>
auto with_vec(const Op& op, bool vec) {
  if constexpr (NT == 1) {
    if (vec) return op.template run<NT, XF32, ROUND, true>();
  }
  return op.template run<NT, XF32, ROUND, false>();
}

template <int NT, class Op>
auto with_contract(const Op& op, bool xf32, bool round, bool vec) {
  if (xf32)
    return round ? with_vec<NT, true, true>(op, vec)
                 : with_vec<NT, true, false>(op, vec);
  return round ? with_vec<NT, false, true>(op, vec)
               : with_vec<NT, false, false>(op, vec);
}

// The instance of (nt, x dtype, contract, VEC); nt was checked.
template <class Op>
auto with_instance(const Op& op, int nt, bool xf32, bool round, bool vec) {
  switch (nt) {
    case 1: return with_contract<1>(op, xf32, round, vec);
    case 2: return with_contract<2>(op, xf32, round, vec);
    case 4: return with_contract<4>(op, xf32, round, vec);
    case 8: return with_contract<8>(op, xf32, round, vec);
    default: return with_contract<16>(op, xf32, round, vec);
  }
}

bool valid_nt(int nt) {
  return nt == 1 || nt == 2 || nt == 4 || nt == 8 || nt == 16;
}

}  // namespace

// K9 (il null, n_layers 1, round_planes 0) and K10 (layer *il of a stacked
// [n_layers, K/2, O] weight): one launch under the plan (nt, wc, cluster).
extern "C" int q4_matmul_i_launch(const void* x, int x_is_bf16,
                                  const void* packed, const void* scales,
                                  const void* il, int n_layers,
                                  const void* bias, void* out, int n, int K,
                                  int O, int nt, int wc, int cluster,
                                  int round_planes, void* stream) {
  if (!valid_nt(nt) || n < 1 || n > 8 * nt || K <= 0 || K % 32 || O <= 0 ||
      O % 4 || n_layers < 1 || cluster < 1 || cluster > 8 ||
      !(nt == 1 ? (wc == 1 || wc == 2 || wc == 4) : wc == 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, static_cast<const uint8_t*>(packed),
               static_cast<const uint16_t*>(scales),
               static_cast<const int*>(il), n_layers,
               static_cast<const float*>(bias), static_cast<float*>(out), n,
               K, O, wc, cluster, static_cast<cudaStream_t>(stream)};
  const bool vec = O % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(packed) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(scales) % 16 == 0;
  const cudaError_t err =
      with_instance(Launch{a}, nt, !x_is_bf16, round_planes != 0, vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of `cluster` blocks of an instance the card holds at once
// (ops/q4_cuda.py's plan keeps a launch to one wave).
extern "C" int q4_matmul_i_max_clusters(int nt, int x_is_bf16,
                                        int round_planes, int cluster) {
  if (!valid_nt(nt) || cluster < 1 || cluster > 8) return 0;
  return with_instance(MaxClusters{cluster}, nt, !x_is_bf16,
                       round_planes != 0, true);
}
