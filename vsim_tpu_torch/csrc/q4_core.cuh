// The plane-split Q4 core of K1 (q4_gemv_ps.cu) and K11 (q4_mlp_ps.cu):
//   out[n, O] = act(x[n, K] . W + bias),  n <= 8,
// W plane-split Q4_0: packed [K/2, O] (row c: element c in the low nibble,
// K/2 + c in the high one), bf16 scales [K/32, O] (rows g and K/64 + g for
// group g of each plane).
//
// Bound on the H100: the weight bytes (0.5625 B a parameter; at n <= 8 a
// byte feeds at most 16 multiply-adds).  The design spends no conversion
// instruction on a nibble and keeps the f32 partial sums of a split K on
// the chip:
//
// * mma.sync m16n8k16 bf16 -> f32 at every n from 1 to 8: x (rows past n
//   zero) is the n = 8 operand, 16 output columns x 16 packed rows of one
//   plane the weight operand, as v - 8 in bf16, exact: a nibble under
//   exponent 0x43 is bf16 128 + v (one prmt for the k pair, one lop3), and
//   fma.rn.bf16x2 subtracts 136.  Every product is exact.  A fresh f32
//   fragment sums each 32-row group of each plane (lo and hi apart: their
//   scales differ), and s[g] * fragment is added to the output in f32.
// * f32 x (XF32) enters as three bf16 pieces x = b1 + b2 + b3, exact for
//   every normal f32 past 2^-110 (each piece takes the next 8 bits of the
//   significand), one MMA a piece, the smallest first: (v - 8) b_i is exact.
// * The k pair a register holds (packed rows r, r + 1 of one column) comes
//   from the same byte of two rows' words: thread (g, t) = (lane / 4,
//   lane % 4) loads 16 contiguous bytes of packed rows 8t .. 8t + 7 of a
//   group, so a warp's load is 128 contiguous bytes of a row and g owns
//   columns 16g .. 16g + 15 of the warp's 128.  The group's two MMAs (k =
//   16) take rows 8t + 4h + {0, 1, 2, 3} (h = 0, 1) as the k pairs 2t and
//   2t + 8 (the sum over a group does not care which rows share an MMA),
//   so x's operand for both is one 16-byte load of x[8t .. 8t + 7] a plane.
//   MMA j pairs columns 2j and 2j + 1 as the rows g and g + 8 of the weight
//   operand.  128 bytes of weight a thread a group, the next group's loads
//   in flight while one computes.
// * Split K without HBM: a block is 4 warps of 128 columns each, WC column
//   tiles by 4 / WC splits of K; the C blocks of a thread-block cluster
//   split K further (split s of S takes groups s, s + S, ...).  Each warp
//   parks its [8, 128] f32 partial in shared memory, and each block sums
//   its warps'; after a cluster barrier every block sums a slice of the
//   cluster's outputs over the cluster's blocks through distributed shared
//   memory, in a fixed order (the same bits run to run, no atomics), adds
//   the bias, applies act and stores rows < n.
//   ops/q4_cuda.py:core_plan picks (WC, C) from the shape and the card.
//
// VEC: 16-byte loads (O % 16 == 0 and 16-byte aligned weights); otherwise
// 4-byte words, each masked against O (O % 4 == 0).
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace q4core {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileO = 128;    // output columns a warp
constexpr int kRows = 8;       // x rows: n padded to the MMA's n = 8
constexpr int kRedStride = kTileO + 4;
static_assert(kThreads == kTileO, "thread c of a block owns column c");

enum { kActNone = -1, kGeluTanh = 0, kRelu = 1, kGeluExact = 2 };

// Abramowitz-Stegun 7.1.26, as pallas_q4.py:_erf_poly (|err| <= 1.5e-7)
__device__ __forceinline__ float erf_poly(float x) {
  const float ax = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * ax);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float y = 1.0f - poly * expf(-ax * ax);
  return x < 0.f ? -y : y;
}

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if (ACT == kGeluTanh)
    return 0.5f * v *
           (1.0f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
  if (ACT == kRelu) return fmaxf(v, 0.f);
  if (ACT == kGeluExact)
    return 0.5f * v * (1.0f + erf_poly(v * 0.7071067811865476f));
  return v;
}

// 16 bytes of a streamed weight: read once, kept out of L1
__device__ __forceinline__ uint4 ld_stream16(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t word_of(const uint4& u, int i) {
  return i == 0 ? u.x : (i == 1 ? u.y : (i == 2 ? u.z : u.w));
}

// The nibbles in bits 0-3 and 16-19 of u as the bf16 pair (v0 - 8, v1 - 8):
// 128 + v under exponent 0x43 (one lop3), minus 136 (exact).
__device__ __forceinline__ uint32_t nib_pair(uint32_t u) {
  return fma_bf16x2((u & 0x000F000Fu) | 0x43004300u, 0x3F803F80u,
                    0xC308C308u);
}

// The bf16 pieces of two f32 values, x = b1 + b2 + b3 (pairs, lo first)
__device__ __forceinline__ void split3(float a, float b, uint32_t (&p)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p[i] = pack_bf16(a, b);
    float ha, hb;
    unpack_bf16x2(p[i], ha, hb);
    a -= ha;
    b -= hb;
  }
}

// One group (32 packed rows of each plane) of one thread: weight words,
// scale pairs, x pairs.  XF32: x as f32 pairs, split at use.
template <bool XF32>
struct Group {
  uint4 w[8];            // [h][q]: packed row 8t + 4h + q
  uint32_t s[2][8];      // [plane][column pair j]: bf16 (s[2j], s[2j + 1])
  uint32_t x[2][2][2][XF32 ? 2 : 1];  // [plane][h][k pair 2t / 2t + 8]
};

template <bool XF32, bool VEC>
__device__ __forceinline__ void load_group(
    Group<XF32>& G, const void* __restrict__ xv,
    const uint8_t* __restrict__ packed, const uint16_t* __restrict__ scales,
    int grp, int groups, int K, int O, int col, bool xrow_ok, int xrow,
    int t) {
  const int half_k = K / 2;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = grp * 32 + 8 * t + 4 * h + q;
      const uint8_t* p = packed + static_cast<size_t>(r) * O + col;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (VEC) {
        if (col < O) u = ld_stream16(p);
      } else {
        const unsigned int* pw = reinterpret_cast<const unsigned int*>(p);
        if (col < O) u.x = __ldg(pw);
        if (col + 4 < O) u.y = __ldg(pw + 1);
        if (col + 8 < O) u.z = __ldg(pw + 2);
        if (col + 12 < O) u.w = __ldg(pw + 3);
      }
      G.w[h * 4 + q] = u;
    }
#pragma unroll
  for (int pl = 0; pl < 2; ++pl) {
    const uint16_t* s =
        scales + static_cast<size_t>(pl * groups + grp) * O + col;
    if (VEC) {
      uint4 a = make_uint4(0u, 0u, 0u, 0u), b = a;
      if (col < O) {
        a = __ldg(reinterpret_cast<const uint4*>(s));
        b = __ldg(reinterpret_cast<const uint4*>(s + 8));
      }
      G.s[pl][0] = a.x; G.s[pl][1] = a.y; G.s[pl][2] = a.z; G.s[pl][3] = a.w;
      G.s[pl][4] = b.x; G.s[pl][5] = b.y; G.s[pl][6] = b.z; G.s[pl][7] = b.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint2 v = make_uint2(0u, 0u);
        if (col + 4 * i < O)
          v = __ldg(reinterpret_cast<const uint2*>(s + 4 * i));
        G.s[pl][2 * i] = v.x;
        G.s[pl][2 * i + 1] = v.y;
      }
    }
  }
  // x[8t .. 8t + 7] of the group in each plane: pairs (0, 1), (2, 3) are
  // half 0's k pairs 2t and 2t + 8, pairs (4, 5), (6, 7) half 1's
#pragma unroll
  for (int pl = 0; pl < 2; ++pl) {
    const size_t k = static_cast<size_t>(xrow) * K + pl * half_k + grp * 32 +
                     8 * t;
    if constexpr (XF32) {
      const float4* p = reinterpret_cast<const float4*>(
          static_cast<const float*>(xv) + k);
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (xrow_ok) {
        a = __ldg(p);
        b = __ldg(p + 1);
      }
      G.x[pl][0][0][0] = __float_as_uint(a.x);
      G.x[pl][0][0][1] = __float_as_uint(a.y);
      G.x[pl][0][1][0] = __float_as_uint(a.z);
      G.x[pl][0][1][1] = __float_as_uint(a.w);
      G.x[pl][1][0][0] = __float_as_uint(b.x);
      G.x[pl][1][0][1] = __float_as_uint(b.y);
      G.x[pl][1][1][0] = __float_as_uint(b.z);
      G.x[pl][1][1][1] = __float_as_uint(b.w);
    } else {
      uint4 a = make_uint4(0u, 0u, 0u, 0u);
      if (xrow_ok)
        a = __ldg(reinterpret_cast<const uint4*>(
            static_cast<const uint16_t*>(xv) + k));
      G.x[pl][0][0][0] = a.x;
      G.x[pl][0][1][0] = a.y;
      G.x[pl][1][0][0] = a.z;
      G.x[pl][1][1][0] = a.w;
    }
  }
}

// acc[j] += s_lo (sum of the group's lo products) + s_hi (hi products);
// for f32 x, one MMA a bf16 piece, the smallest first
template <bool XF32>
__device__ __forceinline__ void compute_group(const Group<XF32>& G,
                                              float (&acc)[8][4]) {
  constexpr int P = XF32 ? 3 : 1;
  uint32_t xb[2][2][2][P];  // [plane][half][k 2t / 2t + 8][piece]
#pragma unroll
  for (int pl = 0; pl < 2; ++pl)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        if constexpr (XF32) {
          uint32_t p[3];
          split3(__uint_as_float(G.x[pl][h][b][0]),
                 __uint_as_float(G.x[pl][h][b][1]), p);
#pragma unroll
          for (int i = 0; i < 3; ++i) xb[pl][h][b][i] = p[2 - i];
        } else {
          xb[pl][h][b][0] = G.x[pl][h][b][0];
        }
      }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float flo[4] = {0.f, 0.f, 0.f, 0.f}, fhi[4] = {0.f, 0.f, 0.f, 0.f};
    const uint32_t sel = (j & 1) ? 0x7632u : 0x5410u;  // bytes 2j%4, +1
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // bytes (2j, 2j + 1) of rows 8t + 4h + (0, 1) and + (2, 3)
      const uint32_t p01 = __byte_perm(word_of(G.w[h * 4 + 0], j >> 1),
                                       word_of(G.w[h * 4 + 1], j >> 1), sel);
      const uint32_t p23 = __byte_perm(word_of(G.w[h * 4 + 2], j >> 1),
                                       word_of(G.w[h * 4 + 3], j >> 1), sel);
      const uint32_t alo[4] = {nib_pair(p01), nib_pair(p01 >> 8),
                               nib_pair(p23), nib_pair(p23 >> 8)};
      const uint32_t ahi[4] = {nib_pair(p01 >> 4), nib_pair(p01 >> 12),
                               nib_pair(p23 >> 4), nib_pair(p23 >> 12)};
#pragma unroll
      for (int i = 0; i < P; ++i) {
        mma_bf16(flo, alo, xb[0][h][0][i], xb[0][h][1][i]);
        mma_bf16(fhi, ahi, xb[1][h][0][i], xb[1][h][1][i]);
      }
    }
    float sl0, sl1, sh0, sh1;
    unpack_bf16x2(G.s[0][j], sl0, sl1);
    unpack_bf16x2(G.s[1][j], sh0, sh1);
    acc[j][0] = fmaf(sh0, fhi[0], fmaf(sl0, flo[0], acc[j][0]));
    acc[j][1] = fmaf(sh0, fhi[1], fmaf(sl0, flo[1], acc[j][1]));
    acc[j][2] = fmaf(sh1, fhi[2], fmaf(sl1, flo[2], acc[j][2]));
    acc[j][3] = fmaf(sh1, fhi[3], fmaf(sl1, flo[3], acc[j][3]));
  }
}

// The end of a split of K over warps and a cluster, shared by every kernel
// on this core: red[w][row][c] (row stride STRIDE, ROWS rows a warp) holds
// warp w's partial sum of column c of its tile w & (wc - 1), split w >> lwc,
// and the block has synchronised since the warps stored them.  A line is
// one (row, tile) pair, line = row * wc + tile.  Each line is summed over
// the block's splits in split order into the first split's slot; then,
// after the cluster barrier, rank r sums lines r, r + C, ... over the
// cluster's blocks in rank order through distributed shared memory (their
// loads issued together), adds the bias, applies act and stores rows < n:
// out[row, col0 + tile * TW + c].  A fixed order: the same bits run to run.
template <int ACT, int TW, int ROWS, int STRIDE>
__device__ __forceinline__ void cluster_sum_store(
    float* red, int n, int lwc, int col0, int O, const float* __restrict__ bias,
    float* __restrict__ out) {
  static_assert(kThreads % TW == 0, "a pass covers whole lines");
  constexpr int kLines = kThreads / TW;  // lines a pass
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int wc = 1 << lwc, wk = kWarps >> lwc;
  const int c = threadIdx.x % TW, sub = threadIdx.x / TW;
  const int lines = n << lwc;
  auto slot = [&](int w, int row) {
    return red + (w * ROWS + row) * STRIDE + c;
  };
  for (int line = sub; line < lines; line += kLines) {
    const int row = line >> lwc, w = line & (wc - 1);
    float v = *slot(w, row);
    for (int s = 1; s < wk; ++s) v += *slot((s << lwc) + w, row);
    *slot(w, row) = v;
  }
  cluster.sync();
  for (int line = rank + C * sub; line < lines; line += C * kLines) {
    const int row = line >> lwc, w = line & (wc - 1);
    float part[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      part[r] = r < C ? cluster.map_shared_rank(slot(w, row), r)[0] : 0.f;
    float v = part[0];
#pragma unroll
    for (int r = 1; r < 8; ++r)
      if (r < C) v += part[r];
    const int ocol = col0 + w * TW + c;
    if (ocol < O) {
      if (bias) v += bias[ocol];
      out[static_cast<size_t>(row) * O + ocol] = activate<ACT>(v);
    }
  }
  cluster.sync();  // no block leaves while another reads its partials
}

// Launched as clusters of C blocks along x: cluster i owns column tiles
// [wc * i, wc * i + wc), 128 columns each; wc = 1 << lwc.  Two blocks an
// SM, at most 255 registers a thread (three blocks, 168 registers, spill).
// No integer divides a runtime value (each would cost an I2F): splits take
// groups round-robin.
template <bool XF32, int ACT, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
q4_core_kernel(const void* __restrict__ x,            // [n, K] bf16 or f32
               const uint8_t* __restrict__ packed,    // [K/2, O]
               const uint16_t* __restrict__ scales,   // [K/32, O] bf16
               const float* __restrict__ bias,        // [O] or null
               float* __restrict__ out,               // [n, O]
               int n, int K, int O, int lwc) {
  __shared__ __align__(16) float red[kWarps][kRows][kRedStride];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  uint32_t cluster_id;
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(cluster_id));
  const int wc = 1 << lwc, wk = kWarps >> lwc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int tile0 = static_cast<int>(cluster_id) << lwc;
  const int col0 = (tile0 + (warp & (wc - 1))) * kTileO;
  const int col = col0 + 16 * g;
  const int groups = K / 64;
  // split s of C * wk takes groups s, s + splits, s + 2 splits, ...
  const int splits = C * wk;
  int gb = rank * wk + (warp >> lwc);
  const int ge = col0 < O ? groups : gb;
  const bool xrow_ok = g < n;
  const int xrow = xrow_ok ? g : 0;

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // two register groups: the next group's loads in flight while one
  // computes
  Group<XF32> A, B;
  if (gb < ge)
    load_group<XF32, VEC>(A, x, packed, scales, gb, groups, K, O, col,
                          xrow_ok, xrow, t);
  for (; gb < ge; gb += 2 * splits) {
    const int g1 = gb + splits, g2 = g1 + splits;
    if (g1 < ge)
      load_group<XF32, VEC>(B, x, packed, scales, g1, groups, K, O, col,
                            xrow_ok, xrow, t);
    compute_group<XF32>(A, acc);
    if (g2 < ge)
      load_group<XF32, VEC>(A, x, packed, scales, g2, groups, K, O, col,
                            xrow_ok, xrow, t);
    if (g1 < ge) compute_group<XF32>(B, acc);
  }

  // acc[j]: (column 16g + 2j, x row 2t), (16g + 2j, 2t + 1),
  //         (16g + 2j + 1, 2t), (16g + 2j + 1, 2t + 1)
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<float2*>(&red[warp][2 * t][16 * g + 2 * j]) =
        make_float2(acc[j][0], acc[j][2]);
    *reinterpret_cast<float2*>(&red[warp][2 * t + 1][16 * g + 2 * j]) =
        make_float2(acc[j][1], acc[j][3]);
  }
  __syncthreads();
  cluster_sum_store<ACT, kTileO, kRows, kRedStride>(
      &red[0][0][0], n, lwc, tile0 * kTileO, O, bias, out);
}

// A launch of `blocks` blocks in clusters of C along x, with `smem` bytes of
// dynamic shared memory; cfg points into the object, so use it in place.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int blocks, int C, size_t smem, cudaStream_t stream) {
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// How many clusters of C blocks of `kernel` the card holds at once (0 on an
// error).
template <class Kernel>
inline int max_active_clusters(Kernel kernel, int C, size_t smem) {
  ClusterLaunch l(C, C, smem, nullptr);
  int count = 0;
  if (cudaOccupancyMaxActiveClusters(&count, kernel, &l.cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return count;
}

// Launch one instance on (wc, C); every argument was checked by the caller.
template <bool XF32, int ACT>
inline cudaError_t launch(const void* x, const uint8_t* packed,
                          const uint16_t* scales, const float* bias,
                          float* out, int n, int K, int O, int wc, int C,
                          cudaStream_t stream) {
  const bool vec = O % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(scales) % 16 == 0;
  const int tiles = (O + kTileO - 1) / kTileO;
  ClusterLaunch l(((tiles + wc - 1) / wc) * C, C, 0, stream);
  const int lwc = wc == 4 ? 2 : wc - 1;
  if (vec)
    return cudaLaunchKernelEx(&l.cfg, q4_core_kernel<XF32, ACT, true>, x,
                              packed, scales, bias, out, n, K, O, lwc);
  return cudaLaunchKernelEx(&l.cfg, q4_core_kernel<XF32, ACT, false>, x,
                            packed, scales, bias, out, n, K, O, lwc);
}

// How many clusters of C blocks the card holds at once (0 on an error).
template <bool XF32, int ACT>
inline int max_clusters(int C) {
  return max_active_clusters(q4_core_kernel<XF32, ACT, true>, C, 0);
}

inline bool valid(int n, int K, int O, int wc, int C) {
  return n >= 1 && n <= kRows && K > 0 && K % 64 == 0 && O > 0 && O % 4 == 0 &&
         (wc == 1 || wc == 2 || wc == 4) && C >= 1 && C <= 8;
}

}  // namespace q4core
