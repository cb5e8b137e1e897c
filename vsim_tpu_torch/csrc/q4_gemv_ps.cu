// K1 q4_gemv_ps: y[n, O] = x[n, K] . W^T (+ bias) for a plane-split Q4_0
// weight, n <= 8 rows of bf16 activations (the decode matmuls).
//
// Replaces vsim_tpu/ops/pallas_q4.py:_kernel_ps_giw (:339, the qkv/wo/fc/
// proj decode matmuls) and _kernel_ps_gi / _kernel_ps_gi_bias (:293, :315,
// the lm head), with the grouped-integer ("gi") math: per 32-row group g
// and plane, the sum of x (v - 8) over exact products, times the group's
// scale, where _gi_rescale (pallas_q4.py:280) writes
//   s_lo[g] (sum x_lo v_lo - 8 sum x_lo) + s_hi[g] (sum x_hi v_hi - 8 sum x_hi);
// only the order of the f32 sums differs.  x is bf16 on entry, so the kernel
// sees the bf16-rounded x that _gi_rescale sees.
//
// Bound on the H100: the weight bytes.  The design is the Q4 core of
// q4_core.cuh: mma.sync on nibbles made bf16 without a conversion
// instruction, 128 bytes a thread a group with the next group's loads in
// flight, and K split over the warps of a block and the blocks of a
// cluster, the partial sums meeting in distributed shared memory: one
// launch, no partials in HBM.
//
// 9-32 rows (the giw kernel's own domain, N <= 32 at pallas_q4.py:420; the
// router keeps K1 at n <= 8 and sends more rows to K2): a second instance,
// rows::kernel below, after K9/K10's 9-128-row design (q4_matmul_i.cu) in
// the "ps" layout.  NT = 2 or 4 n-tiles of 8 rows (24 rows pad to 32).  The
// group's rows of x are staged in shared memory as bf16 by cp.async, in two
// copies, a group ahead, one barrier a group, and read back 16 bytes a
// thread a tile.  Each weight fragment is made once and run through every
// n-tile.  A warp takes 64 columns (8 bytes of a row a thread), so its
// NT * 16 accumulators stay in registers; the 4 warps of a block take
// neighbouring columns and the same groups, and only the cluster splits K.
// The gi contract is K1's: exact products, a fresh f32 fragment for each
// 32-row group of each plane, the scale applied after in f32, the bias
// added in the cluster sum (q4core::cluster_sum_store).  The n <= 8
// instance is q4core's, untouched.

#include "q4_core.cuh"

namespace rows {

namespace cg = cooperative_groups;
using q4core::kThreads;
using q4core::kWarps;

constexpr int kJ = 4;             // column pairs (one MMA each) a thread
constexpr int kTileO = 16 * kJ;   // 64 output columns a warp
constexpr int kStride = kTileO + 4;

// 8 bytes of a streamed weight: read once, kept out of L1
__device__ __forceinline__ uint2 ld_stream8(const void* p) {
  uint2 v;
  asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "l"(p));
  return v;
}

// One group of one thread: packed rows 8t .. 8t + 7 of the group, 8 columns
// (two words), and the columns' bf16 scale pairs in each plane.
struct Group {
  uint32_t w[8][2];  // [h * 4 + q][word]: packed row 8t + 4h + q
  uint32_t s[2][kJ];  // [plane][column pair j]: bf16 (s[2j], s[2j + 1])
};

// VEC: 8-byte weight and 16-byte scale loads (O % 8 == 0, aligned);
// otherwise 4-byte words (8-byte scale pairs), each masked against O.
template <bool VEC>
__device__ __forceinline__ void load_group(
    Group& G, const uint8_t* __restrict__ packed,
    const uint16_t* __restrict__ scales, int grp, int groups, int O, int col,
    int t) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const uint8_t* p =
        packed + static_cast<size_t>(grp * 32 + 8 * t + r) * O + col;
    if (VEC) {
      uint2 v = make_uint2(0u, 0u);
      if (col < O) v = ld_stream8(p);
      G.w[r][0] = v.x;
      G.w[r][1] = v.y;
    } else {
      const unsigned int* pw = reinterpret_cast<const unsigned int*>(p);
      G.w[r][0] = col < O ? __ldg(pw) : 0u;
      G.w[r][1] = col + 4 < O ? __ldg(pw + 1) : 0u;
    }
  }
#pragma unroll
  for (int pl = 0; pl < 2; ++pl) {
    const uint16_t* s =
        scales + static_cast<size_t>(pl * groups + grp) * O + col;
    if (VEC) {
      uint4 a = make_uint4(0u, 0u, 0u, 0u);
      if (col < O) a = __ldg(reinterpret_cast<const uint4*>(s));
      G.s[pl][0] = a.x; G.s[pl][1] = a.y; G.s[pl][2] = a.z; G.s[pl][3] = a.w;
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint2 v = make_uint2(0u, 0u);
        if (col + 4 * i < O)
          v = __ldg(reinterpret_cast<const uint2*>(s + 4 * i));
        G.s[pl][2 * i] = v.x;
        G.s[pl][2 * i + 1] = v.y;
      }
    }
  }
}

// Stage x's rows of group grp: xs[plane][row][32 values], rows past n zero.
// Copied by cp.async (committed, not waited for).
template <int NR>
__device__ __forceinline__ void stage_x(uint16_t* xs,
                                        const uint16_t* __restrict__ x,
                                        int grp, int n, int K) {
  for (int idx = threadIdx.x; idx < 8 * NR; idx += kThreads) {
    const int c8 = idx & 3, row = (idx >> 2) & (NR - 1), pl = idx / (4 * NR);
    const bool ok = row < n;
    const size_t k = ok ? static_cast<size_t>(row) * K + pl * (K / 2) +
                              grp * 32 + 8 * c8
                        : 0;
    cp_async16(xs + (pl * NR + row) * 32 + 8 * c8, x + k, ok);
  }
  cp_async_commit();
}

// acc[nt][j] += the group's products for n-tile nt, column pair j: per
// plane a fresh f32 fragment over the group's 32 rows (two k16 MMAs), then
// s_lo * lo + s_hi * hi in f32, as q4core::compute_group.
template <int NT>
__device__ __forceinline__ void compute_group(float (&acc)[NT][kJ][4],
                                              const Group& G,
                                              const uint16_t* xs, int g,
                                              int t) {
  constexpr int NR = 8 * NT;
  // x[8nt + g][8t .. 8t + 7] of each plane: words 0, 1 are half 0's k
  // pairs 2t and 2t + 8, words 2, 3 half 1's
  uint32_t xb[NT][2][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int pl = 0; pl < 2; ++pl) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          xs + (pl * NR + 8 * nt + g) * 32 + 8 * t);
      xb[nt][pl][0] = v.x; xb[nt][pl][1] = v.y;
      xb[nt][pl][2] = v.z; xb[nt][pl][3] = v.w;
    }
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const uint32_t sel = (j & 1) ? 0x7632u : 0x5410u;  // bytes 2j%4, +1
    uint32_t alo[2][4], ahi[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // bytes (2j, 2j + 1) of rows 8t + 4h + (0, 1) and + (2, 3)
      const uint32_t p01 = __byte_perm(G.w[h * 4 + 0][j >> 1],
                                       G.w[h * 4 + 1][j >> 1], sel);
      const uint32_t p23 = __byte_perm(G.w[h * 4 + 2][j >> 1],
                                       G.w[h * 4 + 3][j >> 1], sel);
      alo[h][0] = q4core::nib_pair(p01);
      alo[h][1] = q4core::nib_pair(p01 >> 8);
      alo[h][2] = q4core::nib_pair(p23);
      alo[h][3] = q4core::nib_pair(p23 >> 8);
      ahi[h][0] = q4core::nib_pair(p01 >> 4);
      ahi[h][1] = q4core::nib_pair(p01 >> 12);
      ahi[h][2] = q4core::nib_pair(p23 >> 4);
      ahi[h][3] = q4core::nib_pair(p23 >> 12);
    }
    float sl0, sl1, sh0, sh1;
    unpack_bf16x2(G.s[0][j], sl0, sl1);
    unpack_bf16x2(G.s[1][j], sh0, sh1);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float flo[4] = {0.f, 0.f, 0.f, 0.f}, fhi[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mma_bf16(flo, alo[h], xb[nt][0][2 * h], xb[nt][0][2 * h + 1]);
        mma_bf16(fhi, ahi[h], xb[nt][1][2 * h], xb[nt][1][2 * h + 1]);
      }
      float* a = acc[nt][j];
      a[0] = fmaf(sh0, fhi[0], fmaf(sl0, flo[0], a[0]));
      a[1] = fmaf(sh0, fhi[1], fmaf(sl0, flo[1], a[1]));
      a[2] = fmaf(sh1, fhi[2], fmaf(sl1, flo[2], a[2]));
      a[3] = fmaf(sh1, fhi[3], fmaf(sl1, flo[3], a[3]));
    }
  }
}

// Launched as clusters of C blocks along x: cluster i owns the 4 column
// tiles [4i, 4i + 4) of 64 columns, one a warp; rank r of C takes groups r,
// r + C, ... (no runtime integer divide).  Every warp of a block takes the
// same groups and stages x; the staged copies and the partials share one
// static array (34,816 bytes at NT = 4: two blocks an SM).
template <int NT, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
kernel(const uint16_t* __restrict__ x,        // [n, K] bf16
       const uint8_t* __restrict__ packed,    // [K/2, O]
       const uint16_t* __restrict__ scales,   // [K/32, O] bf16
       const float* __restrict__ bias,        // [O] or null
       float* __restrict__ out,               // [n, O]
       int n, int K, int O) {
  constexpr int NR = 8 * NT;
  __shared__ __align__(16) float red[kWarps * NR * kStride];
  static_assert(2 * 2 * NR * 32 * 2 <= sizeof(red), "x's copies fit");
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  uint32_t cluster_id;
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(cluster_id));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int tile0 = static_cast<int>(cluster_id) << 2;
  const int col = (tile0 + warp) * kTileO + 8 * g;
  const int groups = K / 64;
  uint16_t* xs0 = reinterpret_cast<uint16_t*>(red);
  uint16_t* xs1 = xs0 + 2 * NR * 32;

  float acc[NT][kJ][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // two register groups and two staged copies of x: A's group's x in xs0,
  // B's in xs1, each staged a group ahead; one barrier a group
  Group A, B;
  int gb = rank;
  if (gb < groups) {
    load_group<VEC>(A, packed, scales, gb, groups, O, col, t);
    stage_x<NR>(xs0, x, gb, n, K);
  }
  for (; gb < groups; gb += 2 * C) {
    const int g1 = gb + C, g2 = g1 + C;
    if (g1 < groups) load_group<VEC>(B, packed, scales, g1, groups, O, col, t);
    cp_async_wait<0>();
    __syncthreads();  // gb's x is in xs0 for every warp; xs1 is free
    if (g1 < groups) stage_x<NR>(xs1, x, g1, n, K);
    compute_group<NT>(acc, A, xs0, g, t);
    if (g2 < groups) load_group<VEC>(A, packed, scales, g2, groups, O, col, t);
    if (g1 < groups) {
      cp_async_wait<0>();
      __syncthreads();  // g1's x is in xs1; xs0 is free
      if (g2 < groups) stage_x<NR>(xs0, x, g2, n, K);
      compute_group<NT>(acc, B, xs1, g, t);
    }
  }

  // acc[nt][j]: (column 8g + 2j, x row 8nt + 2t), (8g + 2j, 8nt + 2t + 1),
  //             (8g + 2j + 1, 8nt + 2t), (8g + 2j + 1, 8nt + 2t + 1)
  __syncthreads();  // red overlays the staged x
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      float* r = red + (warp * NR + 8 * nt + 2 * t) * kStride + 8 * g + 2 * j;
      *reinterpret_cast<float2*>(r) =
          make_float2(acc[nt][j][0], acc[nt][j][2]);
      *reinterpret_cast<float2*>(r + kStride) =
          make_float2(acc[nt][j][1], acc[nt][j][3]);
    }
  __syncthreads();
  q4core::cluster_sum_store<q4core::kActNone, kTileO, NR, kStride>(
      red, n, 2, tile0 * kTileO, O, bias, out);
}

template <int NT>
cudaError_t launch(const void* x, const uint8_t* packed,
                   const uint16_t* scales, const float* bias, float* out,
                   int n, int K, int O, int C, cudaStream_t stream) {
  const bool vec = O % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(packed) % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(scales) % 16 == 0;
  const int tiles = (O + kTileO - 1) / kTileO;
  q4core::ClusterLaunch l(((tiles + 3) / 4) * C, C, 0, stream);
  const uint16_t* xb = static_cast<const uint16_t*>(x);
  if (vec)
    return cudaLaunchKernelEx(&l.cfg, kernel<NT, true>, xb, packed, scales,
                              bias, out, n, K, O);
  return cudaLaunchKernelEx(&l.cfg, kernel<NT, false>, xb, packed, scales,
                            bias, out, n, K, O);
}

}  // namespace rows

extern "C" int q4_gemv_ps_launch(const void* x, const void* packed,
                                 const void* scales, const void* bias,
                                 void* out, int n, int K, int O, int wc,
                                 int cluster, void* stream) {
  if (!q4core::valid(n, K, O, wc, cluster))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = q4core::launch<false, q4core::kActNone>(
      x, static_cast<const uint8_t*>(packed),
      static_cast<const uint16_t*>(scales), static_cast<const float*>(bias),
      static_cast<float*>(out), n, K, O, wc, cluster,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of ``cluster`` blocks the card holds at once (ops/q4_cuda.py's
// plan keeps a launch to one wave).
extern "C" int q4_gemv_ps_max_clusters(int cluster) {
  return q4core::max_clusters<false, q4core::kActNone>(cluster);
}

// The 9-32-row instance: nt = 2 or 4 n-tiles of 8 rows (1 <= n <= 8 nt),
// 4 warps a block on 64 columns each, K split over a cluster of `cluster`
// blocks.
extern "C" int q4_gemv_ps_rows_launch(const void* x, const void* packed,
                                      const void* scales, const void* bias,
                                      void* out, int n, int K, int O, int nt,
                                      int cluster, void* stream) {
  if (!(nt == 2 || nt == 4) || n < 1 || n > 8 * nt || K <= 0 || K % 64 ||
      O <= 0 || O % 4 || cluster < 1 || cluster > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* p = static_cast<const uint8_t*>(packed);
  const auto* s = static_cast<const uint16_t*>(scales);
  const auto* b = static_cast<const float*>(bias);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      nt == 2 ? rows::launch<2>(x, p, s, b, o, n, K, O, cluster, st)
              : rows::launch<4>(x, p, s, b, o, n, K, O, cluster, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of ``cluster`` blocks of the nt-tile instance the card holds at
// once (0 on an error).
extern "C" int q4_gemv_ps_rows_max_clusters(int nt, int cluster) {
  if (!(nt == 2 || nt == 4) || cluster < 1 || cluster > 8) return 0;
  return nt == 2
             ? q4core::max_active_clusters(rows::kernel<2, true>, cluster, 0)
             : q4core::max_active_clusters(rows::kernel<4, true>, cluster, 0);
}
