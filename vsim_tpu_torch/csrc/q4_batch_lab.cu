// K15 q4_batch_lab: the batch lab's plane-split Q4 matmul on the tensor
// cores, y[n, O] = x[n, K] . W for 1 <= n <= 128 rows of bf16 x.
//
// Replaces tools/batch_lab.py:run_2d (:174; _k2d_f32x :65, _k2d_bsub :93,
// _k2d_bnos :117) and run_band (:251; _kband :191 under f32x, bsub, bnos).
// The weight is the plane-split repack: packed row c holds element c (low
// nibble, scale row c / 32) and element K/2 + c (high nibble, scale row
// K/64 + c / 32).  The plane fed to the tensor cores is, by MATH:
//   f32x  bf16((2^23 + v - (2^23 + 8)) s), s widened to f32: the f32
//         magic-number path (lop3, fadd, fmul a value), rounded to bf16
//         once a pair (cvt.rn.bf16x2)
//   bsub  v - 8 in bf16 (a nibble under exponent 0x43 is bf16 128 + v, one
//         lop3; fma.rn.bf16x2 subtracts 136, exactly), times the bf16 scale
//         with one rounding (mul.rn.bf16x2): bit-identical to f32x, since
//         (v - 8) s is exact before its rounding; another instruction
//         sequence, which is what the lab measures
//   bnos  bf16(v s) (the same, minus 128), the output initialised from
//         corr [n, O] f32, which the caller computes outside the kernel
//         (-8 xs . s, xs the f32 block sums of x), as XLA computes it
//         outside the Pallas call
// and bf16 x times a bf16 plane is exact in f32, so mma.sync m16n8k16
// bf16 -> f32 computes the function; only the order of the f32 sums
// differs from the Pallas kernels'.
//
// Bound on the H100: the weight bytes up to about n = 80, the bf16
// operations beyond (GPT-J fc at n = 64: 37.7 MB, 11.3 us; 8.6 GFLOP, 8.7
// us; at n = 128 17.4 us of operations).  Design: the plane-split core of
// K1 and K11 (q4_core.cuh) at 9-128 rows, as K9/K10 take it in the "i"
// layout (q4_matmul_i.cu); no plane goes through shared memory:
//
// * The weight is the 16-column operand of mma.sync, x the 8-row one.
//   Thread (g, t) = (lane / 4, lane % 4) loads 2J contiguous bytes of packed
//   rows 8t .. 8t + 7 of a group (64 values of K: 32 packed rows, lo and hi
//   planes) straight into registers, streamed past L1; one prmt of two
//   rows' words pairs a byte of each as the k pair of a column, and the
//   math above makes the bf16 plane in the operand register (inline PTX
//   prmt and lop3, as K9/K10's: in C++ the compiler expands them).  MMA h
//   takes rows 8t + 4h + {0, 1} and {2, 3} as the k pairs 2t and 2t + 8,
//   so x's operand for a group and plane is x[8t .. 8t + 7]: one 16-byte
//   read.  One f32 accumulator runs across the groups.
// * x's rows of a group are staged in shared memory by cp.async, in three
//   copies, two groups ahead, one barrier a group; each weight fragment is
//   dequantized once and run through every 8-row n-tile (NT = 1, 2, 4, 8
//   or 16 of them: the weight is read once a call).  A warp takes 16J
//   columns, fewer as n grows (J = 8 at 8 rows, 4 up to 32, 2 past), so
//   its NT J 4 accumulators stay in registers; the weight of DEPTH - 1
//   groups ahead is in flight in registers while one computes.
// * A block is 4 warps on neighbouring columns (64J of them) taking the
//   same groups.  The geometries (BAND):
//   2d    a thread-block cluster of C blocks owns a block tile of O; rank r
//         takes groups r, r + C, ... (the TPU's wide-O grid with the k axis
//         split over the cluster), and the ranks' partials meet in
//         distributed shared memory in rank order (q4core::
//         cluster_sum_store): one launch, no partials in HBM.  bnos starts
//         rank 0's accumulators from corr, as the body initialises its
//         output.  ops/q4_batch_lab.py:batch_2d_plan picks (NT, C) from the
//         shapes and cudaOccupancyMaxActiveClusters, as core_plan does;
//   band  a band of K across all of O (the TPU's whole-O row bands): the
//         band's block tiles are dealt to `splits` blocks (grid bands x
//         splits), each walking its tiles in order, each tile a run of the
//         band's groups, and writing the tile's f32 partials to a scratch
//         [bands, n, O]; a second launch sums them in band order after corr
//         (bnos) or 0.  The TPU walks a band's O in order on one core; one
//         block a band would leave at most K/64 blocks on the card.
//         band_plan picks the band count, the wrapper the splits that fill
//         one wave.
// The two geometries compute the same function and differ only in the
// order of the f32 sums; both give the same bits run to run (no atomics).

#include "q4_core.cuh"

namespace {

namespace cg = cooperative_groups;
using q4core::kThreads;
using q4core::kWarps;

// the maths, in the order of vsim_tpu_torch/ops/q4_batch_lab.py:BATCH_MATHS
enum BatchMath { kF32x, kBsub, kBnos, kNumMaths };

constexpr int kMaxCluster = 8;
// Copies of x's staged rows: x of kXCopies - 1 groups ahead in flight (from
// L2) while one computes.
constexpr int kXCopies = 3;

// Column pairs (one MMA each) a thread takes at NT n-tiles: 2J columns.
__host__ __device__ constexpr int cols_j(int nt) {
  return nt == 1 ? 8 : (nt <= 4 ? 4 : 2);
}

// Groups of weight a thread holds in registers: DEPTH - 1 in flight (a
// fourth was no faster at n = 64 on the H100, and spilled at n = 128).
__host__ __device__ constexpr int depth_of(int nt) { return nt == 1 ? 2 : 3; }

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// The nibbles at bits 0-3 and 16-19 of u under exponent 0x43: the bf16
// pair (128 + v0, 128 + v1), one lop3.
__device__ __forceinline__ uint32_t nibs_128(uint32_t u) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n"  // (u & 0x000F000F) | 0x43004300
      : "=r"(r) : "r"(u), "r"(0x000F000Fu), "r"(0x43004300u));
  return r;
}

// The plane of the nibbles at bits 0-3 and 16-19 of u (rows 2t, 2t + 1 of
// one column, whose bf16 scale is the low half of s) as a bf16 pair.
template <int MATH>
__device__ __forceinline__ uint32_t plane(uint32_t u, uint32_t s_pair,
                                          bool high) {
  if constexpr (MATH == kF32x) {
    const float s = __uint_as_float(high ? s_pair & 0xFFFF0000u : s_pair << 16);
    const float v0 = __uint_as_float((u & 0xFu) | 0x4B000000u) - 8388616.f;
    const float v1 = __uint_as_float(((u >> 16) & 0xFu) | 0x4B000000u) - 8388616.f;
    return pack_bf16(v0 * s, v1 * s);
  } else {
    // (128 + v) - 136 = v - 8 (bsub) or - 128 = v (bnos), exact; then
    // times (s, s) rounded once
    constexpr uint32_t off = MATH == kBsub ? 0xC308C308u : 0xC300C300u;
    const uint32_t s2 = __byte_perm(s_pair, 0u, high ? 0x3232 : 0x1010);
    return mul_bf16x2(fma_bf16x2(nibs_128(u), 0x3F803F80u, off), s2);
  }
}

// A group of one thread: packed rows 8t + i (J / 2 words, 2J columns) and
// the columns' scales in both planes.
template <int J>
struct Unit {
  uint32_t w[8][J / 2];
  uint32_t s[2][J];  // [plane][column pair j]: bf16 (s[2j], s[2j + 1])
};

// n 4-byte words at p, streamed past L1
template <int N>
__device__ __forceinline__ void ld_stream(uint32_t* w, const void* p) {
  if constexpr (N == 1) {
    asm volatile("ld.global.nc.L1::no_allocate.b32 %0, [%1];\n"
                 : "=r"(w[0]) : "l"(p));
  } else if constexpr (N == 2) {
    asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];\n"
                 : "=r"(w[0]), "=r"(w[1]) : "l"(p));
  } else {
    static_assert(N % 4 == 0, "16-byte pieces");
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const uint4 v = q4core::ld_stream16(static_cast<const uint8_t*>(p) + 4 * i);
      w[i] = v.x; w[i + 1] = v.y; w[i + 2] = v.z; w[i + 3] = v.w;
    }
  }
}

// Group grp's packed rows 8t .. 8t + 7 at columns [col, col + 2J) and their
// scale rows grp (lo plane) and G + grp (hi); zeros past O (O % 16 == 0,
// so a thread's columns are all in or all out).
template <int J>
__device__ __forceinline__ void load_unit(Unit<J>& U,
                                          const uint8_t* __restrict__ packed,
                                          const uint16_t* __restrict__ scales,
                                          int grp, int G, int O, int col,
                                          int t) {
  if (col < O) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      ld_stream<J / 2>(U.w[i],
                       packed + static_cast<size_t>(grp * 32 + 8 * t + i) * O + col);
#pragma unroll
    for (int pl = 0; pl < 2; ++pl)
      ld_stream<J>(U.s[pl], scales + static_cast<size_t>(pl * G + grp) * O + col);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < J / 2; ++e) U.w[i][e] = 0u;
#pragma unroll
    for (int pl = 0; pl < 2; ++pl)
#pragma unroll
      for (int j = 0; j < J; ++j) U.s[pl][j] = 0u;
  }
}

// Stage group grp of x's NR rows: xs[plane][row][32 values], rows past n
// zero; not committed.
template <int NR>
__device__ __forceinline__ void stage_x(uint16_t* xs, const uint16_t* __restrict__ x,
                                        int grp, int n, int K) {
  for (int idx = threadIdx.x; idx < 8 * NR; idx += kThreads) {
    const int c8 = idx & 3, row = (idx >> 2) & (NR - 1), pl = idx / (4 * NR);
    const bool ok = row < n;
    const size_t k = ok ? static_cast<size_t>(row) * K + pl * (K / 2) + grp * 32 + 8 * c8
                        : 0;
    cp_async16(xs + (pl * NR + row) * 32 + 8 * c8, x + k, ok);
  }
}

// acc += a group's products: each weight fragment made once and run through
// every n-tile of the staged x.
template <int NT, int MATH, int J>
__device__ __forceinline__ void compute_unit(float (&acc)[NT][J][4],
                                             const Unit<J>& U,
                                             const uint16_t* xs, int g, int t) {
  constexpr int NR = 8 * NT;
#pragma unroll
  for (int pl = 0; pl < 2; ++pl) {
    uint32_t a[2][J][4];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      // bytes (2j, 2j + 1) of rows 8t + 4h + (0, 1) and + (2, 3)
      const uint32_t sel = (j & 1) ? 0x7632u : 0x5410u;
      const uint32_t sp = U.s[pl][j];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t p01 = prmt(U.w[4 * h][j >> 1], U.w[4 * h + 1][j >> 1], sel);
        const uint32_t p23 = prmt(U.w[4 * h + 2][j >> 1], U.w[4 * h + 3][j >> 1], sel);
        const int sh = 4 * pl;  // the hi plane's nibbles sit 4 bits up
        a[h][j][0] = plane<MATH>(p01 >> sh, sp, false);        // column 2j, pair 2t
        a[h][j][1] = plane<MATH>(p01 >> (sh + 8), sp, true);   // 2j + 1, pair 2t
        a[h][j][2] = plane<MATH>(p23 >> sh, sp, false);        // 2j, pair 2t + 8
        a[h][j][3] = plane<MATH>(p23 >> (sh + 8), sp, true);   // 2j + 1, pair 2t + 8
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          xs + (pl * NR + 8 * nt + g) * 32 + 8 * t);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        mma_bf16(acc[nt][j], a[0][j], v.x, v.y);
        mma_bf16(acc[nt][j], a[1][j], v.z, v.w);
      }
    }
  }
}

template <int NT, bool BAND>
__host__ __device__ constexpr size_t dyn_smem() {
  constexpr int NR = 8 * NT, TW = 16 * cols_j(NT);
  constexpr size_t xs = kXCopies * size_t(2) * NR * 32 * 2;
  constexpr size_t red = size_t(kWarps) * NR * (TW + 4) * 4;
  return BAND || xs > red ? xs : red;
}

// 2d: clusters of C blocks along x, cluster i owning block tile i (4 warp
// tiles of 16J columns).  band: gridDim.x bands of K by gridDim.y splits of
// the block tiles.  Groups are taken round-robin (2d) or in runs (band): no
// runtime integer divide in the loop but band's tile index.
template <int NT, int MATH, bool BAND>
__global__ void __launch_bounds__(kThreads, 2)
batch_kernel(const uint16_t* __restrict__ x,       // [n, K] bf16
             const uint8_t* __restrict__ packed,   // [K/2, O] plane-split
             const uint16_t* __restrict__ scales,  // [K/32, O] bf16
             const float* __restrict__ corr,       // bnos, 2d: [n, O]
             float* __restrict__ dst,  // 2d: [n, O]; band: [bands, n, O]
             int n, int K, int O) {
  constexpr int J = cols_j(NT), TW = 16 * J, NR = 8 * NT;
  constexpr int DEPTH = depth_of(NT);
  extern __shared__ __align__(16) uint4 dyn[];  // x's copies; 2d: partials
  uint16_t* xs = reinterpret_cast<uint16_t*>(dyn);
  constexpr int XS = 2 * NR * 32;  // bf16 values a copy
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int G = K / 64;
  int rank = 0, C = 1, tile0 = 0, g_begin = 0, ng = G, items;
  const int split = blockIdx.y, splits = gridDim.y;  // band: 1 in 2d
  if constexpr (BAND) {
    const int band = blockIdx.x, bands = gridDim.x;
    g_begin = static_cast<int>(static_cast<long long>(G) * band / bands);
    ng = static_cast<int>(static_cast<long long>(G) * (band + 1) / bands) - g_begin;
    const int tiles = (O + 4 * TW - 1) / (4 * TW);
    items = split < tiles ? ng * ((tiles - split + splits - 1) / splits) : 0;
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    C = static_cast<int>(cluster.num_blocks());
    rank = static_cast<int>(cluster.block_rank());
    uint32_t cluster_id;
    asm("mov.u32 %0, %%clusterid.x;" : "=r"(cluster_id));
    tile0 = static_cast<int>(cluster_id) * 4;
    items = rank < G ? (G - rank + C - 1) / C : 0;
  }
  // item k: (block tile, group); band: the split's tile k / ng
  auto tile_of = [&](int k) { return BAND ? k / ng : 0; };
  auto group_of = [&](int k) {
    return BAND ? g_begin + k - tile_of(k) * ng : rank + k * C;
  };
  auto col_of = [&](int k) {
    return ((BAND ? 4 * (split + tile_of(k) * splits) : tile0) + warp) * TW +
           2 * J * g;
  };

  float acc[NT][J][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 8 * nt + 2 * t + (e & 1), o = col_of(0) + 2 * j + (e >> 1);
        acc[nt][j][e] = !BAND && MATH == kBnos && rank == 0 && m < n && o < O
                            ? corr[static_cast<size_t>(m) * O + o] : 0.f;
      }

  Unit<J> U[DEPTH];
#pragma unroll
  for (int d = 0; d < DEPTH - 1; ++d)
    if (d < items)
      load_unit<J>(U[d], packed, scales, group_of(d), G, O, col_of(d), t);
  // one commit group an item (empty past the last), so a wait's count
  // always names the same item's x
#pragma unroll
  for (int c = 0; c < kXCopies - 1; ++c) {
    if (c < items) stage_x<NR>(xs + c * XS, x, group_of(c), n, K);
    cp_async_commit();
  }
  for (int base = 0; base < items; base += DEPTH) {
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      const int k = base + d;
      if (k < items) {
        const int kn = k + DEPTH - 1;
        if (kn < items)
          load_unit<J>(U[(d + DEPTH - 1) % DEPTH], packed, scales, group_of(kn),
                       G, O, col_of(kn), t);
        cp_async_wait<kXCopies - 2>();
        __syncthreads();  // x of item k in copy k % kXCopies; every warp is
                          // done with item k - 1's copy
        const int kx = k + kXCopies - 1;
        if (kx < items)
          stage_x<NR>(xs + (kx % kXCopies) * XS, x, group_of(kx), n, K);
        cp_async_commit();
        compute_unit<NT, MATH, J>(acc, U[d], xs + (k % kXCopies) * XS, g, t);
        if (BAND && k - tile_of(k) * ng == ng - 1) {  // the tile's last group
          float* out = dst + static_cast<size_t>(blockIdx.x) * n * O;
          const int col = col_of(k);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int j = 0; j < J; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int m = 8 * nt + 2 * t + (e & 1), o = col + 2 * j + (e >> 1);
                if (m < n && o < O) out[static_cast<size_t>(m) * O + o] = acc[nt][j][e];
                acc[nt][j][e] = 0.f;
              }
        }
      }
    }
  }
  cp_async_wait<0>();

  if constexpr (!BAND) {
    // acc[nt][j]: (column 2Jg + 2j, x row 8nt + 2t), (2Jg + 2j, 8nt + 2t + 1),
    //             (2Jg + 2j + 1, 8nt + 2t), (2Jg + 2j + 1, 8nt + 2t + 1)
    float* red = reinterpret_cast<float*>(dyn);
    __syncthreads();  // red overlays the staged x
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        float* r = red + (warp * NR + 8 * nt + 2 * t) * (TW + 4) + 2 * J * g + 2 * j;
        *reinterpret_cast<float2*>(r) = make_float2(acc[nt][j][0], acc[nt][j][2]);
        *reinterpret_cast<float2*>(r + TW + 4) = make_float2(acc[nt][j][1], acc[nt][j][3]);
      }
    __syncthreads();
    q4core::cluster_sum_store<q4core::kActNone, TW, NR, TW + 4>(
        red, n, 2, tile0 * TW, O, nullptr, dst);
  }
}

// Band's second pass: out = corr (bnos) or 0, plus the partials in band order.
__global__ void band_reduce_kernel(const float* __restrict__ partial,
                                   const float* __restrict__ corr,
                                   float* __restrict__ out, int total,
                                   int bands) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float s = corr ? corr[idx] : 0.f;
  for (int b = 0; b < bands; ++b) s += partial[static_cast<size_t>(b) * total + idx];
  out[idx] = s;
}

struct Args {
  const uint16_t* x;
  const uint8_t* packed;
  const uint16_t* scales;
  const float* corr;
  float* dst;
  int n, K, O, C, blocks;
  cudaStream_t stream;
};

template <int NT, int MATH, bool BAND>
cudaError_t prepare() {
  constexpr size_t smem = dyn_smem<NT, BAND>();
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(batch_kernel<NT, MATH, BAND>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

struct RunLaunch {
  const Args& a;
  template <int NT, int MATH, bool BAND>
  cudaError_t run() const {
    const cudaError_t err = prepare<NT, MATH, BAND>();
    if (err != cudaSuccess) return err;
    if constexpr (BAND) {  // bands x splits blocks, no cluster
      batch_kernel<NT, MATH, BAND><<<dim3(a.blocks, a.C), kThreads,
                                     dyn_smem<NT, BAND>(), a.stream>>>(
          a.x, a.packed, a.scales, a.corr, a.dst, a.n, a.K, a.O);
      return cudaGetLastError();
    }
    q4core::ClusterLaunch l(a.blocks, a.C, dyn_smem<NT, BAND>(), a.stream);
    return cudaLaunchKernelEx(&l.cfg, batch_kernel<NT, MATH, BAND>, a.x,
                              a.packed, a.scales, a.corr, a.dst, a.n, a.K, a.O);
  }
};

struct RunMax {
  int C;
  template <int NT, int MATH, bool BAND>
  int run() const {
    if (prepare<NT, MATH, BAND>() != cudaSuccess) {
      cudaGetLastError();
      return 0;
    }
    return q4core::max_active_clusters(batch_kernel<NT, MATH, BAND>, C,
                                       dyn_smem<NT, BAND>());
  }
};

template <int NT, bool BAND, class Op>
auto with_math(const Op& op, int math) {
  switch (math) {
    case kF32x: return op.template run<NT, kF32x, BAND>();
    case kBsub: return op.template run<NT, kBsub, BAND>();
    default: return op.template run<NT, kBnos, BAND>();
  }
}

template <bool BAND, class Op>
auto with_tiles(const Op& op, int nt, int math) {
  switch (nt) {
    case 1: return with_math<1, BAND>(op, math);
    case 2: return with_math<2, BAND>(op, math);
    case 4: return with_math<4, BAND>(op, math);
    case 8: return with_math<8, BAND>(op, math);
    default: return with_math<16, BAND>(op, math);
  }
}

// The instance of (nt, math, band); each was checked.
template <class Op>
auto with_instance(const Op& op, int nt, int math, bool band) {
  return band ? with_tiles<true>(op, nt, math) : with_tiles<false>(op, nt, math);
}

bool valid_plan(int nt, int math, int band, int cluster) {
  return (nt == 1 || nt == 2 || nt == 4 || nt == 8 || nt == 16) && math >= 0 &&
         math < kNumMaths && cluster >= 1 &&
         cluster <= (band ? 65535 : kMaxCluster);
}

}  // namespace

// y [n, O] f32 for 1 <= n <= 8 nt <= 128, K % 64 == 0, O % 16 == 0 and
// 16-byte aligned x, packed and scales.  math: the index in BATCH_MATHS;
// corr [n, O] f32 for bnos only.  band = 0: the 2d geometry in clusters of
// ``cluster`` blocks; band = 1: ``bands`` (1 <= bands <= K/64) by
// ``cluster`` splits of the block tiles write ``partial`` [bands, n, O],
// then a second launch sums it into ``out``.
extern "C" int q4_batch_lab_launch(const void* x, const void* packed,
                                   const void* scales, const void* corr,
                                   void* partial, void* out, int n, int K,
                                   int O, int math, int band, int nt,
                                   int cluster, int bands, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (!valid_plan(nt, math, band, cluster) || n < 1 || n > 8 * nt || K < 64 ||
      K % 64 || O < 16 || O % 16 || (math == kBnos) != (corr != nullptr) ||
      !aligned(x) || !aligned(packed) || !aligned(scales) ||
      (band && (bands < 1 || bands > K / 64 || partial == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int block_o = 4 * 16 * cols_j(nt);
  const int tiles = (O + block_o - 1) / block_o;
  const Args a{static_cast<const uint16_t*>(x), static_cast<const uint8_t*>(packed),
               static_cast<const uint16_t*>(scales), static_cast<const float*>(corr),
               static_cast<float*>(band ? partial : out), n, K, O, cluster,
               band ? bands : tiles * cluster, s};
  cudaError_t err = with_instance(RunLaunch{a}, nt, math, band != 0);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || !band) return static_cast<int>(err);
  const int total = n * O;
  band_reduce_kernel<<<(total + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<const float*>(corr),
      static_cast<float*>(out), total, bands);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of `cluster` blocks of an instance the card holds at once (a
// band launch's blocks: cluster 1); ops/q4_batch_lab.py's plans keep a
// launch to one wave.
extern "C" int q4_batch_lab_max_clusters(int nt, int math, int band,
                                         int cluster) {
  if (!valid_plan(nt, math, 0, cluster)) return 0;
  return with_instance(RunMax{cluster}, nt, math, band != 0);
}
