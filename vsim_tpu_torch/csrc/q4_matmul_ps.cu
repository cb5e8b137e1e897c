// K2 q4_matmul_ps: y[n, O] = x[n, K] . W^T (+ bias) for a plane-split Q4_0
// weight, n <= 128 rows of bf16 or f32 activations: every call the gi math's
// K1 does not take (decode under f32xf, i32 and f32x; any f32 x; prefill
// chunks and batches of 9-128 rows).
//
// Replaces vsim_tpu/ops/pallas_q4.py:_kernel_ps and _kernel_ps_bias (:482,
// :223, dispatched at :572) with _dequant_planes_ps (:187): each weight
// element dequantizes to (v - 8) * s; with ROUND (the i32/f32x maths, and gi
// for bf16 x at n > 8: ops/matmul.py:ps_round_planes) the planes and x are
// rounded to bf16, as the Pallas kernel's acc_dtype bf16 casts them, else
// both stay f32 (the "f32xf" math); the products accumulate in f32.
// Packed row c holds element c (low nibble, scale row c/32) and element
// K/2 + c (high nibble, scale row K/64 + c/32): group g of 32 packed rows
// pairs scale rows g and G + g (G = K/64).
//
// Three instances, picked by (n, round_planes), the shape and the contract:
//
// n <= 8, either contract: a GEMV.  Bound on the H100: the weight bytes
// (0.5625 B a parameter).  K10's design in the "ps" layout: a thread owns 4
// neighbouring output columns and reads one 4-byte word of a packed row a
// step, so a warp reads 128 contiguous bytes of the K-major row; a group is
// loaded in two batches of 16 rows, each in flight while the other computes,
// and a split's first batch while x is staged.  The <= 8 rows of x sit in
// shared memory as (lo, hi) float pairs, x[c] and x[K/2 + c].  With f32
// planes a nibble becomes a float without a conversion: its byte is
// permuted into 0x4B000000 (2^23 + v) and 2^23 + 8 subtracted, exactly; with
// bf16 planes two weights take one fma.rn.bf16x2 (below).  Too few
// 1024-column tiles for 132 SMs is met by splitting K across blockIdx.z in
// whole groups; the splits write f32 partials that a second pass sums with
// the bias in a fixed order (deterministic, no atomics).
//
// 9-128 rows, bf16 planes (ROUND): on the tensor cores.  bf16 x times bf16
// round((v - 8) s) is exact in f32, so mma.sync m16n8k16 bf16 -> f32 computes
// the contract; only the order of the f32 sums differs from the Pallas
// kernel's.  A block owns all n rows (padded to 16, 32, 64 or 128; rows past
// n are zero-filled and never stored) and 128 output columns, 8 warps.  Each
// step of 64 K-values (a group: 32 rows of each plane) loads the packed bytes
// and both scale rows with 16-byte cp.async into a ring of 3-6 stages (more
// for fewer rows), with x (bf16, or f32 rounded on the way); dequantizes the
// tile once into shared memory as bf16, two weights an fma.rn.bf16x2 (the -8
// stays inside the rounding: round((v - 8) s) != round(v s) - 8 s), one step
// ahead, into the other of two weight buffers; and feeds x by ldmatrix and
// the K-major weight by ldmatrix.trans into mma.sync, one barrier a step.  Small O (32 tiles
// at GPT-J's proj) splits K as the GEMV does.  Bound: the weight bytes up to
// n = 128 at 989 TFLOP/s.
//
// 9-128 rows, f32 planes: on the tensor cores as TF32 products.  Every
// dequantized weight (v - 8) * s is exact in TF32: v - 8 has at most 3
// significant bits and a bf16 scale 8, so the product has at most 11, TF32's
// significand (a bf16 subnormal scale gives a multiple of 2^-133, whose low
// 16 f32 mantissa bits are zero).  bf16 x is exact in TF32 too, so one
// mma.sync m16n8k8 TF32 -> f32 gives the f32 FMA product exactly and only
// the order of the f32 sums differs from the contract; f32 x is split into
// big + small TF32 halves (common.cuh:split_tf32) and takes two products,
// small first, leaving ~2^-22 of |x w|.  The bf16 instance's geometry: a
// block owns all n rows and 128 columns, a cp.async ring carries each
// group's packed bytes, both scale rows and x (bf16, or f32 split in the
// fragments), and each group is dequantized once, one step ahead, into the
// other of two f32 weight buffers; K is split as there.  Bound: the weight
// bytes, or the products at 494.7 TFLOP/s (two a product for f32 x).

#include <type_traits>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// n <= 8: GEMV
// ---------------------------------------------------------------------------

constexpr int kGemvThreads = 256;
constexpr int kCols = 4;                       // output columns per thread
constexpr int kTileO = kGemvThreads * kCols;   // 1024 columns per block
constexpr int kSlabG = 16;                     // groups of x in shared memory
constexpr int kHalf = 16;                      // packed rows a load batch

// Packed rows [r0, r0 + 16) of group g, columns col .. col + 3, into w.
__device__ __forceinline__ void load_half(uint32_t (&w)[kHalf],
                                          const uint8_t* packed, int g, int r0,
                                          int O, int col) {
  const uint8_t* p = packed + static_cast<size_t>(g * 32 + r0) * O + col;
#pragma unroll
  for (int r = 0; r < kHalf; ++r)
    w[r] = __ldg(reinterpret_cast<const unsigned int*>(p + static_cast<size_t>(r) * O));
}

// acc += x . W over 16 packed rows (x pairs xp[i][0..15] of row i); sl2/sh2
// the 4 columns' scales of each plane as bf16 pairs
template <int NR, bool ROUND>
__device__ __forceinline__ void gemv_half(float (&acc)[NR][kCols],
                                          const uint32_t (&w)[kHalf],
                                          uint2 sl2, uint2 sh2,
                                          const float2* xp, int xstride) {
  float sl[kCols], sh[kCols];
  unpack_bf16x2(sl2.x, sl[0], sl[1]);
  unpack_bf16x2(sl2.y, sl[2], sl[3]);
  unpack_bf16x2(sh2.x, sh[0], sh[1]);
  unpack_bf16x2(sh2.y, sh[2], sh[3]);
#pragma unroll
  for (int r = 0; r < kHalf; r += 2) {
    float wl[2][kCols], wh[2][kCols];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const uint32_t lo = w[r + u] & 0x0F0F0F0Fu;
      const uint32_t hi = (w[r + u] >> 4) & 0x0F0F0F0Fu;
      if (ROUND) {
        unpack_bf16x2(dequant_bf16x2<0>(lo, sl2.x), wl[u][0], wl[u][1]);
        unpack_bf16x2(dequant_bf16x2<2>(lo, sl2.y), wl[u][2], wl[u][3]);
        unpack_bf16x2(dequant_bf16x2<0>(hi, sh2.x), wh[u][0], wh[u][1]);
        unpack_bf16x2(dequant_bf16x2<2>(hi, sh2.y), wh[u][2], wh[u][3]);
      } else {
        wl[u][0] = nib_f<0>(lo) * sl[0];
        wl[u][1] = nib_f<1>(lo) * sl[1];
        wl[u][2] = nib_f<2>(lo) * sl[2];
        wl[u][3] = nib_f<3>(lo) * sl[3];
        wh[u][0] = nib_f<0>(hi) * sh[0];
        wh[u][1] = nib_f<1>(hi) * sh[1];
        wh[u][2] = nib_f<2>(hi) * sh[2];
        wh[u][3] = nib_f<3>(hi) * sh[3];
      }
    }
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      // x pairs of packed rows r and r + 1: (lo, hi, lo, hi)
      const float4 x2 = *reinterpret_cast<const float4*>(xp + i * xstride + r);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        acc[i][j] = fmaf(x2.y, wh[0][j], fmaf(x2.x, wl[0][j], acc[i][j]));
        acc[i][j] = fmaf(x2.w, wh[1][j], fmaf(x2.z, wl[1][j], acc[i][j]));
      }
    }
  }
}

template <int NR, bool ROUND>
__global__ void __launch_bounds__(kGemvThreads, 2)
ps_gemv_kernel(const void* __restrict__ xv, int x_is_bf16,
               const uint8_t* __restrict__ packed,   // [K/2, O]
               const uint16_t* __restrict__ scales,  // [K/32, O] bf16
               const float* __restrict__ bias,       // [O] or null
               float* __restrict__ dst,  // [n, O] (splits == 1) or [splits, n, O]
               int n, int K, int O, int splits) {
  __shared__ __align__(16) float2 xs[NR][kSlabG * 32];  // (x[c], x[K/2 + c])
  const int half_k = K / 2, G = K / 64;
  const int split = blockIdx.z;
  const int g_begin = static_cast<int>(static_cast<long long>(G) * split / splits);
  const int g_end = static_cast<int>(static_cast<long long>(G) * (split + 1) / splits);
  const int col = (blockIdx.x * kGemvThreads + threadIdx.x) * kCols;
  const bool active = col < O;  // O % 4 == 0: a thread is all in or all out

  float acc[NR][kCols];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  // two batches of 16 packed rows a group: each batch's loads are in flight
  // while the other batch computes, and a slab's first batch while x is
  // staged
  uint32_t wa[kHalf], wb[kHalf];
  auto scale_pair = [&](int row) {
    return __ldg(reinterpret_cast<const uint2*>(
        scales + static_cast<size_t>(row) * O + col));
  };
  for (int g0 = g_begin; g0 < g_end; g0 += kSlabG) {
    const int ng = min(kSlabG, g_end - g0);
    const int rows = ng * 32;
    uint2 nsl, nsh;
    if (active) {
      load_half(wa, packed, g0, 0, O, col);
      nsl = scale_pair(g0);
      nsh = scale_pair(G + g0);
    }
    __syncthreads();  // the previous slab is consumed
    for (int idx = threadIdx.x; idx < NR * rows; idx += kGemvThreads) {
      const int i = idx / rows, r = idx - i * rows;
      float lo = 0.f, hi = 0.f;
      if (i < n) {
        const size_t off = static_cast<size_t>(i) * K + g0 * 32 + r;
        if (x_is_bf16) {
          lo = bf16_to_float(static_cast<const uint16_t*>(xv)[off]);
          hi = bf16_to_float(static_cast<const uint16_t*>(xv)[off + half_k]);
        } else {
          lo = static_cast<const float*>(xv)[off];
          hi = static_cast<const float*>(xv)[off + half_k];
          if (ROUND) round2_bf16(lo, hi);
        }
      }
      xs[i][r] = make_float2(lo, hi);
    }
    __syncthreads();
    if (!active) continue;
    for (int gg = 0; gg < ng; ++gg) {
      const int g = g0 + gg;
      load_half(wb, packed, g, kHalf, O, col);
      const uint2 sl = nsl, sh = nsh;
      gemv_half<NR, ROUND>(acc, wa, sl, sh, &xs[0][gg * 32], kSlabG * 32);
      if (gg + 1 < ng) {
        load_half(wa, packed, g + 1, 0, O, col);
        nsl = scale_pair(g + 1);
        nsh = scale_pair(G + g + 1);
      }
      gemv_half<NR, ROUND>(acc, wb, sl, sh, &xs[0][gg * 32 + kHalf],
                           kSlabG * 32);
    }
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    if (i >= n) break;
    float4 o = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    if (splits == 1) {
      if (bias) {
        o.x += bias[col];
        o.y += bias[col + 1];
        o.z += bias[col + 2];
        o.w += bias[col + 3];
      }
      *reinterpret_cast<float4*>(dst + static_cast<size_t>(i) * O + col) = o;
    } else {
      *reinterpret_cast<float4*>(
          dst + (static_cast<size_t>(split) * n + i) * O + col) = o;
    }
  }
}

// Second pass of a split K: out = bias + the partials.  A block of 256
// threads takes 256 / P outputs, P = the splits rounded down to a power of
// two, at most 8; thread lane j of an output sums splits j, j + P, ... in
// order, then the P lane sums are added in lane order (deterministic, no
// atomics), so no thread walks a long chain of dependent loads and no lane
// idles.
constexpr int kReduceThreads = 256;

__host__ __device__ constexpr int reduce_lanes(int splits) {
  return splits >= 8 ? 8 : (splits >= 4 ? 4 : (splits >= 2 ? 2 : 1));
}

__global__ void __launch_bounds__(kReduceThreads)
ps_split_reduce_kernel(const float* __restrict__ partial,
                       const float* __restrict__ bias, float* __restrict__ out,
                       int total, int O, int splits) {
  __shared__ float red[kReduceThreads];
  const int P = reduce_lanes(splits), per = kReduceThreads / P;
  const int o = threadIdx.x % per, j = threadIdx.x / per;
  const int idx = blockIdx.x * per + o;
  float s = 0.f;
  if (idx < total)
    for (int k = j; k < splits; k += P)
      s += partial[static_cast<size_t>(k) * total + idx];
  red[threadIdx.x] = s;
  __syncthreads();
  if (j == 0 && idx < total) {
    float t = bias ? bias[idx % O] : 0.f;
    for (int l = 0; l < P; ++l) t += red[l * per + o];
    out[idx] = t;
  }
}

// ---------------------------------------------------------------------------
// 9-128 rows, bf16 planes: mma.sync
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 256;   // 8 warps
constexpr int kBN = 128;           // output columns per block
constexpr int kKS = 64;            // K values per step: 32 lo + 32 hi
constexpr int kWS = kBN + 8;       // bf16 row stride of the weight tile
constexpr int kXS = kKS + 8;       // bf16 row stride of the x tile
constexpr int kRawBytes = 32 * kBN + 2 * kBN * 2;  // packed rows + 2 scale rows

// Ring depth by row tile: the smaller the tile, the less a step computes, so
// the more steps' loads are kept in flight (shared memory allows two blocks
// an SM at every depth).
template <int BM>
struct MmaRing {
  static constexpr int kStages = BM <= 32 ? 6 : (BM == 64 ? 4 : 3);
  static constexpr size_t kSmem =
      kStages * kRawBytes + 2 * (2 * kKS * kWS + kStages * BM * kXS);
};

// The packed bytes and both scale rows of group g into ring stage ``raw``:
// 16-byte cp.async where ``vec_w`` (16-byte rows and addresses), else plain
// loads; columns past O read as zeros.
__device__ __forceinline__ void load_weight_step(
    uint8_t* raw, const uint8_t* packed, const uint16_t* scales, int g, int G,
    int o0, int O, bool vec_w) {
  const int tid = threadIdx.x;
  uint16_t* rsc = reinterpret_cast<uint16_t*>(raw + 32 * kBN);  // [2][kBN]
  {  // packed: 32 rows x 8 chunks of 16 bytes, one a thread
    const int r = tid / 8, c = (tid % 8) * 16;
    const uint8_t* src = packed + static_cast<size_t>(g * 32 + r) * O + o0 + c;
    uint8_t* d = raw + r * kBN + c;
    if (vec_w) {
      const bool ok = o0 + c < O;
      cp_async16(d, ok ? src : packed, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) d[j] = o0 + c + j < O ? src[j] : 0;
    }
  }
  if (tid < 32) {  // scale rows g and G + g: 2 x 16 chunks of 8
    const int which = tid / 16, c = (tid % 16) * 8;
    const uint16_t* src =
        scales + static_cast<size_t>(which ? G + g : g) * O + o0 + c;
    uint16_t* d = rsc + which * kBN + c;
    if (vec_w) {
      const bool ok = o0 + c < O;
      cp_async16(d, ok ? src : scales, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) d[j] = o0 + c + j < O ? src[j] : 0;
    }
  }
}

// Group g's weight (load_weight_step) and the x tile of its 64 K-values into
// ring stage ``raw`` / ``xt``, x rounded to bf16: cp.async where ``vec_x``
// (bf16 x, 16-byte address), else plain loads.
template <int BM, bool XBF16>
__device__ __forceinline__ void mma_load_step(
    uint8_t* raw, uint16_t* xt, const void* xv, const uint8_t* packed,
    const uint16_t* scales, int g, int G, int o0, int n, int K, int O,
    bool vec_w, bool vec_x) {
  const int tid = threadIdx.x;
  load_weight_step(raw, packed, scales, g, G, o0, O, vec_w);
  const int half_k = K / 2;
  if (XBF16 && vec_x) {  // BM rows x 8 chunks (4 of each plane)
    const uint16_t* x = static_cast<const uint16_t*>(xv);
    for (int idx = tid; idx < BM * 8; idx += kMmaThreads) {
      const int m = idx / 8, cc = idx % 8;
      const int k = (cc < 4 ? 0 : half_k) + g * 32 + (cc % 4) * 8;
      const bool ok = m < n;
      cp_async16(xt + m * kXS + cc * 8,
                 ok ? x + static_cast<size_t>(m) * K + k : x, ok);
    }
  } else {
    for (int idx = tid; idx < BM * kKS; idx += kMmaThreads) {
      const int m = idx / kKS, kk = idx % kKS;
      const size_t off = static_cast<size_t>(m) * K + (kk < 32 ? 0 : half_k)
                         + g * 32 + (kk % 32);
      uint16_t v = 0;
      if (m < n)
        v = XBF16 ? static_cast<const uint16_t*>(xv)[off]
                  : float_to_bf16_bits(static_cast<const float*>(xv)[off]);
      xt[m * kXS + kk] = v;
    }
  }
}

template <int BM, bool XBF16>
__global__ void __launch_bounds__(kMmaThreads)
ps_mma_kernel(const void* __restrict__ xv,            // [n, K] bf16 or f32
              const uint8_t* __restrict__ packed,     // [K/2, O]
              const uint16_t* __restrict__ scales,    // [K/32, O] bf16
              const float* __restrict__ bias,         // [O] or null
              float* __restrict__ dst,  // [n, O] (splits == 1) or [splits, n, O]
              int n, int K, int O, int splits, int vec_w, int vec_x) {
  constexpr int WARPS_M = BM >= 32 ? 2 : 1;
  constexpr int WARPS_N = 8 / WARPS_M;
  constexpr int MI = BM / WARPS_M / 16;    // 16-row m-tiles of a warp
  constexpr int NI = kBN / WARPS_N / 8;    // 8-column n-tiles of a warp
  static_assert(NI % 2 == 0, "n-tiles come in ldmatrix.x4.trans pairs");
  constexpr int S = MmaRing<BM>::kStages;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* raw = smem;  // [S][kRawBytes]
  uint16_t* ws = reinterpret_cast<uint16_t*>(smem + S * kRawBytes);  // [2][kKS][kWS]
  uint16_t* xs = ws + 2 * kKS * kWS;  // [S][BM][kXS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int gid = lane / 4, qid = lane % 4;
  const int o0 = blockIdx.x * kBN;
  const int G = K / 64;
  const int split = blockIdx.y;
  const int g_begin = static_cast<int>(static_cast<long long>(G) * split / splits);
  const int g_end = static_cast<int>(static_cast<long long>(G) * (split + 1) / splits);
  const int steps = g_end - g_begin;
  // ldmatrix addresses of this lane in an A tile and a pair of B tiles
  const int a_row = wm * (BM / WARPS_M) + (lane % 16), a_col = (lane / 16) * 8;
  const int b_row = (lane % 8) + ((lane / 8) % 2) * 8, b_col = (lane / 16) * 8;

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

  // 16 packed bytes a thread of step ``it`` -> 16 lo and 16 hi bf16 weights
  // in weight buffer it % 2
  auto dequant = [&](int it) {
    const uint8_t* rs = raw + (it % S) * kRawBytes;
    const uint16_t* rsc = reinterpret_cast<const uint16_t*>(rs + 32 * kBN);
    const int r = tid / 8, c = (tid % 8) * 16;
    const uint4 bytes = *reinterpret_cast<const uint4*>(rs + r * kBN + c);
    const uint32_t bw[4] = {bytes.x, bytes.y, bytes.z, bytes.w};
    uint32_t lo[8], hi[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // bytes 4q .. 4q + 3
      const uint32_t l = bw[q] & 0x0F0F0F0Fu, h = (bw[q] >> 4) & 0x0F0F0F0Fu;
      const uint2 s2l = *reinterpret_cast<const uint2*>(rsc + c + 4 * q);
      const uint2 s2h = *reinterpret_cast<const uint2*>(rsc + kBN + c + 4 * q);
      lo[2 * q] = dequant_bf16x2<0>(l, s2l.x);
      lo[2 * q + 1] = dequant_bf16x2<2>(l, s2l.y);
      hi[2 * q] = dequant_bf16x2<0>(h, s2h.x);
      hi[2 * q + 1] = dequant_bf16x2<2>(h, s2h.y);
    }
    uint16_t* wt = ws + (it % 2) * kKS * kWS;
    uint4* wl = reinterpret_cast<uint4*>(wt + r * kWS + c);
    uint4* wh = reinterpret_cast<uint4*>(wt + (32 + r) * kWS + c);
    wl[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    wl[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
    wh[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    wh[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
  };

  // one commit group a step (empty past the last), so a wait's count always
  // names the same step; the weights of step it + 1 are dequantized while
  // step it runs on the tensor cores, with one barrier a step
#pragma unroll
  for (int p = 0; p < S - 1; ++p) {
    if (p < steps)
      mma_load_step<BM, XBF16>(raw + p * kRawBytes, xs + p * BM * kXS, xv,
                               packed, scales, g_begin + p, G, o0, n, K, O,
                               vec_w, vec_x);
    cp_async_commit();
  }
  cp_async_wait<S - 2>();  // step 0 landed
  __syncthreads();
  dequant(0);
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<S - 3>();  // step it + 1 landed
    // ws[it % 2] is complete, and every warp is done with step it - 1
    __syncthreads();
    if (it + S - 1 < steps) {  // into the stage step it - 1 used
      const int ps = (it + S - 1) % S;
      mma_load_step<BM, XBF16>(raw + ps * kRawBytes, xs + ps * BM * kXS, xv,
                               packed, scales, g_begin + it + S - 1, G, o0, n,
                               K, O, vec_w, vec_x);
    }
    cp_async_commit();
    if (it + 1 < steps) dequant(it + 1);
    const uint16_t* xt = xs + (it % S) * BM * kXS;
    const uint16_t* wt = ws + (it % 2) * kKS * kWS;
#pragma unroll
    for (int kk = 0; kk < kKS / 16; ++kk) {
      uint32_t a[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldmatrix_x4(a[mi], xt + (a_row + mi * 16) * kXS + kk * 16 + a_col);
#pragma unroll
      for (int np = 0; np < NI / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, wt + (kk * 16 + b_row) * kWS
                                 + wn * (kBN / WARPS_N) + np * 16 + b_col);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          mma_bf16(acc[mi][2 * np], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // this thread holds rows (gid, gid + 8) of each m-tile, columns 2 qid, +1
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int col = o0 + wn * (kBN / WARPS_N) + ni * 8 + 2 * qid;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = wm * (BM / WARPS_M) + mi * 16 + gid + (e >= 2 ? 8 : 0);
        const int o = col + (e & 1);
        if (m >= n || o >= O) continue;
        if (splits == 1)
          dst[static_cast<size_t>(m) * O + o] = acc[mi][ni][e] + (bias ? bias[o] : 0.f);
        else
          dst[(static_cast<size_t>(split) * n + m) * O + o] = acc[mi][ni][e];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 9-128 rows, f32 planes: mma.sync TF32
// ---------------------------------------------------------------------------

constexpr int kWF = kBN + 4;  // f32 row stride of the weight tile (4 mod 32)
constexpr int kXF = kKS + 8;  // f32 row stride of an f32 x tile (8 mod 32)

// Ring depth by row tile and x dtype: as deep as shared memory allows two
// blocks an SM up to 32 rows (the split plan's occupancy) and one past.
template <int BM, bool XBF16>
struct Tf32Ring {
  static constexpr int kStages = BM == 16 ? (XBF16 ? 6 : 5)
                                 : BM == 32 ? (XBF16 ? 5 : 3)
                                 : BM == 64 ? 4 : (XBF16 ? 4 : 3);
  static constexpr int kXBytes = XBF16 ? BM * kXS * 2 : BM * kXF * 4;
  static constexpr size_t kSmem =
      kStages * (kRawBytes + kXBytes) + 2 * kKS * kWF * sizeof(float);
};

// x's 64 K-values of group g (32 of each plane) into ``xt``, as they are
// (bf16, or f32 split later in the fragments), rows past n zero: cp.async
// where ``vec_x`` (16-byte address), else plain loads.
template <int BM, bool XBF16>
__device__ __forceinline__ void tf32_load_x(uint8_t* xt, const void* xv,
                                            int g, int n, int K, bool vec_x) {
  using T = std::conditional_t<XBF16, uint16_t, float>;
  constexpr int kEl = 16 / sizeof(T);          // values a 16-byte chunk
  constexpr int kHalfChunks = 32 / kEl;        // chunks of a plane's 32
  constexpr int kRow = XBF16 ? kXS : kXF;      // values a row of xt
  const int tid = threadIdx.x, half_k = K / 2;
  T* d = reinterpret_cast<T*>(xt);
  const T* x = static_cast<const T*>(xv);
  if (vec_x) {
    for (int idx = tid; idx < BM * 2 * kHalfChunks; idx += kMmaThreads) {
      const int m = idx / (2 * kHalfChunks), cc = idx % (2 * kHalfChunks);
      const int k = (cc < kHalfChunks ? 0 : half_k) + g * 32
                    + (cc % kHalfChunks) * kEl;
      const bool ok = m < n;
      cp_async16(d + m * kRow + cc * kEl,
                 ok ? x + static_cast<size_t>(m) * K + k : x, ok);
    }
  } else {
    for (int idx = tid; idx < BM * kKS; idx += kMmaThreads) {
      const int m = idx / kKS, kk = idx % kKS;
      const size_t off = static_cast<size_t>(m) * K + (kk < 32 ? 0 : half_k)
                         + g * 32 + (kk % 32);
      d[m * kRow + kk] = m < n ? x[off] : T(0);
    }
  }
}

// Fragments: an m16n8k8 step takes K-values kk*8 .. kk*8 + 7 with slot t of
// the fragment holding K-value kk*8 + 2t and slot t + 4 kk*8 + 2t + 1, so a
// thread reads its x pair in one load; the NI n-tiles of a warp interleave
// their columns (fragment column j of n-tile q*NR + r is the warp's column
// q*8*NR + j*NR + r), so a thread reads its weights of NR n-tiles in one
// load and stores NR neighbouring outputs at once.
template <int BM, bool XBF16>
__global__ void __launch_bounds__(kMmaThreads, BM <= 32 ? 2 : 1)
ps_tf32_kernel(const void* __restrict__ xv,            // [n, K] bf16 or f32
               const uint8_t* __restrict__ packed,     // [K/2, O]
               const uint16_t* __restrict__ scales,    // [K/32, O] bf16
               const float* __restrict__ bias,         // [O] or null
               float* __restrict__ dst,  // [n, O] (splits == 1) or [splits, n, O]
               int n, int K, int O, int splits, int vec_w, int vec_x) {
  constexpr int WARPS_M = BM == 16 ? 1 : (BM == 128 ? 4 : 2);
  constexpr int WARPS_N = 8 / WARPS_M;
  constexpr int MI = BM / WARPS_M / 16;  // 16-row m-tiles of a warp
  constexpr int WCOLS = kBN / WARPS_N;   // columns of a warp
  constexpr int NI = WCOLS / 8;          // 8-column n-tiles of a warp
  constexpr int NR = NI < 4 ? NI : 4;    // n-tiles whose columns interleave
  using Ring = Tf32Ring<BM, XBF16>;
  constexpr int S = Ring::kStages;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* raw = smem;  // [S][kRawBytes]
  float* ws = reinterpret_cast<float*>(smem + S * kRawBytes);  // [2][kKS][kWF]
  uint8_t* xs = reinterpret_cast<uint8_t*>(ws + 2 * kKS * kWF);  // [S][kXBytes]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int gid = lane / 4, qid = lane % 4;
  const int o0 = blockIdx.x * kBN;
  const int G = K / 64;
  const int split = blockIdx.y;
  const int g_begin = static_cast<int>(static_cast<long long>(G) * split / splits);
  const int g_end = static_cast<int>(static_cast<long long>(G) * (split + 1) / splits);
  const int steps = g_end - g_begin;
  const int m_base = wm * (BM / WARPS_M), c_base = wn * WCOLS;

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

  // packed rows r0 .. r0 + 3, columns cq .. cq + 3 of step ``it`` -> their 16
  // lo and 16 hi weights (v - 8) * s, exact in f32 and in TF32, in weight
  // buffer it % 2; a warp writes 512 contiguous bytes a row
  auto dequant = [&](int it) {
    const uint8_t* rs = raw + (it % S) * kRawBytes;
    const uint16_t* rsc = reinterpret_cast<const uint16_t*>(rs + 32 * kBN);
    const int cq = (tid % 32) * 4, r0 = (tid / 32) * 4;
    const uint2 s2l = *reinterpret_cast<const uint2*>(rsc + cq);
    const uint2 s2h = *reinterpret_cast<const uint2*>(rsc + kBN + cq);
    float sl[4], sh[4];
    unpack_bf16x2(s2l.x, sl[0], sl[1]);
    unpack_bf16x2(s2l.y, sl[2], sl[3]);
    unpack_bf16x2(s2h.x, sh[0], sh[1]);
    unpack_bf16x2(s2h.y, sh[2], sh[3]);
    float* wt = ws + (it % 2) * kKS * kWF;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t w =
          *reinterpret_cast<const uint32_t*>(rs + (r0 + i) * kBN + cq);
      const uint32_t lo = w & 0x0F0F0F0Fu, hi = (w >> 4) & 0x0F0F0F0Fu;
      *reinterpret_cast<float4*>(wt + (r0 + i) * kWF + cq) = make_float4(
          nib_f<0>(lo) * sl[0], nib_f<1>(lo) * sl[1], nib_f<2>(lo) * sl[2],
          nib_f<3>(lo) * sl[3]);
      *reinterpret_cast<float4*>(wt + (32 + r0 + i) * kWF + cq) = make_float4(
          nib_f<0>(hi) * sh[0], nib_f<1>(hi) * sh[1], nib_f<2>(hi) * sh[2],
          nib_f<3>(hi) * sh[3]);
    }
  };
  auto load = [&](int stage, int g) {
    load_weight_step(raw + stage * kRawBytes, packed, scales, g, G, o0, O,
                     vec_w);
    tf32_load_x<BM, XBF16>(xs + stage * Ring::kXBytes, xv, g, n, K, vec_x);
  };

  // the bf16 instance's pipeline: one commit group a step, one barrier a
  // step, the weights of step it + 1 dequantized while step it runs
#pragma unroll
  for (int p = 0; p < S - 1; ++p) {
    if (p < steps) load(p, g_begin + p);
    cp_async_commit();
  }
  cp_async_wait<S - 2>();  // step 0 landed
  __syncthreads();
  dequant(0);
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<S - 3>();  // step it + 1 landed
    // ws[it % 2] is complete, and every warp is done with step it - 1
    __syncthreads();
    if (it + S - 1 < steps) load((it + S - 1) % S, g_begin + it + S - 1);
    cp_async_commit();
    if (it + 1 < steps) dequant(it + 1);
    const uint8_t* xt = xs + (it % S) * Ring::kXBytes;
    const float* wt = ws + (it % 2) * kKS * kWF;
    // a fresh fragment a step, added to the accumulator in f32 afterwards:
    // the tensor cores' own additions keep no guard bits, so their error
    // stays relative to one group's sum, not to the whole split's
    float part[MI][NI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
        part[mi][ni][0] = part[mi][ni][1] = part[mi][ni][2] = part[mi][ni][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKS / 8; ++kk) {
      const int kr = kk * 8 + 2 * qid;  // K-value of slot qid (+1: qid + 4)
      uint32_t b[NI][2];
#pragma unroll
      for (int q = 0; q < NI / NR; ++q) {
        const float* p0 = wt + kr * kWF + c_base + q * 8 * NR + gid * NR;
        if constexpr (NR == 4) {
          const uint4 u = *reinterpret_cast<const uint4*>(p0);
          const uint4 v = *reinterpret_cast<const uint4*>(p0 + kWF);
          b[4 * q][0] = u.x, b[4 * q + 1][0] = u.y;
          b[4 * q + 2][0] = u.z, b[4 * q + 3][0] = u.w;
          b[4 * q][1] = v.x, b[4 * q + 1][1] = v.y;
          b[4 * q + 2][1] = v.z, b[4 * q + 3][1] = v.w;
        } else {
          const uint2 u = *reinterpret_cast<const uint2*>(p0);
          const uint2 v = *reinterpret_cast<const uint2*>(p0 + kWF);
          b[2 * q][0] = u.x, b[2 * q + 1][0] = u.y;
          b[2 * q][1] = v.x, b[2 * q + 1][1] = v.y;
        }
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int row = m_base + mi * 16 + gid;
        if constexpr (XBF16) {  // a bf16 pair is two exact TF32 values
          const uint32_t* xw = reinterpret_cast<const uint32_t*>(xt);
          const uint32_t p0 = xw[row * (kXS / 2) + kr / 2];
          const uint32_t p1 = xw[(row + 8) * (kXS / 2) + kr / 2];
          const uint32_t a[4] = {p0 << 16, p1 << 16, p0 & 0xFFFF0000u,
                                 p1 & 0xFFFF0000u};
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
            mma_tf32(part[mi][ni], a, b[ni][0], b[ni][1]);
        } else {
          const float* xf = reinterpret_cast<const float*>(xt);
          const float2 p0 = *reinterpret_cast<const float2*>(xf + row * kXF + kr);
          const float2 p1 =
              *reinterpret_cast<const float2*>(xf + (row + 8) * kXF + kr);
          FragA3 a;
          a.set(p0.x, p1.x, p0.y, p1.y);
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
            mma_tf32(part[mi][ni], a.small, b[ni][0], b[ni][1]);
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
            mma_tf32(part[mi][ni], a.big, b[ni][0], b[ni][1]);
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[mi][ni][e];
  }
  cp_async_wait<0>();

  // this thread holds rows (gid, gid + 8) of each m-tile and, of each group
  // of NR n-tiles, fragment columns 2 qid and 2 qid + 1: NR neighbouring
  // columns each
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m_base + mi * 16 + gid + 8 * h;
      if (m >= n) continue;
      float* out = dst + (splits == 1 ? static_cast<size_t>(m)
                                      : static_cast<size_t>(split) * n + m) * O;
#pragma unroll
      for (int q = 0; q < NI / NR; ++q) {
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int col = o0 + c_base + q * 8 * NR + (2 * qid + e1) * NR;
          float v[NR];
#pragma unroll
          for (int r = 0; r < NR; ++r) {
            v[r] = acc[mi][q * NR + r][2 * h + e1];
            if (splits == 1 && bias && col + r < O) v[r] += bias[col + r];
          }
          if (O % NR == 0 && col + NR <= O) {
            if constexpr (NR == 4)
              *reinterpret_cast<float4*>(out + col) =
                  make_float4(v[0], v[1], v[2], v[3]);
            else
              *reinterpret_cast<float2*>(out + col) = make_float2(v[0], v[1]);
          } else {
#pragma unroll
            for (int r = 0; r < NR; ++r)
              if (col + r < O) out[col + r] = v[r];
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <int NR, bool ROUND>
void launch_gemv(const void* x, int x_is_bf16, const uint8_t* packed,
                 const uint16_t* scales, const float* bias, float* dst, int n,
                 int K, int O, int splits, cudaStream_t s) {
  const dim3 grid((O + kTileO - 1) / kTileO, 1, splits);
  ps_gemv_kernel<NR, ROUND><<<grid, kGemvThreads, 0, s>>>(
      x, x_is_bf16, packed, scales, bias, dst, n, K, O, splits);
}

template <bool ROUND>
void gemv_rows(const void* x, int x_is_bf16, const uint8_t* packed,
               const uint16_t* scales, const float* bias, float* dst, int n,
               int K, int O, int splits, cudaStream_t s) {
  if (n == 1)
    launch_gemv<1, ROUND>(x, x_is_bf16, packed, scales, bias, dst, n, K, O, splits, s);
  else if (n == 2)
    launch_gemv<2, ROUND>(x, x_is_bf16, packed, scales, bias, dst, n, K, O, splits, s);
  else if (n <= 4)
    launch_gemv<4, ROUND>(x, x_is_bf16, packed, scales, bias, dst, n, K, O, splits, s);
  else
    launch_gemv<8, ROUND>(x, x_is_bf16, packed, scales, bias, dst, n, K, O, splits, s);
}

// One block a 128-column tile and split of K, ``smem`` bytes of dynamic
// shared memory; cp.async for the weight where O % 16 == 0 and it is 16-byte
// aligned, for x where ``x_vec`` and x is.
template <typename Kern>
cudaError_t launch_tiles(Kern kern, size_t smem, bool x_vec, const void* x,
                         const uint8_t* packed, const uint16_t* scales,
                         const float* bias, float* dst, int n, int K, int O,
                         int splits, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_w = O % 16 == 0 && aligned(packed) && aligned(scales);
  const int vec_x = x_vec && aligned(x);
  const dim3 grid((O + kBN - 1) / kBN, splits);
  kern<<<grid, kMmaThreads, smem, s>>>(x, packed, scales, bias, dst, n, K, O,
                                       splits, vec_w, vec_x);
  return cudaGetLastError();
}

// 9-128 rows: the bf16-plane (ROUND) or the TF32 instance at the row tile
// that holds n
template <bool ROUND, bool XBF16, int BM>
cudaError_t launch_rows_at(const void* x, const uint8_t* packed,
                           const uint16_t* scales, const float* bias,
                           float* dst, int n, int K, int O, int splits,
                           cudaStream_t s) {
  if constexpr (ROUND)
    return launch_tiles(ps_mma_kernel<BM, XBF16>, MmaRing<BM>::kSmem, XBF16,
                        x, packed, scales, bias, dst, n, K, O, splits, s);
  else
    return launch_tiles(ps_tf32_kernel<BM, XBF16>, Tf32Ring<BM, XBF16>::kSmem,
                        true, x, packed, scales, bias, dst, n, K, O, splits, s);
}

template <bool ROUND, bool XBF16>
cudaError_t tile_rows(const void* x, const uint8_t* packed,
                      const uint16_t* scales, const float* bias, float* dst,
                      int n, int K, int O, int splits, cudaStream_t s) {
  if (n <= 16) return launch_rows_at<ROUND, XBF16, 16>(x, packed, scales, bias, dst, n, K, O, splits, s);
  if (n <= 32) return launch_rows_at<ROUND, XBF16, 32>(x, packed, scales, bias, dst, n, K, O, splits, s);
  if (n <= 64) return launch_rows_at<ROUND, XBF16, 64>(x, packed, scales, bias, dst, n, K, O, splits, s);
  return launch_rows_at<ROUND, XBF16, 128>(x, packed, scales, bias, dst, n, K, O, splits, s);
}

}  // namespace

// y [n, O] f32.  n <= 8: the GEMV, O % 4 == 0 and a 4-byte (packed) /
// 8-byte (scales) aligned weight; 9 <= n <= 128: the tensor cores, bf16
// products with round_planes, TF32 ones without.  ``splits`` > 1 splits K in
// whole groups into ``partial`` [splits, n, O], then a second pass sums it
// with the bias.
extern "C" int q4_matmul_ps_launch(const void* x, int x_is_bf16,
                                   int round_planes, const void* packed,
                                   const void* scales, const void* bias,
                                   void* partial, void* out, int n, int K,
                                   int O, int splits, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto pp = static_cast<const uint8_t*>(packed);
  auto sp = static_cast<const uint16_t*>(scales);
  auto bp = static_cast<const float*>(bias);
  auto op = static_cast<float*>(out);
  float* dst = splits > 1 ? static_cast<float*>(partial) : op;
  if (n < 1 || n > 128 || K % 64 || splits < 1 || splits > K / 64
      || (splits > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  if (n <= 8) {
    if (O % 4) return static_cast<int>(cudaErrorInvalidValue);
    if (round_planes)
      gemv_rows<true>(x, x_is_bf16, pp, sp, bp, dst, n, K, O, splits, s);
    else
      gemv_rows<false>(x, x_is_bf16, pp, sp, bp, dst, n, K, O, splits, s);
    err = cudaGetLastError();
  } else if (round_planes) {
    err = x_is_bf16 ? tile_rows<true, true>(x, pp, sp, bp, dst, n, K, O, splits, s)
                    : tile_rows<true, false>(x, pp, sp, bp, dst, n, K, O, splits, s);
  } else {
    err = x_is_bf16 ? tile_rows<false, true>(x, pp, sp, bp, dst, n, K, O, splits, s)
                    : tile_rows<false, false>(x, pp, sp, bp, dst, n, K, O, splits, s);
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int total = n * O, per = kReduceThreads / reduce_lanes(splits);
  ps_split_reduce_kernel<<<(total + per - 1) / per, kReduceThreads, 0, s>>>(
      static_cast<const float*>(partial), bp, op, total, O, splits);
  return static_cast<int>(cudaGetLastError());
}
