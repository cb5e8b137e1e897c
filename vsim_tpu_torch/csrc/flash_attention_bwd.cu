// K7 flash_attention_bwd_dq and K8 flash_attention_bwd_dkv: the backward of
// causal blockwise attention (K4), recomputing p from q, k and the saved lse.
//
// Replaces vsim_tpu/ops/attention.py:_bwd_dq_kernel (:196, K7) and
// _bwd_dkv_kernel (:236, K8) with the same function: q, k, v and do (do
// already rounded to q's dtype by the caller) widened to f32, s = q.k * scale
// (+ slope_h * s), p = exp(s - lse), 0 where the key is masked (s > n_past + t
// or s >= S) and where lse == -FLT_MAX (a row that saw no key), dp = do.v,
// ds = p * (dp - dsum) * scale with dsum = rowsum(do * out) from the caller,
// dq = ds.k, dk = ds^T.q, dv = p^T.do, all in f32 with p unrounded; each
// gradient is stored in its input's dtype.  Two passes as in the JAX package,
// so no atomics: every output element is written by one thread once, and
// the gradients are bit-identical from run to run.
//
// Bound on the H100: operations at training lengths (K7 6 D, K8 8 D flops
// per visible (query, key) pair).  Two instances, picked by the caller
// (ops/attention.py:flash_attention_bwd_route):
//
// "mma_3xtf32", f32 at D = 64 and 128, on the tensor cores: each f32
// product is three mma.sync m16n8k8 TF32 products of the operands split
// into big + small TF32 halves (common.cuh).  Emulated on the CPU with
// exact sums (tests/test_torch_flash_bwd.py) that keeps the gradients
// within ~1e-6 of max|plain|, where one TF32 product per f32 product misses
// by ~1e-3; on the card, whose MMAs sum in their own f32 order, dk and dv
// come within ~3e-5 at T = 2048 (chip_smoke.py phase 2).  A block of 4
// warps holds 64 rows resident (K7: queries, q and do; K8: keys, k and v),
// 16 rows a warp, and streams the other side's tiles through a two-stage
// ring of 16-byte cp.async copies (K7: 32 keys of k and v at D = 64, 64 at
// D = 128; K8: 32 queries of q, do, lse and dsum).  Each warp computes its
// 16 rows' scores and dp against the tile (K7: S = Q K^T and dP = dO V^T;
// K8: S^T = K Q^T and dP^T = V dO^T, so K8's rows are keys and no
// transpose is needed), p and ds in the accumulator registers, and then
// its gradient rows (K7: dQ += dS K; K8: dV += P^T dO, dK += dS^T Q) with
// the accumulators in registers for the whole walk.  The m16n8k8
// accumulator holds columns 2t, 2t+1 of a row where the A operand wants
// columns t, t+4; the second product relabels its k index (k slot t is
// column 2t, slot t+4 column 2t+1) and reads the B rows 2t, 2t+1 to match,
// so p and ds go from accumulator to A operand in registers, with no
// shared-memory staging or shuffles.  Shared rows are f32 padded to D + 4
// floats: both fragment patterns (row g col t; row 2t col g) hit 32
// distinct banks.  Operands are split as each fragment is loaded (an
// integer add and mask, and an f32 subtract).  What holds it back on the
// H100 is latency, not a pipe: the MMAs and the split arithmetic do not
// overlap, and more warps an SM are what helped most (32-row streamed
// tiles at D = 64 fit three blocks an SM), so the tiles are sized for
// occupancy.  K7 schedules its longest causal walks first; K8's block 0 has
// the longest walk already.  A warp skips a tile none of its rows sees, and
// tests the causal mask only on tiles that cross the diagonal.
//
// "fma", bf16 at any D and f32 at other D, on the FMA units from shared
// memory: 256 threads, 32-row query tiles and 32-key tiles, rows padded to
// D + 4 floats so each lane reads its own key row as float4 without bank
// conflicts.  In the score pass a warp takes 4 query rows and a lane one
// key, and both dot products (q.k, do.v) share each float4 of k and v.  In
// the accumulation pass a thread owns one row (K7: a query row of dq; K8: a
// key row of dk and dv) and D/8 of its columns in registers.  At D = 256 K8
// takes 142 KB of dynamic shared memory and 64 accumulator registers.
//
// Both K7s walk the key tiles up to the query tile's causal horizon; both
// K8s walk the query tiles from the first one that sees their key tile, and
// write zeros for key rows no query sees.

#include "common.cuh"

namespace {

constexpr int kBQ = 32;        // query rows per tile
constexpr int kBS = 32;        // keys per tile (one per lane in the score pass)
constexpr int kThreads = 256;  // 8 warps
constexpr int kRowsPerWarp = kBQ / (kThreads / 32);  // 4
constexpr int kPS = kBS + 1;   // padded row of the p / ds tiles
constexpr int kMaxD = 256;

template <bool BF16>
__device__ __forceinline__ float4 load4(const void* p, size_t i) {
  if (BF16) {
    const uint2 u =
        *reinterpret_cast<const uint2*>(static_cast<const uint16_t*>(p) + i);
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xFFFF0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xFFFF0000u));
  }
  return *reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
}

template <bool BF16>
__device__ __forceinline__ void store4(void* p, size_t i, float4 v) {
  if (BF16) {
    uint2 u;
    u.x = static_cast<uint32_t>(float_to_bf16_bits(v.x)) |
          (static_cast<uint32_t>(float_to_bf16_bits(v.y)) << 16);
    u.y = static_cast<uint32_t>(float_to_bf16_bits(v.z)) |
          (static_cast<uint32_t>(float_to_bf16_bits(v.w)) << 16);
    *reinterpret_cast<uint2*>(static_cast<uint16_t*>(p) + i) = u;
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(p) + i) = v;
  }
}

// rows [row0, row0 + n) of one head's [rows, D] matrix at element ``base``
// into sm[n][DP] as f32; rows past ``rows`` read as zeros.
template <bool BF16>
__device__ __forceinline__ void load_tile(float* sm, const void* g,
                                          size_t base, int row0, int n,
                                          int rows, int D, int DP) {
  const int d4 = D / 4;
  for (int idx = threadIdx.x; idx < n * d4; idx += kThreads) {
    const int r = idx / d4, d = (idx % d4) * 4;
    const int row = row0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < rows) val = load4<BF16>(g, base + static_cast<size_t>(row) * D + d);
    *reinterpret_cast<float4*>(sm + r * DP + d) = val;
  }
}

// The per-row scalars of a query tile: lse (-FLT_MAX past T, so p = 0 there)
// and dsum.
__device__ __forceinline__ void load_row_stats(float* lse_s, float* dsum_s,
                                               const float* lse,
                                               const float* dsum, size_t base,
                                               int q0, int T) {
  const int r = threadIdx.x;
  if (r < kBQ) {
    const int t = q0 + r;
    lse_s[r] = t < T ? lse[base + t] : VSIM_NEG_INF;
    dsum_s[r] = t < T ? dsum[base + t] : 0.f;
  }
}

// Score pass of one warp: for query rows r0 .. r0+3 of the tile and this
// lane's key, p and ds (see the header).  q0/s0 place the tiles.
__device__ __forceinline__ void probs(const float* qs, const float* dos,
                                      const float* ks, const float* vs,
                                      const float* lse_s, const float* dsum_s,
                                      int r0, int lane, int q0, int s0, int T,
                                      int S, int D, int DP, int n_past,
                                      float scale, float slope,
                                      float (&p)[kRowsPerWarp],
                                      float (&ds)[kRowsPerWarp]) {
  float sd[kRowsPerWarp], pd[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) sd[i] = pd[i] = 0.f;
  const float* kr = ks + lane * DP;
  const float* vr = vs + lane * DP;
  for (int d = 0; d < D; d += 4) {
    const float4 kk = *reinterpret_cast<const float4*>(kr + d);
    const float4 vv = *reinterpret_cast<const float4*>(vr + d);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float4 qq = *reinterpret_cast<const float4*>(qs + (r0 + i) * DP + d);
      const float4 oo = *reinterpret_cast<const float4*>(dos + (r0 + i) * DP + d);
      sd[i] = fmaf(qq.x, kk.x, sd[i]);
      sd[i] = fmaf(qq.y, kk.y, sd[i]);
      sd[i] = fmaf(qq.z, kk.z, sd[i]);
      sd[i] = fmaf(qq.w, kk.w, sd[i]);
      pd[i] = fmaf(oo.x, vv.x, pd[i]);
      pd[i] = fmaf(oo.y, vv.y, pd[i]);
      pd[i] = fmaf(oo.z, vv.z, pd[i]);
      pd[i] = fmaf(oo.w, vv.w, pd[i]);
    }
  }
  const int s = s0 + lane;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + i;
    const int t = q0 + r;
    const float lse_r = lse_s[r];
    const bool live = t < T && s < S && s <= n_past + t && lse_r != VSIM_NEG_INF;
    const float sc = sd[i] * scale + slope * static_cast<float>(s);
    p[i] = live ? expf(sc - lse_r) : 0.f;
    ds[i] = p[i] * (pd[i] - dsum_s[r]) * scale;
  }
}

// K7: one block per (b, h, 32-query tile); NG = D / 32 rounded up (2, 4, 8).
template <bool BF16, int NG>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const void* __restrict__ q,     // [B, H, T, D]
                    const void* __restrict__ k,     // [B, H, S, D]
                    const void* __restrict__ v,     // [B, H, S, D]
                    const void* __restrict__ do_,   // [B, H, T, D]
                    const float* __restrict__ lse,  // [B, H, T]
                    const float* __restrict__ dsum, // [B, H, T]
                    void* __restrict__ dq,          // [B, H, T, D]
                    const float* __restrict__ slopes,  // [H] or null
                    int H, int T, int S, int D, int n_past, float scale) {
  extern __shared__ __align__(16) float sm[];
  const int DP = D + 4;
  float* qs = sm;                 // [kBQ][DP]
  float* dos = qs + kBQ * DP;     // [kBQ][DP]
  float* ks = dos + kBQ * DP;     // [kBS][DP]
  float* vs = ks + kBS * DP;      // [kBS][DP]
  float* dss = vs + kBS * DP;     // [kBQ][kPS]
  float* lse_s = dss + kBQ * kPS; // [kBQ]
  float* dsum_s = lse_s + kBQ;    // [kBQ]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const size_t qbase = static_cast<size_t>(bh) * T * D;
  const size_t kvbase = static_cast<size_t>(bh) * S * D;
  const float slope = slopes ? slopes[h] : 0.f;

  load_tile<BF16>(qs, q, qbase, q0, kBQ, T, D, DP);
  load_tile<BF16>(dos, do_, qbase, q0, kBQ, T, D, DP);
  load_row_stats(lse_s, dsum_s, lse, dsum, static_cast<size_t>(bh) * T, q0, T);
  // keys any query of this tile can see
  const int last_t = min(q0 + kBQ, T) - 1;
  const int n_keys = min(S, n_past + last_t + 1);

  const int row = tid / 8, c = tid % 8;
  const int r0 = warp * kRowsPerWarp;
  float acc[4 * NG];
#pragma unroll
  for (int j = 0; j < 4 * NG; ++j) acc[j] = 0.f;

  for (int s0 = 0; s0 < n_keys; s0 += kBS) {
    __syncthreads();  // q staged / previous tile consumed
    load_tile<BF16>(ks, k, kvbase, s0, kBS, S, D, DP);
    load_tile<BF16>(vs, v, kvbase, s0, kBS, S, D, DP);
    __syncthreads();
    float p[kRowsPerWarp], ds[kRowsPerWarp];
    probs(qs, dos, ks, vs, lse_s, dsum_s, r0, lane, q0, s0, T, S, D, DP,
          n_past, scale, slope, p, ds);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) dss[(r0 + i) * kPS + lane] = ds[i];
    __syncthreads();
    for (int j = 0; j < kBS; ++j) {
      const float g = dss[row * kPS + j];
      const float* kr = ks + j * DP;
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) {
        const int col = gi * 32 + c * 4;
        if (col < D) {
          const float4 kk = *reinterpret_cast<const float4*>(kr + col);
          acc[4 * gi + 0] = fmaf(g, kk.x, acc[4 * gi + 0]);
          acc[4 * gi + 1] = fmaf(g, kk.y, acc[4 * gi + 1]);
          acc[4 * gi + 2] = fmaf(g, kk.z, acc[4 * gi + 2]);
          acc[4 * gi + 3] = fmaf(g, kk.w, acc[4 * gi + 3]);
        }
      }
    }
  }

  const int t = q0 + row;
  if (t >= T) return;
  const size_t obase = qbase + static_cast<size_t>(t) * D;
#pragma unroll
  for (int gi = 0; gi < NG; ++gi) {
    const int col = gi * 32 + c * 4;
    if (col < D)
      store4<BF16>(dq, obase + col,
                   make_float4(acc[4 * gi], acc[4 * gi + 1], acc[4 * gi + 2],
                               acc[4 * gi + 3]));
  }
}

// K8: one block per (b, h, 32-key tile).
template <bool BF16, int NG>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const void* __restrict__ q, const void* __restrict__ k,
                     const void* __restrict__ v, const void* __restrict__ do_,
                     const float* __restrict__ lse,
                     const float* __restrict__ dsum,
                     void* __restrict__ dk,   // [B, H, S, D], k's dtype
                     void* __restrict__ dv,   // [B, H, S, D], v's dtype
                     const float* __restrict__ slopes, int H, int T, int S,
                     int D, int n_past, float scale) {
  extern __shared__ __align__(16) float sm[];
  const int DP = D + 4;
  float* ks = sm;                 // [kBS][DP]
  float* vs = ks + kBS * DP;      // [kBS][DP]
  float* qs = vs + kBS * DP;      // [kBQ][DP]
  float* dos = qs + kBQ * DP;     // [kBQ][DP]
  float* ps = dos + kBQ * DP;     // [kBQ][kPS]
  float* dss = ps + kBQ * kPS;    // [kBQ][kPS]
  float* lse_s = dss + kBQ * kPS; // [kBQ]
  float* dsum_s = lse_s + kBQ;    // [kBQ]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y, h = bh % H;
  const int s0 = blockIdx.x * kBS;
  const size_t qbase = static_cast<size_t>(bh) * T * D;
  const size_t kvbase = static_cast<size_t>(bh) * S * D;
  const float slope = slopes ? slopes[h] : 0.f;

  load_tile<BF16>(ks, k, kvbase, s0, kBS, S, D, DP);
  load_tile<BF16>(vs, v, kvbase, s0, kBS, S, D, DP);

  const int key = tid / 8, c = tid % 8;
  const int r0 = warp * kRowsPerWarp;
  float dka[4 * NG], dva[4 * NG];
#pragma unroll
  for (int j = 0; j < 4 * NG; ++j) dka[j] = dva[j] = 0.f;

  // query t sees key s0 iff n_past + t >= s0: start at the tile of
  // t = s0 - n_past; tiles no query reaches leave the zeros
  const int first = s0 > n_past ? (s0 - n_past) / kBQ : 0;
  const int n_qt = (T + kBQ - 1) / kBQ;
  for (int it = first; it < n_qt; ++it) {
    const int q0 = it * kBQ;
    __syncthreads();  // previous query tile consumed
    load_tile<BF16>(qs, q, qbase, q0, kBQ, T, D, DP);
    load_tile<BF16>(dos, do_, qbase, q0, kBQ, T, D, DP);
    load_row_stats(lse_s, dsum_s, lse, dsum, static_cast<size_t>(bh) * T, q0, T);
    __syncthreads();
    float p[kRowsPerWarp], ds[kRowsPerWarp];
    probs(qs, dos, ks, vs, lse_s, dsum_s, r0, lane, q0, s0, T, S, D, DP,
          n_past, scale, slope, p, ds);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      ps[(r0 + i) * kPS + lane] = p[i];
      dss[(r0 + i) * kPS + lane] = ds[i];
    }
    __syncthreads();
    for (int r = 0; r < kBQ; ++r) {
      const float pr = ps[r * kPS + key], gr = dss[r * kPS + key];
      const float* qr = qs + r * DP;
      const float* orow = dos + r * DP;
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) {
        const int col = gi * 32 + c * 4;
        if (col < D) {
          const float4 oo = *reinterpret_cast<const float4*>(orow + col);
          const float4 qq = *reinterpret_cast<const float4*>(qr + col);
          dva[4 * gi + 0] = fmaf(pr, oo.x, dva[4 * gi + 0]);
          dva[4 * gi + 1] = fmaf(pr, oo.y, dva[4 * gi + 1]);
          dva[4 * gi + 2] = fmaf(pr, oo.z, dva[4 * gi + 2]);
          dva[4 * gi + 3] = fmaf(pr, oo.w, dva[4 * gi + 3]);
          dka[4 * gi + 0] = fmaf(gr, qq.x, dka[4 * gi + 0]);
          dka[4 * gi + 1] = fmaf(gr, qq.y, dka[4 * gi + 1]);
          dka[4 * gi + 2] = fmaf(gr, qq.z, dka[4 * gi + 2]);
          dka[4 * gi + 3] = fmaf(gr, qq.w, dka[4 * gi + 3]);
        }
      }
    }
  }

  const int s = s0 + key;
  if (s >= S) return;
  const size_t obase = kvbase + static_cast<size_t>(s) * D;
#pragma unroll
  for (int gi = 0; gi < NG; ++gi) {
    const int col = gi * 32 + c * 4;
    if (col < D) {
      store4<BF16>(dk, obase + col,
                   make_float4(dka[4 * gi], dka[4 * gi + 1], dka[4 * gi + 2],
                               dka[4 * gi + 3]));
      store4<BF16>(dv, obase + col,
                   make_float4(dva[4 * gi], dva[4 * gi + 1], dva[4 * gi + 2],
                               dva[4 * gi + 3]));
    }
  }
}

// ---------------------------------------------------------------------------
// "mma_3xtf32": f32 at D = 64 and 128 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;  // 4 warps, 16 resident rows each
constexpr int kTcRows = 64;      // resident rows (K7 queries, K8 keys)

// Rows of a streamed tile: K7's keys, K8's queries.  32 keep a D = 64 block
// at 70 KB of shared memory and at most 168 registers a thread, so that
// three blocks (12 warps) share an SM and hide the MMAs' latency; at D = 128
// one block fills an SM whatever the tile, and K7 takes 64 keys, a barrier
// pair per 64.
__host__ __device__ constexpr int tc_bs(int D) { return D <= 64 ? 32 : 64; }
constexpr int kTcQueries = 32;

// Rows [row0, row0 + n) of one head's [rows, D] f32 matrix into sm[n][D + 4]
// by 16-byte cp.async; rows past ``rows`` read as zeros.
template <int D>
__device__ __forceinline__ void tc_load_rows(float* sm, const float* g,
                                             int row0, int n, int rows) {
  constexpr int DP = D + 4, C = D / 4;
  for (int idx = threadIdx.x; idx < n * C; idx += kTcThreads) {
    const int r = idx / C, c = (idx % C) * 4;
    const int row = row0 + r;
    const bool ok = row < rows;
    cp_async16(sm + r * DP + c, g + static_cast<size_t>(ok ? row : 0) * D + c,
               ok);
  }
}

// A row's lse as the p step takes it: +inf where the row saw no key (lse ==
// -FLT_MAX), so that its p = exp(s - lse) is 0 with no test.
__device__ __forceinline__ float tc_live_lse(float l) {
  return l == VSIM_NEG_INF ? __int_as_float(0x7f800000) : l;
}

__device__ __forceinline__ float tc_row_lse(const float* lse, size_t rbase,
                                            int t, int T) {
  return t < T ? tc_live_lse(lse[rbase + t]) : __int_as_float(0x7f800000);
}

// p of one unmasked (query, key) pair: the scaled score plus ALiBi, then
// exp against the row's lse (as the FMA tiles and the plain version)
__device__ __forceinline__ float tc_prob(float s, float scale, float slope,
                                         int key, float l) {
  const float sc = s * scale + slope * static_cast<float>(key);
  return expf(sc - l);
}

// K7: one block per (b, h, 64-query tile).
template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dq_3xtf32_kernel(const float* __restrict__ q,     // [B, H, T, D]
                           const float* __restrict__ k,     // [B, H, S, D]
                           const float* __restrict__ v,     // [B, H, S, D]
                           const float* __restrict__ do_,   // [B, H, T, D]
                           const float* __restrict__ lse,   // [B, H, T]
                           const float* __restrict__ dsum,  // [B, H, T]
                           float* __restrict__ dq,          // [B, H, T, D]
                           const float* __restrict__ slopes,  // [H] or null
                           int H, int T, int S, int n_past, float scale) {
  constexpr int DP = D + 4;
  constexpr int BS = tc_bs(D);
  constexpr int KS = D / 8;   // k-steps over the head dim
  constexpr int NS = BS / 8;  // 8-key n-tiles of a score tile
  constexpr int ND = D / 8;   // 8-column n-tiles of dq
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                  // [64][DP]
  float* dos = qs + kTcRows * DP;  // [64][DP]
  float* ks = dos + kTcRows * DP;  // [2][BS][DP]
  float* vs = ks + 2 * BS * DP;    // [2][BS][DP]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;  // mma row group, lane in quad
  const int bh = blockIdx.y, h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcRows;  // longest first
  const float* qg = q + static_cast<size_t>(bh) * T * D;
  const float* dog = do_ + static_cast<size_t>(bh) * T * D;
  const float* kg = k + static_cast<size_t>(bh) * S * D;
  const float* vg = v + static_cast<size_t>(bh) * S * D;
  const size_t rbase = static_cast<size_t>(bh) * T;
  const float slope = slopes ? slopes[h] : 0.f;

  // keys any query of this tile can see
  const int last_t = min(q0 + kTcRows, T) - 1;
  const int n_keys = min(S, n_past + last_t + 1);
  const int n_tiles = n_keys > 0 ? (n_keys + BS - 1) / BS : 0;
  tc_load_rows<D>(qs, qg, q0, kTcRows, T);
  tc_load_rows<D>(dos, dog, q0, kTcRows, T);
  if (n_tiles > 0) {
    tc_load_rows<D>(ks, kg, 0, BS, S);
    tc_load_rows<D>(vs, vg, 0, BS, S);
  }
  cp_async_commit();

  // this thread's rows: t_lo (accumulator elements 0, 1) and t_hi (2, 3)
  const int r0 = warp * 16;
  const int t_lo = q0 + r0 + g, t_hi = t_lo + 8;
  const float lse_lo = tc_row_lse(lse, rbase, t_lo, T);
  const float lse_hi = tc_row_lse(lse, rbase, t_hi, T);
  const float dsum_lo = t_lo < T ? dsum[rbase + t_lo] : 0.f;
  const float dsum_hi = t_hi < T ? dsum[rbase + t_hi] : 0.f;
  const bool warp_live = q0 + r0 < T;
  const int warp_horizon = n_past + min(q0 + r0 + 15, T - 1);  // last key seen

  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles) {  // prefetch the next tile into the other stage
      tc_load_rows<D>(ks + (st ^ 1) * BS * DP, kg, (it + 1) * BS, BS, S);
      tc_load_rows<D>(vs + (st ^ 1) * BS * DP, vg, (it + 1) * BS, BS, S);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int s0 = it * BS;
    if (warp_live && s0 <= warp_horizon) {
      const float* kt = ks + st * BS * DP;
      const float* vt = vs + st * BS * DP;
      float sa[NS][4], pa[NS][4];  // S and dP
#pragma unroll
      for (int i = 0; i < NS; ++i)
        sa[i][0] = sa[i][1] = sa[i][2] = sa[i][3] = pa[i][0] = pa[i][1] =
            pa[i][2] = pa[i][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const float* qr = qs + (r0 + g) * DP + kk * 8 + t4;
        const float* orow = dos + (r0 + g) * DP + kk * 8 + t4;
        FragA3 qa, oa;
        qa.set(qr[0], qr[8 * DP], qr[4], qr[8 * DP + 4]);
        oa.set(orow[0], orow[8 * DP], orow[4], orow[8 * DP + 4]);
#pragma unroll
        for (int nt = 0; nt < NS; ++nt) {
          const int off = (nt * 8 + g) * DP + kk * 8 + t4;
          FragB3 kb, vb;
          kb.set(kt[off], kt[off + 4]);
          vb.set(vt[off], vt[off + 4]);
          mma_3xtf32(sa[nt], qa, kb);
          mma_3xtf32(pa[nt], oa, vb);
        }
      }
      // ds in place of S; keys s0 + 8 nt + 2 t4 + (e & 1).  The mask is
      // tested only where a row of the warp misses a key of the tile
      if (s0 + BS - 1 <= n_past + q0 + r0 && s0 + BS <= S) {
#pragma unroll
        for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int s = s0 + nt * 8 + 2 * t4 + (e & 1);
            const float p = tc_prob(sa[nt][e], scale, slope, s,
                                    e < 2 ? lse_lo : lse_hi);
            sa[nt][e] = p * (pa[nt][e] - (e < 2 ? dsum_lo : dsum_hi)) * scale;
          }
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int s = s0 + nt * 8 + 2 * t4 + (e & 1);
            const int t = e < 2 ? t_lo : t_hi;
            const float p = s < S && s <= n_past + t
                ? tc_prob(sa[nt][e], scale, slope, s, e < 2 ? lse_lo : lse_hi)
                : 0.f;
            sa[nt][e] = p * (pa[nt][e] - (e < 2 ? dsum_lo : dsum_hi)) * scale;
          }
        }
      }
      // dQ += dS K, 8 keys a k-step: k slot t4 is key 2 t4 and slot t4 + 4
      // key 2 t4 + 1, so the accumulator is the A fragment as it stands
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        FragA3 da;
        da.set(sa[j][0], sa[j][2], sa[j][1], sa[j][3]);
        const float* kr = kt + (j * 8 + 2 * t4) * DP + g;
#pragma unroll
        for (int dn = 0; dn < ND; ++dn) {
          FragB3 kb;
          kb.set(kr[dn * 8], kr[DP + dn * 8]);
          mma_3xtf32(acc[dn], da, kb);
        }
      }
    }
    __syncthreads();  // this stage is refilled by the next prefetch
  }
  cp_async_wait<0>();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = half ? t_hi : t_lo;
    if (t >= T) continue;
    float* row = dq + (rbase + t) * D;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
      *reinterpret_cast<float2*>(row + dn * 8 + 2 * t4) =
          make_float2(acc[dn][2 * half], acc[dn][2 * half + 1]);
  }
}

// K8: q, do, lse and dsum rows [q0, q0 + BQ) into one stage of the ring.
template <int D>
__device__ __forceinline__ void tc_load_query_tile(
    float* qs, float* dos, float* lse_s, float* dsum_s, const float* qg,
    const float* dog, const float* lse, const float* dsum, int q0, int T) {
  constexpr int BQ = kTcQueries;
  tc_load_rows<D>(qs, qg, q0, BQ, T);
  tc_load_rows<D>(dos, dog, q0, BQ, T);
  for (int i = threadIdx.x; i < BQ; i += kTcThreads) {
    const int t = q0 + i;
    const bool ok = t < T;  // past T: zeros, masked by t < T
    cp_async4(lse_s + i, lse + (ok ? t : 0), ok);
    cp_async4(dsum_s + i, dsum + (ok ? t : 0), ok);
  }
}

// K8: one block per (b, h, 64-key tile).
template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dkv_3xtf32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ do_,
                            const float* __restrict__ lse,
                            const float* __restrict__ dsum,
                            float* __restrict__ dk,  // [B, H, S, D]
                            float* __restrict__ dv,  // [B, H, S, D]
                            const float* __restrict__ slopes, int H, int T,
                            int S, int n_past, float scale) {
  constexpr int DP = D + 4;
  constexpr int BQ = kTcQueries;
  constexpr int KS = D / 8;   // k-steps over the head dim
  constexpr int NQ = BQ / 8;  // 8-query n-tiles of a score tile
  constexpr int ND = D / 8;   // 8-column n-tiles of dk and dv
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;                    // [64][DP]
  float* vs = ks + kTcRows * DP;     // [64][DP]
  float* qs = vs + kTcRows * DP;     // [2][BQ][DP]
  float* dos = qs + 2 * BQ * DP;     // [2][BQ][DP]
  float* lse_s = dos + 2 * BQ * DP;  // [2][BQ]
  float* dsum_s = lse_s + 2 * BQ;    // [2][BQ]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.y, h = bh % H;
  const int s0 = blockIdx.x * kTcRows;
  const float* qg = q + static_cast<size_t>(bh) * T * D;
  const float* dog = do_ + static_cast<size_t>(bh) * T * D;
  const float* lseg = lse + static_cast<size_t>(bh) * T;
  const float* dsumg = dsum + static_cast<size_t>(bh) * T;
  const size_t kvbase = static_cast<size_t>(bh) * S * D;
  const float slope = slopes ? slopes[h] : 0.f;

  // query t sees key s0 iff n_past + t >= s0: start at the tile of
  // t = s0 - n_past; tiles no query reaches leave the zeros
  const int first = s0 > n_past ? (s0 - n_past) / BQ : 0;
  const int n_qt = (T + BQ - 1) / BQ;
  tc_load_rows<D>(ks, k + kvbase, s0, kTcRows, S);
  tc_load_rows<D>(vs, v + kvbase, s0, kTcRows, S);
  if (first < n_qt)
    tc_load_query_tile<D>(qs, dos, lse_s, dsum_s, qg, dog, lseg, dsumg,
                          first * BQ, T);
  cp_async_commit();

  // this thread's keys: s_lo (accumulator elements 0, 1) and s_hi (2, 3)
  const int r0 = warp * 16;
  const int s_lo = s0 + r0 + g, s_hi = s_lo + 8;
  const bool warp_live = s0 + r0 < S;
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
    dka[i][0] = dka[i][1] = dka[i][2] = dka[i][3] = dva[i][0] = dva[i][1] =
        dva[i][2] = dva[i][3] = 0.f;

  for (int it = first; it < n_qt; ++it) {
    const int st = (it - first) & 1;
    if (it + 1 < n_qt)
      tc_load_query_tile<D>(qs + (st ^ 1) * BQ * DP, dos + (st ^ 1) * BQ * DP,
                            lse_s + (st ^ 1) * BQ, dsum_s + (st ^ 1) * BQ, qg,
                            dog, lseg, dsumg, (it + 1) * BQ, T);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int q0 = it * BQ;
    // the tile's last query sees keys up to n_past + that query
    if (warp_live && s0 + r0 <= n_past + min(q0 + BQ, T) - 1) {
      const float* qt = qs + st * BQ * DP;
      const float* ot = dos + st * BQ * DP;
      const float* lt = lse_s + st * BQ;
      const float* dt = dsum_s + st * BQ;
      float sa[NQ][4], pa[NQ][4];  // S^T and dP^T: rows keys, columns queries
#pragma unroll
      for (int i = 0; i < NQ; ++i)
        sa[i][0] = sa[i][1] = sa[i][2] = sa[i][3] = pa[i][0] = pa[i][1] =
            pa[i][2] = pa[i][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const float* kr = ks + (r0 + g) * DP + kk * 8 + t4;
        const float* vr = vs + (r0 + g) * DP + kk * 8 + t4;
        FragA3 ka, va;
        ka.set(kr[0], kr[8 * DP], kr[4], kr[8 * DP + 4]);
        va.set(vr[0], vr[8 * DP], vr[4], vr[8 * DP + 4]);
#pragma unroll
        for (int nt = 0; nt < NQ; ++nt) {
          const int off = (nt * 8 + g) * DP + kk * 8 + t4;
          FragB3 qb, ob;
          qb.set(qt[off], qt[off + 4]);
          ob.set(ot[off], ot[off + 4]);
          mma_3xtf32(sa[nt], ka, qb);
          mma_3xtf32(pa[nt], va, ob);
        }
      }
      // p in place of S^T, ds in place of dP^T; queries q0 + 8 nt + 2 t4 +
      // (e & 1).  The mask is tested only where a query of the tile misses
      // a key of the warp
      float l2[NQ][2];
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt) {
        const float2 l = *reinterpret_cast<const float2*>(lt + nt * 8 + 2 * t4);
        l2[nt][0] = tc_live_lse(l.x);
        l2[nt][1] = tc_live_lse(l.y);
      }
      if (s0 + r0 + 15 <= n_past + q0 && q0 + BQ <= T && s0 + r0 + 16 <= S) {
#pragma unroll
        for (int nt = 0; nt < NQ; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sa[nt][e] = tc_prob(sa[nt][e], scale, slope, e < 2 ? s_lo : s_hi,
                                l2[nt][e & 1]);
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < NQ; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int s = e < 2 ? s_lo : s_hi;
            const int t = q0 + nt * 8 + 2 * t4 + (e & 1);
            sa[nt][e] = t < T && s < S && s <= n_past + t
                ? tc_prob(sa[nt][e], scale, slope, s, l2[nt][e & 1]) : 0.f;
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt) {
        const float2 d2 = *reinterpret_cast<const float2*>(dt + nt * 8 + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pa[nt][e] = sa[nt][e] * (pa[nt][e] - ((e & 1) ? d2.y : d2.x)) * scale;
      }
      // dV += P^T dO and dK += dS^T Q, 8 queries a k-step: k slot t4 is
      // query 2 t4 and slot t4 + 4 query 2 t4 + 1 (as in K7)
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        FragA3 pf, df;
        pf.set(sa[j][0], sa[j][2], sa[j][1], sa[j][3]);
        df.set(pa[j][0], pa[j][2], pa[j][1], pa[j][3]);
        const float* orow = ot + (j * 8 + 2 * t4) * DP + g;
        const float* qr = qt + (j * 8 + 2 * t4) * DP + g;
#pragma unroll
        for (int dn = 0; dn < ND; ++dn) {
          FragB3 ob, qb;
          ob.set(orow[dn * 8], orow[DP + dn * 8]);
          qb.set(qr[dn * 8], qr[DP + dn * 8]);
          mma_3xtf32(dva[dn], pf, ob);
          mma_3xtf32(dka[dn], df, qb);
        }
      }
    }
    __syncthreads();  // this stage is refilled by the next prefetch
  }
  cp_async_wait<0>();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int s = half ? s_hi : s_lo;
    if (s >= S) continue;
    float* krow = dk + kvbase + static_cast<size_t>(s) * D;
    float* vrow = dv + kvbase + static_cast<size_t>(s) * D;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn) {
      const int col = dn * 8 + 2 * t4;
      *reinterpret_cast<float2*>(krow + col) =
          make_float2(dka[dn][2 * half], dka[dn][2 * half + 1]);
      *reinterpret_cast<float2*>(vrow + col) =
          make_float2(dva[dn][2 * half], dva[dn][2 * half + 1]);
    }
  }
}

size_t dq_smem_bytes(int D) {
  const size_t dp = D + 4;
  return sizeof(float) * (2 * kBQ * dp + 2 * kBS * dp + kBQ * kPS + 2 * kBQ);
}

size_t dkv_smem_bytes(int D) {
  const size_t dp = D + 4;
  return sizeof(float) * (2 * kBS * dp + 2 * kBQ * dp + 2 * kBQ * kPS + 2 * kBQ);
}

struct Args {
  const void *q, *k, *v, *do_;
  const float *lse, *dsum;
  void *out0, *out1;  // dq, or dk and dv
  const float* slopes;
  int B, H, T, S, D, n_past;
  float scale;
  cudaStream_t stream;
};

template <bool BF16, int NG>
int launch_dq(const Args& a) {
  auto kern = flash_bwd_dq_kernel<BF16, NG>;
  const size_t smem = dq_smem_bytes(a.D);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.T + kBQ - 1) / kBQ, a.B * a.H);
  kern<<<grid, kThreads, smem, a.stream>>>(a.q, a.k, a.v, a.do_, a.lse, a.dsum,
                                           a.out0, a.slopes, a.H, a.T, a.S,
                                           a.D, a.n_past, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool BF16, int NG>
int launch_dkv(const Args& a) {
  auto kern = flash_bwd_dkv_kernel<BF16, NG>;
  const size_t smem = dkv_smem_bytes(a.D);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + kBS - 1) / kBS, a.B * a.H);
  kern<<<grid, kThreads, smem, a.stream>>>(a.q, a.k, a.v, a.do_, a.lse, a.dsum,
                                           a.out0, a.out1, a.slopes, a.H, a.T,
                                           a.S, a.D, a.n_past, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq_3xtf32(const Args& a) {
  auto kern = flash_bwd_dq_3xtf32_kernel<D>;
  const size_t smem = sizeof(float) * (2 * kTcRows + 4 * tc_bs(D)) * (D + 4);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.T + kTcRows - 1) / kTcRows, a.B * a.H);
  kern<<<grid, kTcThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.do_), a.lse,
      a.dsum, static_cast<float*>(a.out0), a.slopes, a.H, a.T, a.S, a.n_past,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_3xtf32(const Args& a) {
  auto kern = flash_bwd_dkv_3xtf32_kernel<D>;
  constexpr int BQ = kTcQueries;
  const size_t smem =
      sizeof(float) * ((2 * kTcRows + 4 * BQ) * (D + 4) + 4 * BQ);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + kTcRows - 1) / kTcRows, a.B * a.H);
  kern<<<grid, kTcThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.do_), a.lse,
      a.dsum, static_cast<float*>(a.out0), static_cast<float*>(a.out1),
      a.slopes, a.H, a.T, a.S, a.n_past, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// The instance the caller picked: ``mma`` (f32 at D = 64 or 128 only) the
// tensor cores, else the FMA tiles, NG column groups of 32 covering D.  An
// instance that does not exist for (dtype, D) is an error, never a
// substitute.
template <bool DKV>
int dispatch(const Args& a, int is_bf16, int mma) {
  if (a.D % 4 != 0 || a.D > kMaxD || a.D <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mma) {
    if (is_bf16 || (a.D != 64 && a.D != 128))
      return static_cast<int>(cudaErrorInvalidValue);
    if (DKV) return a.D == 64 ? launch_dkv_3xtf32<64>(a) : launch_dkv_3xtf32<128>(a);
    return a.D == 64 ? launch_dq_3xtf32<64>(a) : launch_dq_3xtf32<128>(a);
  }
  const int ng = a.D <= 64 ? 2 : a.D <= 128 ? 4 : 8;
  if (DKV) {
    if (ng == 2) return is_bf16 ? launch_dkv<true, 2>(a) : launch_dkv<false, 2>(a);
    if (ng == 4) return is_bf16 ? launch_dkv<true, 4>(a) : launch_dkv<false, 4>(a);
    return is_bf16 ? launch_dkv<true, 8>(a) : launch_dkv<false, 8>(a);
  }
  if (ng == 2) return is_bf16 ? launch_dq<true, 2>(a) : launch_dq<false, 2>(a);
  if (ng == 4) return is_bf16 ? launch_dq<true, 4>(a) : launch_dq<false, 4>(a);
  return is_bf16 ? launch_dq<true, 8>(a) : launch_dq<false, 8>(a);
}

}  // namespace

extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* do_,
    const void* lse, const void* dsum, void* dq, const void* slopes,
    int is_bf16, int mma, int B, int H, int T, int S, int D, int n_past,
    float scale, void* stream) {
  const Args a{q, k, v, do_, static_cast<const float*>(lse),
               static_cast<const float*>(dsum), dq, nullptr,
               static_cast<const float*>(slopes), B, H, T, S, D, n_past, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, is_bf16, mma);
}

extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* do_,
    const void* lse, const void* dsum, void* dk, void* dv, const void* slopes,
    int is_bf16, int mma, int B, int H, int T, int S, int D, int n_past,
    float scale, void* stream) {
  const Args a{q, k, v, do_, static_cast<const float*>(lse),
               static_cast<const float*>(dsum), dk, dv,
               static_cast<const float*>(slopes), B, H, T, S, D, n_past, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, is_bf16, mma);
}
