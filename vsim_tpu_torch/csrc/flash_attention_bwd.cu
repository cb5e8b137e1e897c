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
// per visible (query, key) pair).  Three instances, picked by the caller
// (ops/attention.py:flash_attention_bwd_route):
//
// "mma_3xtf32", f32 at every head dim (D % 4 == 0 up to 256), on the
// tensor cores: each f32 product is three mma.sync m16n8k8 TF32 products of
// the operands split into big + small TF32 halves (common.cuh).  Emulated
// on the CPU with exact sums (tests/test_torch_flash_bwd.py) that keeps the
// gradients within ~1e-6 of max|plain|, where one TF32 product per f32
// product misses by ~1e-3; on the card, whose MMAs sum in their own f32
// order, dk and dv come within ~3e-5 at T = 2048 and D = 64, ~4e-6 at D =
// 80, 96 and 256 (chip_smoke.py phase 2).  D = 64 and 128
// have kernels of their own: a block of 4 warps holds 64 rows resident (K7:
// queries, q and do; K8: keys, k and v), 16 rows a warp, and streams the
// other side's tiles through a two-stage ring of 16-byte cp.async copies
// (K7: 32 keys of k and v at D = 64, 64 at D = 128; K8: 32 queries of q,
// do, lse and dsum).  Each warp computes its 16 rows' scores and dp against
// the tile (K7: S = Q K^T and dP = dO V^T; K8: S^T = K Q^T and dP^T = V
// dO^T, so K8's rows are keys and no transpose is needed), p and ds in the
// accumulator registers, and then its gradient rows (K7: dQ += dS K; K8: dV
// += P^T dO, dK += dS^T Q) with the accumulators in registers for the whole
// walk.  The m16n8k8 accumulator holds columns 2t, 2t+1 of a row where the
// A operand wants columns t, t+4; the second product relabels its k index
// (k slot t is column 2t, slot t+4 column 2t+1) and reads the B rows 2t,
// 2t+1 to match, so p and ds go from accumulator to A operand in registers,
// with no shared-memory staging or shuffles.  Shared rows are f32 padded to
// D + 4 floats: both fragment patterns (row g col t; row 2t col g) hit 32
// distinct banks.  Operands are split as each fragment is loaded (an
// integer add and mask, and an f32 subtract).  What holds it back on the
// H100 is latency, not a pipe: the MMAs and the split arithmetic do not
// overlap, and more warps an SM are what helped most (32-row streamed
// tiles at D = 64 fit three blocks an SM), so the tiles are sized for
// occupancy.  K7 schedules its longest causal walks first; K8's block 0 has
// the longest walk already.  A warp skips a tile none of its rows sees, and
// tests the causal mask only on tiles that cross the diagonal.
//
// Every other D runs the padded instances (flash_bwd_{dq,dkv}_3xtf32_pad_
// kernel, one body), the head dim zero-padded in shared memory to the next
// of 64, 80, 96, 128 or 256 (the padding changes no product and is never
// stored), in the same fragments, relabelling and row padding (D + 4 floats:
// 32 distinct banks for every padded D).  tf_plan gives each (D, pass) its
// geometry: rt row tiles of 16 resident rows, cs warps a row tile, streamed
// tiles of ``tile`` rows, and __launch_bounds__'s block count.  With cs > 1
// the warps of a row tile split the streamed rows for s and dp, stage ds
// (K8: p and ds) in shared memory as f32 (rows padded by 8 floats, so the
// 8-byte stores and loads are free of bank conflicts), and after a barrier
// each accumulates its share of the gradient columns over every row of the
// tile.  With ks (D = 256) they split the head dim instead: each warp's
// slice of s and dp over every streamed row (its A fragment split once, not
// once a warp), the slices added in slice order through a buffer that the
// staged tiles reuse.  The sums: s and dp a fresh fragment a 128 dims (a
// slice), the gradients a fresh fragment a group of 32 streamed rows, each
// added in f32, so the tensor cores' sums (no guard bits) stay short.  A
// warp's 16 rows of dq, dk or dv are D/2 f32 registers a thread (128 at D
// = 256, and K8 holds two): at D = 256 K8 takes 32 keys and four warps a
// row tile, K7 32 queries likewise.  Shared memory decides the blocks an SM:
// at D = 256 the resident rows and two stages of the streamed ones leave
// room for one block.  tf_plan's geometries (tools/bwd_plans.py --f32 on an
// NVIDIA H100 80GB HBM3 at a 700 W power limit: the fastest candidate with
// no spills; ptxas registers a thread, blocks an SM by registers and shared
// memory):
//   K7 D=80: 4 warps, 64 queries, 32-key tiles, 161 registers, 2 blocks;
//      D=96: 8 warps (cs 2), 32-key tiles, 127 registers, 2 blocks;
//      D=256: 8 warps, 32 queries (cs 4, ks), 32-key tiles, 192
//      registers, 1 block; padded 64 / 128: 4 warps, 32 / 64-key tiles,
//      156 / 255 registers, 3 / 1 blocks.
//   K8 D=80: 8 warps (cs 2), 64 keys, 32-query tiles, 128 registers, 2
//      blocks; D=96: 4 warps, 16-query tiles, 237 registers, 2 blocks;
//      D=256: 8 warps, 32 keys (cs 4, ks), 32-query tiles, 243 registers,
//      1 block; padded 64 / 128: 4 warps, 32-query tiles, 204 / 255
//      registers, 2 / 1 blocks.
// Splitting the head dim (ks) ran K7 and K8 at D = 256 1.14x and 1.09x
// faster than splitting the streamed rows; at D = 80 and 96 (cs 2) it
// spilled and ran slower.  Score sums in independent chains of k-steps
// moved nothing, and more warps an SM (D = 256: 8 warps against 4) helped
// most, as at D = 64.
//
// "mma_bf16", bf16 at D % 16 == 0 up to 256 (every preset's head dim: 64,
// 80, 96, 128, 256), on the tensor cores as mma.sync m16n8k16 bf16 -> f32,
// in the geometry of K4's bf16 instance and of "mma_3xtf32": resident rows
// loaded once (K7: q and do; K8: k and v), 16 a warp, and the other side
// streamed through a two-stage ring of 16-byte cp.async copies; fragments
// come from shared memory by ldmatrix (.trans for the gradient products'
// B), rows padded by 16 bytes so that ldmatrix is free of bank conflicts,
// head dims zero-padded in shared memory to 64, 80, 96, 128 or 256 (the
// padding changes no product and is never stored).  s = q.k and dp = do.v
// are one product each (bf16 operands, exact).  p and ds are f32, unrounded
// in the function, so each is split into bf16 hi = bf16(x) and lo = bf16(x -
// hi), and dv = p^T.do, dq = ds.k, dk = ds^T.q are two products each (lo,
// then hi) into a fresh f32 fragment a streamed tile, added to the
// accumulator in f32: the tensor cores' sums (no guard bits) span one tile,
// the walk's sum is rounded to nearest as the plain version's.  Emulated on
// the CPU with exact sums (tests/test_torch_flash_bwd.py) the split keeps
// dq, dk and dv within 5e-6 of max|plain| before the store and leaves
// 0.2-0.6% of the bf16 outputs one rounding from the plain version's, where
// hi alone (p and ds rounded to bf16, as FlashAttention-2 does) moves ~40%
// of them.  The m16n8 accumulators of two adjacent n-tiles are the A
// fragment of the next m16n8k16 product, so p and ds go from the score
// products to the gradient products in registers as hi/lo bf16x2 pairs.
// A warp's 16 rows of dk and dv in f32 take D/2 registers a thread, 128 at
// D = 128 and 256 at D = 256, where dq takes D/4: K8 at every D but 80
// (bf_plan's cs = 2 or 4) gives each row tile two or four warps that split
// the streamed queries for s and dp, stage their hi/lo p and ds in shared
// memory (rows keys, columns queries, padded by 16 bytes) and, after a
// barrier, each accumulate a half or a quarter of dk's and dv's columns
// over every query of the tile: no product is computed twice.  Recomputing
// s and dp in each warp of a row tile instead ran K8 at D = 128 and 256
// 1.6x and 1.5x slower than one warp a row tile spilling registers; the
// staged layout matches that at D = 128 with no spills and beats it by
// 1.3x at D = 256 (tools/bwd_plans.py on an NVIDIA H100 80GB HBM3 at a
// 700 W power limit; PERF.md).  bf_plan's geometries, picked by those
// measurements (ptxas: registers a thread, no spills; blocks an SM by
// registers and shared memory):
//   K7 D=64: 4 warps, 64 queries, 64-key tiles, 168 registers, 3 blocks;
//      D=80 and 96: 32-key tiles, 153 and 159 registers, 3 blocks;
//      D=128: 64-key tiles, 240 registers, 2 blocks;
//      D=256: 16-key tiles, 255 registers, 2 blocks.
//   K8 D=64: 8 warps (cs 2), 64 keys, 64-query tiles, 126 registers, 2
//      blocks; D=80: 4 warps, 32-query tiles, 244 registers, 2 blocks;
//      D=96 and 128: 8 warps (cs 2), 64-query tiles, 183 and 225
//      registers, 1 block; D=256: 8 warps, 32 keys (cs 4), 64-query tiles,
//      221 registers, 1 block.
//
// "fma", bf16 at D % 16 != 0, on the FMA units from shared memory (its f32
// instantiations are gone: f32 takes "mma_3xtf32" at every D, and the
// launcher refuses f32 here): 256 threads, 32-row query tiles and 32-key
// tiles, rows padded to D + 4 floats so each lane reads its own key row as
// float4 without bank conflicts.  In the score pass a warp takes 4 query
// rows and a lane one key, and both dot products (q.k, do.v) share each
// float4 of k and v.  In the accumulation pass a thread owns one row (K7: a
// query row of dq; K8: a key row of dk and dv) and D/8 of its columns in
// registers.
//
// Every K7 walks the key tiles up to the query tile's causal horizon; every
// K8 walks the query tiles from the first one that sees its key tile, and
// writes zeros for key rows no query sees.

#include "common.cuh"

namespace {

constexpr int kBQ = 32;        // query rows per tile
constexpr int kBS = 32;        // keys per tile (one per lane in the score pass)
constexpr int kThreads = 256;  // 8 warps
constexpr int kRowsPerWarp = kBQ / (kThreads / 32);  // 4
constexpr int kPS = kBS + 1;   // padded row of the p / ds tiles
constexpr int kMaxD = 256;

// four bf16 elements [i, i + 4) of p, widened to f32
__device__ __forceinline__ float4 load4(const void* p, size_t i) {
  const uint2 u =
      *reinterpret_cast<const uint2*>(static_cast<const uint16_t*>(p) + i);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xFFFF0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xFFFF0000u));
}

// v rounded to bf16 into elements [i, i + 4) of p
__device__ __forceinline__ void store4(void* p, size_t i, float4 v) {
  uint2 u;
  u.x = static_cast<uint32_t>(float_to_bf16_bits(v.x)) |
        (static_cast<uint32_t>(float_to_bf16_bits(v.y)) << 16);
  u.y = static_cast<uint32_t>(float_to_bf16_bits(v.z)) |
        (static_cast<uint32_t>(float_to_bf16_bits(v.w)) << 16);
  *reinterpret_cast<uint2*>(static_cast<uint16_t*>(p) + i) = u;
}

// rows [row0, row0 + n) of one head's [rows, D] bf16 matrix at element
// ``base`` into sm[n][DP] as f32; rows past ``rows`` read as zeros.
__device__ __forceinline__ void load_tile(float* sm, const void* g,
                                          size_t base, int row0, int n,
                                          int rows, int D, int DP) {
  const int d4 = D / 4;
  for (int idx = threadIdx.x; idx < n * d4; idx += kThreads) {
    const int r = idx / d4, d = (idx % d4) * 4;
    const int row = row0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < rows) val = load4(g, base + static_cast<size_t>(row) * D + d);
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
template <int NG>
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

  load_tile(qs, q, qbase, q0, kBQ, T, D, DP);
  load_tile(dos, do_, qbase, q0, kBQ, T, D, DP);
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
    load_tile(ks, k, kvbase, s0, kBS, S, D, DP);
    load_tile(vs, v, kvbase, s0, kBS, S, D, DP);
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
      store4(dq, obase + col,
                   make_float4(acc[4 * gi], acc[4 * gi + 1], acc[4 * gi + 2],
                               acc[4 * gi + 3]));
  }
}

// K8: one block per (b, h, 32-key tile).
template <int NG>
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

  load_tile(ks, k, kvbase, s0, kBS, S, D, DP);
  load_tile(vs, v, kvbase, s0, kBS, S, D, DP);

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
    load_tile(qs, q, qbase, q0, kBQ, T, D, DP);
    load_tile(dos, do_, qbase, q0, kBQ, T, D, DP);
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
      store4(dk, obase + col,
                   make_float4(dka[4 * gi], dka[4 * gi + 1], dka[4 * gi + 2],
                               dka[4 * gi + 3]));
      store4(dv, obase + col,
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

// ---------------------------------------------------------------------------
// "mma_3xtf32" at the other head dims: D zero-padded in shared memory
// ---------------------------------------------------------------------------

// Each padded instance's geometry by the padded head dim, as bf_plan's: rt
// row tiles of 16 resident rows (K7 queries, K8 keys); cs warps a row tile
// (with cs > 1 they split the streamed tile's rows for s and dp -- with ks,
// the head dim instead, and then add their slices through shared memory --
// stage ds (K8: p and ds) in shared memory as f32, and after a barrier each
// takes its share of the gradient columns over every row of the tile);
// streamed tiles of ``tile`` rows (K7 keys, K8 queries); and the blocks an
// SM the register budget is set for (__launch_bounds__).  Picked by
// measurement (tools/bwd_plans.py --f32; see the header).
struct TfPlan {
  int rt, cs, tile, min_blocks, ks;
};
__host__ __device__ constexpr TfPlan tf_plan(int dpad, bool dkv) {
  return dkv ? (dpad <= 64   ? TfPlan{4, 1, 32, 2, 0}
                : dpad <= 80 ? TfPlan{4, 2, 32, 2, 0}
                : dpad <= 96 ? TfPlan{4, 1, 16, 2, 0}
                : dpad <= 128 ? TfPlan{4, 1, 32, 1, 0}
                              : TfPlan{2, 4, 32, 1, 1})
             : (dpad <= 64   ? TfPlan{4, 1, 32, 3, 0}
                : dpad <= 80 ? TfPlan{4, 1, 32, 2, 0}
                : dpad <= 96 ? TfPlan{4, 2, 32, 2, 0}
                : dpad <= 128 ? TfPlan{4, 1, 64, 1, 0}
                              : TfPlan{2, 4, 32, 1, 1});
}
__host__ __device__ constexpr int tf_threads(int dpad, bool dkv) {
  return 32 * tf_plan(dpad, dkv).rt * tf_plan(dpad, dkv).cs;
}
// resident rows a and b, two stages of streamed rows a and b, rows padded
// to dpad + 4 floats; K8 two stages of lse and dsum; with cs > 1 the staged
// ds (K8: p and ds), rows padded to tile + 8 floats, and with ks the slice
// buffer in the same place, whichever is larger
__host__ __device__ constexpr size_t tf_smem_bytes(int dpad, bool dkv) {
  const TfPlan P = tf_plan(dpad, dkv);
  const int staged = P.cs == 1 ? 0 : dkv ? 2 : 1;  // [16 rt][tile + 8] each
  const int slices = P.ks ? 2 * (P.cs - 1) : 0;
  return sizeof(float) *
         ((32 * P.rt + 4 * P.tile) * static_cast<size_t>(dpad + 4) +
          (dkv ? 4 * P.tile : 0) +
          (staged > slices ? staged : slices) * 16 * P.rt *
              static_cast<size_t>(P.tile + 8));
}

// Rows [row0, row0 + n) of one head's [rows, D] f32 matrix into sm[n][DP]
// by 16-byte cp.async (D % 4 == 0); rows past ``rows`` read as zeros.
template <int DP, int NTHR>
__device__ __forceinline__ void tf_load_rows(float* sm, const float* g,
                                             int row0, int n, int rows,
                                             int D) {
  const int c4 = D / 4;
  for (int idx = threadIdx.x; idx < n * c4; idx += NTHR) {
    const int r = idx / c4, c = (idx % c4) * 4;
    const int row = row0 + r;
    const bool ok = row < rows;
    cp_async16(sm + r * DP + c, g + static_cast<size_t>(ok ? row : 0) * D + c,
               ok);
  }
}

// Zero columns [D, DPAD) of n shared rows: no load touches them, and they
// change no product
template <int DPAD, int NTHR>
__device__ __forceinline__ void tf_zero_pad(float* sm, int n, int D) {
  constexpr int DP = DPAD + 4;
  if (DPAD == D) return;
  const int np = DPAD - D;
  for (int idx = threadIdx.x; idx < n * np; idx += NTHR)
    sm[(idx / np) * DP + D + idx % np] = 0.f;
}

// k-step kk of one warp's score products: sa += A B^T, pa += A2 B2^T, a
// and a2 at row g, column t4 of its 16 resident rows, b and b2 at row g,
// column t4 of the NT * 8 streamed rows
template <int NT, int DP>
__device__ __forceinline__ void tf_score_step(float (&sa)[NT][4],
                                              float (&pa)[NT][4],
                                              const float* a, const float* a2,
                                              const float* b, const float* b2,
                                              int kk) {
  const float* ar = a + kk * 8;
  const float* ar2 = a2 + kk * 8;
  FragA3 qa, oa;
  qa.set(ar[0], ar[8 * DP], ar[4], ar[8 * DP + 4]);
  oa.set(ar2[0], ar2[8 * DP], ar2[4], ar2[8 * DP + 4]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int off = nt * 8 * DP + kk * 8;
    FragB3 kb, vb;
    kb.set(b[off], b[off + 4]);
    vb.set(b2[off], b2[off + 4]);
    mma_3xtf32(sa[nt], qa, kb);
    mma_3xtf32(pa[nt], oa, vb);
  }
}

// One warp's s and dp over KS k-steps of the padded head dim (a, a2, b, b2
// at the first): a fresh fragment a 128 dims, added in f32, so that the
// tensor cores' own sums span at most 16 k-steps
template <int KS, int NT, int DP>
__device__ __forceinline__ void tf_scores(float (&sa)[NT][4],
                                          float (&pa)[NT][4], const float* a,
                                          const float* a2, const float* b,
                                          const float* b2) {
  constexpr int KC = KS < 16 ? KS : 16;
  static_assert(KS % KC == 0, "whole 128-dim parts");
#pragma unroll
  for (int i = 0; i < NT; ++i)
    sa[i][0] = sa[i][1] = sa[i][2] = sa[i][3] = pa[i][0] = pa[i][1] =
        pa[i][2] = pa[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KC; ++kk)
    tf_score_step<NT, DP>(sa, pa, a, a2, b, b2, kk);
#pragma unroll
  for (int c = KC; c < KS; c += KC) {
    float ta[NT][4], tp[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
      ta[i][0] = ta[i][1] = ta[i][2] = ta[i][3] = tp[i][0] = tp[i][1] =
          tp[i][2] = tp[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KC; ++kk)
      tf_score_step<NT, DP>(ta, tp, a, a2, b, b2, c + kk);
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sa[i][e] += ta[i][e];
        pa[i][e] += tp[i][e];
      }
  }
}

// acc += X Bt over NG k-steps of 8 streamed rows: X one warp's 16 rows as
// A fragments (k slot t4 is streamed row 2 t4 and slot t4 + 4 row 2 t4 + 1,
// so the m16n8 accumulator is the fragment as it stands), bt at streamed row
// 2 t4 of the first k-step and the warp's column g.  Each n-tile's products
// go into a fresh fragment, added to acc in f32: the tensor cores' own sums
// span NG k-steps.
template <int NG, int ND, int DP>
__device__ __forceinline__ void tf_grad(float (&acc)[ND][4],
                                        const FragA3 (&xa)[NG],
                                        const float* bt) {
#pragma unroll
  for (int dn = 0; dn < ND; ++dn) {
    float f[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const float* r = bt + j * 8 * DP + dn * 8;
      FragB3 b;
      b.set(r[0], r[DP]);
      mma_3xtf32(f, xa[j], b);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] += f[e];
  }
}

// acc += X Bt over the KT k-steps of a streamed tile, X in registers as
// m16n8 accumulators x[KT][4] (one per 8 streamed rows), 4 k-steps (32
// rows) a group
template <int KT, int ND, int DP>
__device__ __forceinline__ void tf_grad_regs(float (&acc)[ND][4],
                                             const float (&x)[KT][4],
                                             const float* bt) {
  constexpr int G = KT < 4 ? KT : 4;
  static_assert(KT % G == 0, "whole groups");
#pragma unroll
  for (int j0 = 0; j0 < KT; j0 += G) {
    FragA3 xa[G];
#pragma unroll
    for (int j = 0; j < G; ++j)
      xa[j].set(x[j0 + j][0], x[j0 + j][2], x[j0 + j][1], x[j0 + j][3]);
    tf_grad<G, ND, DP>(acc, xa, bt + j0 * 8 * DP);
  }
}

// The same with X staged in shared memory (row g of the warp's 16 at xs,
// row pitch PS, streamed rows as columns)
template <int KT, int ND, int DP, int PS>
__device__ __forceinline__ void tf_grad_staged(float (&acc)[ND][4],
                                               const float* xs,
                                               const float* bt, int t4) {
  constexpr int G = KT < 4 ? KT : 4;
  static_assert(KT % G == 0, "whole groups");
#pragma unroll
  for (int j0 = 0; j0 < KT; j0 += G) {
    FragA3 xa[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const float2 x0 =
          *reinterpret_cast<const float2*>(xs + (j0 + j) * 8 + 2 * t4);
      const float2 x1 =
          *reinterpret_cast<const float2*>(xs + 8 * PS + (j0 + j) * 8 + 2 * t4);
      xa[j].set(x0.x, x1.x, x0.y, x1.y);
    }
    tf_grad<G, ND, DP>(acc, xa, bt + j0 * 8 * DP);
  }
}

// The block of K7 (DKV false) or K8 (DKV true) at padded head dim DPAD: a
// block per (b, h, 16 * rt resident rows), warps by tf_plan.  Resident: K7
// queries (q, do; longest causal walk first), K8 keys (k, v).  Streamed: K7
// keys (k, v) up to the block's causal horizon, K8 queries (q, do, lse,
// dsum) from the first that sees the block's keys.
template <int DPAD, bool DKV>
__device__ __forceinline__ void tf_pad_block(
    const float* __restrict__ q,     // [B, H, T, D]
    const float* __restrict__ k,     // [B, H, S, D]
    const float* __restrict__ v,     // [B, H, S, D]
    const float* __restrict__ do_,   // [B, H, T, D]
    const float* __restrict__ lse,   // [B, H, T]
    const float* __restrict__ dsum,  // [B, H, T]
    float* __restrict__ out0,        // K7 dq; K8 dk
    float* __restrict__ out1,        // K8 dv
    const float* __restrict__ slopes,  // [H] or null
    int H, int T, int S, int D, int n_past, float scale) {
  constexpr TfPlan P = tf_plan(DPAD, DKV);
  constexpr int NTHR = tf_threads(DPAD, DKV);
  constexpr int R = 16 * P.rt;      // resident rows
  constexpr int BS = P.tile;        // streamed rows a tile
  constexpr int W = BS / P.cs;      // streamed rows of a warp's s and dp
  constexpr int DP = DPAD + 4;      // shared row: 32 distinct banks
  constexpr int PS = BS + 8;        // staged row
  constexpr int KS = DPAD / 8;      // k-steps of the score products
  constexpr int NS = W / 8;         // 8-row n-tiles of a warp's score tile
  constexpr int KT = BS / 8;        // k-steps of the gradient products
  constexpr int DH = DPAD / P.cs;   // a warp's gradient columns
  constexpr int ND = DH / 8;
  static_assert(W % 8 == 0 && DH % 8 == 0, "whole 8-wide fragments");
  static_assert(!P.ks || (P.cs > 1 && KS % P.cs == 0),
                "ks: the cs warps of a row tile split the head dim");
  extern __shared__ __align__(16) float sm[];
  float* ra = sm;                // [R][DP] K7 q, K8 k
  float* rb = ra + R * DP;       // [R][DP] K7 do, K8 v
  float* sa_ = rb + R * DP;      // [2][BS][DP] K7 k, K8 q
  float* sb_ = sa_ + 2 * BS * DP;  // [2][BS][DP] K7 v, K8 do
  float* lse_s = sb_ + 2 * BS * DP;  // K8: [2][BS]
  float* dsum_s = lse_s + 2 * BS;    // K8: [2][BS]
  // cs > 1: the staged ds [R][PS] (K8: p and ds); with ks first the slice
  // buffer, s then dp, each [cs - 1][R][PS]: slot (c < w ? c : c - 1) of
  // share w's rows holds warp c's slice
  float* stg = DKV ? dsum_s + 2 * BS : lse_s;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;  // mma row group, lane in quad
  const int r0 = (warp % P.rt) * 16;
  const int cw = warp / P.rt;    // this warp's share of its row tile:
  const int wc = cw * W;         // its streamed rows (ks: its slice of the
  const int col0 = cw * DH;      // head dim first) and gradient columns
  const int bh = blockIdx.y, h = bh % H;
  const int n_res = DKV ? S : T, n_str = DKV ? T : S;
  const int row0 = (DKV ? blockIdx.x : gridDim.x - 1 - blockIdx.x) * R;
  const size_t qbase = static_cast<size_t>(bh) * T * D;
  const size_t kvbase = static_cast<size_t>(bh) * S * D;
  const float* res_a = DKV ? k + kvbase : q + qbase;
  const float* res_b = DKV ? v + kvbase : do_ + qbase;
  const float* str_a = DKV ? q + qbase : k + kvbase;
  const float* str_b = DKV ? do_ + qbase : v + kvbase;
  const size_t rbase = static_cast<size_t>(bh) * T;
  const float slope = slopes ? slopes[h] : 0.f;

  // K7 walks the keys any query of the block sees; K8 the query tiles from
  // that of t = row0 - n_past (a key row0 sees no earlier query), and tiles
  // no query reaches leave the zeros
  int first = 0, n_it;
  if constexpr (DKV) {
    first = row0 > n_past ? (row0 - n_past) / BS : 0;
    n_it = (T + BS - 1) / BS;
  } else {
    const int n_keys = min(S, n_past + min(row0 + R, T));
    n_it = n_keys > 0 ? (n_keys + BS - 1) / BS : 0;
  }
  // stream tile it's rows into stage st
  auto load_tile = [&](int st, int it) {
    const int i0 = it * BS;
    tf_load_rows<DP, NTHR>(sa_ + st * BS * DP, str_a, i0, BS, n_str, D);
    tf_load_rows<DP, NTHR>(sb_ + st * BS * DP, str_b, i0, BS, n_str, D);
    if constexpr (DKV) {
      for (int i = threadIdx.x; i < BS; i += NTHR) {
        const int t = i0 + i;
        const bool ok = t < T;  // past T: zeros, masked by t < T
        cp_async4(lse_s + st * BS + i, lse + rbase + (ok ? t : 0), ok);
        cp_async4(dsum_s + st * BS + i, dsum + rbase + (ok ? t : 0), ok);
      }
    }
  };
  tf_zero_pad<DPAD, NTHR>(sm, 2 * R + 4 * BS, D);
  tf_load_rows<DP, NTHR>(ra, res_a, row0, R, n_res, D);
  tf_load_rows<DP, NTHR>(rb, res_b, row0, R, n_res, D);
  if (first < n_it) load_tile(0, first);
  cp_async_commit();

  // this thread's resident rows: lo (accumulator elements 0, 1), hi (2, 3)
  const int lo = row0 + r0 + g, hi = lo + 8;
  const bool warp_live = row0 + r0 < n_res;
  float lse_lo = 0.f, lse_hi = 0.f, dsum_lo = 0.f, dsum_hi = 0.f;
  if constexpr (!DKV) {
    lse_lo = tc_row_lse(lse, rbase, lo, T);
    lse_hi = tc_row_lse(lse, rbase, hi, T);
    dsum_lo = lo < T ? dsum[rbase + lo] : 0.f;
    dsum_hi = hi < T ? dsum[rbase + hi] : 0.f;
  }
  const int horizon = n_past + min(row0 + r0 + 15, T - 1);  // K7: last key
  // K7: dq; K8: dk (acc) and dv (acc2)
  float acc[ND][4], acc2[DKV ? ND : 1][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
  for (int i = 0; i < (DKV ? ND : 1); ++i)
    acc2[i][0] = acc2[i][1] = acc2[i][2] = acc2[i][3] = 0.f;

  for (int it = first; it < n_it; ++it) {
    const int st = (it - first) & 1;
    if (it + 1 < n_it) load_tile(st ^ 1, it + 1);  // prefetch
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int i0 = it * BS;
    const float* ta = sa_ + st * BS * DP;
    const float* tb = sb_ + st * BS * DP;
    // K7: a key of the tile is within the row tile's horizon; K8: the
    // tile's last query sees the row tile's first key.  The same for every
    // warp of a row tile
    const bool live = warp_live && (DKV ? row0 + r0 <= n_past + min(i0 + BS, T) - 1
                                        : i0 <= horizon);
    float sa[NS][4], pa[NS][4];  // S and dP (K8: S^T and dP^T)
    float fs[P.ks ? KT : 1][4], fp[P.ks ? KT : 1][4];  // ks: a slice's
    if (live) {
      if constexpr (P.ks) {
        // s and dp over this warp's slice of the head dim, every streamed
        // row; the other warps' shares of the rows into the slice buffer
        const int k0 = cw * (KS / P.cs) * 8;
        tf_scores<KS / P.cs, KT, DP>(
            fs, fp, ra + (r0 + g) * DP + t4 + k0, rb + (r0 + g) * DP + t4 + k0,
            ta + g * DP + t4 + k0, tb + g * DP + t4 + k0);
#pragma unroll
        for (int nt = 0; nt < KT; ++nt) {
          const int w = nt / NS;  // the share these rows belong to
          if (w == cw) continue;
          const int slot = cw < w ? cw : cw - 1;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int at =
                (slot * R + r0 + g + 8 * half) * PS + nt * 8 + 2 * t4;
            *reinterpret_cast<float2*>(stg + at) =
                make_float2(fs[nt][2 * half], fs[nt][2 * half + 1]);
            *reinterpret_cast<float2*>(stg + (P.cs - 1) * R * PS + at) =
                make_float2(fp[nt][2 * half], fp[nt][2 * half + 1]);
          }
        }
      } else {
        tf_scores<KS, NS, DP>(
            sa, pa, ra + (r0 + g) * DP + t4, rb + (r0 + g) * DP + t4,
            ta + (wc + g) * DP + t4, tb + (wc + g) * DP + t4);
      }
    }
    if constexpr (P.ks) {
      __syncthreads();  // the slices are in the buffer
      if (live) {
        // this warp's share: the slices added in slice order
#pragma unroll
        for (int n = 0; n < NS; ++n) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float2 xs, xp;
#pragma unroll
            for (int c = 0; c < P.cs; ++c) {
              float2 ys, yp;
              if (c == cw) {
#pragma unroll
                for (int i = 0; i < P.cs; ++i)  // fs[cw * NS + n], unrolled
                  if (i == cw) {
                    ys = make_float2(fs[i * NS + n][2 * half],
                                     fs[i * NS + n][2 * half + 1]);
                    yp = make_float2(fp[i * NS + n][2 * half],
                                     fp[i * NS + n][2 * half + 1]);
                  }
              } else {
                const int at = ((c < cw ? c : c - 1) * R + r0 + g + 8 * half) *
                                   PS + wc + n * 8 + 2 * t4;
                ys = *reinterpret_cast<const float2*>(stg + at);
                yp = *reinterpret_cast<const float2*>(stg + (P.cs - 1) * R * PS +
                                                      at);
              }
              if (c == 0) {
                xs = ys;
                xp = yp;
              } else {
                xs.x += ys.x;
                xs.y += ys.y;
                xp.x += yp.x;
                xp.y += yp.y;
              }
            }
            sa[n][2 * half] = xs.x;
            sa[n][2 * half + 1] = xs.y;
            pa[n][2 * half] = xp.x;
            pa[n][2 * half + 1] = xp.y;
          }
        }
      }
      __syncthreads();  // the buffer is read: the staged tiles go there
    }
    if (live) {
      // p (K8) and ds in place; streamed rows w0 + 8 nt + 2 t4 + (e & 1).
      // The mask is tested only where a resident row misses a streamed one
      const int w0 = i0 + wc;
      if constexpr (!DKV) {
        const bool full = w0 + W - 1 <= n_past + row0 + r0 && w0 + W <= S;
#pragma unroll
        for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int s = w0 + nt * 8 + 2 * t4 + (e & 1);
            const int t = e < 2 ? lo : hi;
            const float p = full || (s < S && s <= n_past + t)
                ? tc_prob(sa[nt][e], scale, slope, s, e < 2 ? lse_lo : lse_hi)
                : 0.f;
            sa[nt][e] = p * (pa[nt][e] - (e < 2 ? dsum_lo : dsum_hi)) * scale;
          }
        }
      } else {
        const float* lt = lse_s + st * BS + wc;
        const float* dt = dsum_s + st * BS + wc;
        const bool full = row0 + r0 + 15 <= n_past + w0 && w0 + W <= T &&
                          row0 + r0 + 16 <= S;
#pragma unroll
        for (int nt = 0; nt < NS; ++nt) {
          const float2 l = *reinterpret_cast<const float2*>(lt + nt * 8 + 2 * t4);
          const float2 d2 = *reinterpret_cast<const float2*>(dt + nt * 8 + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int s = e < 2 ? lo : hi;
            const int t = w0 + nt * 8 + 2 * t4 + (e & 1);
            const float p = full || (t < T && s < S && s <= n_past + t)
                ? tc_prob(sa[nt][e], scale, slope, s,
                          tc_live_lse((e & 1) ? l.y : l.x))
                : 0.f;
            sa[nt][e] = p;
            pa[nt][e] = p * (pa[nt][e] - ((e & 1) ? d2.y : d2.x)) * scale;
          }
        }
      }
      if constexpr (P.cs == 1) {
        // K7: dQ += dS K; K8: dV += P^T dO, then dK += dS^T Q
        const int b_off = 2 * t4 * DP + g;
        if constexpr (DKV) {
          tf_grad_regs<KT, ND, DP>(acc2, sa, tb + b_off);
          tf_grad_regs<KT, ND, DP>(acc, pa, ta + b_off);
        } else {
          tf_grad_regs<KT, ND, DP>(acc, sa, ta + b_off);
        }
      } else {
        // stage ds (K8: p, then ds): rows resident, columns streamed
#pragma unroll
        for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int at = (r0 + g + 8 * half) * PS + wc + nt * 8 + 2 * t4;
            *reinterpret_cast<float2*>(stg + at) =
                make_float2(sa[nt][2 * half], sa[nt][2 * half + 1]);
            if constexpr (DKV)
              *reinterpret_cast<float2*>(stg + R * PS + at) =
                  make_float2(pa[nt][2 * half], pa[nt][2 * half + 1]);
          }
        }
      }
    }
    if constexpr (P.cs > 1) {
      __syncthreads();  // a row tile's ds (K8: p and ds) are staged
      if (live) {
        // every streamed row of the tile, this warp's columns
        const int b_off = 2 * t4 * DP + col0 + g;
        const float* xs = stg + (r0 + g) * PS;
        if constexpr (DKV) {
          tf_grad_staged<KT, ND, DP, PS>(acc2, xs, tb + b_off, t4);
          tf_grad_staged<KT, ND, DP, PS>(acc, xs + R * PS, ta + b_off, t4);
        } else {
          tf_grad_staged<KT, ND, DP, PS>(acc, xs, ta + b_off, t4);
        }
      }
    }
    __syncthreads();  // this stage and the staged tiles are refilled next
  }
  cp_async_wait<0>();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? hi : lo;
    if (r >= n_res) continue;
    float* row0p = out0 + (DKV ? kvbase : qbase) + static_cast<size_t>(r) * D;
    float* row1p = DKV ? out1 + kvbase + static_cast<size_t>(r) * D : nullptr;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn) {
      const int col = col0 + dn * 8 + 2 * t4;
      if (col >= D) continue;  // the head dim's padding is never stored
      *reinterpret_cast<float2*>(row0p + col) =
          make_float2(acc[dn][2 * half], acc[dn][2 * half + 1]);
      if constexpr (DKV)
        *reinterpret_cast<float2*>(row1p + col) =
            make_float2(acc2[dn][2 * half], acc2[dn][2 * half + 1]);
    }
  }
}

#define VSIM_TF_PAD_PARAMS                                                  \
  const float *__restrict__ q, const float *__restrict__ k,                 \
      const float *__restrict__ v, const float *__restrict__ do_,           \
      const float *__restrict__ lse, const float *__restrict__ dsum,        \
      float *__restrict__ out0, float *__restrict__ out1,                   \
      const float *__restrict__ slopes, int H, int T, int S, int D,         \
      int n_past, float scale

// K7 at padded head dim DPAD: dq into out0 (out1 unused)
template <int DPAD>
__global__ void __launch_bounds__(tf_threads(DPAD, false),
                                  tf_plan(DPAD, false).min_blocks)
flash_bwd_dq_3xtf32_pad_kernel(VSIM_TF_PAD_PARAMS) {
  tf_pad_block<DPAD, false>(q, k, v, do_, lse, dsum, out0, out1, slopes, H, T,
                            S, D, n_past, scale);
}

// K8 at padded head dim DPAD: dk into out0, dv into out1
template <int DPAD>
__global__ void __launch_bounds__(tf_threads(DPAD, true),
                                  tf_plan(DPAD, true).min_blocks)
flash_bwd_dkv_3xtf32_pad_kernel(VSIM_TF_PAD_PARAMS) {
  tf_pad_block<DPAD, true>(q, k, v, do_, lse, dsum, out0, out1, slopes, H, T,
                           S, D, n_past, scale);
}

#undef VSIM_TF_PAD_PARAMS

// ---------------------------------------------------------------------------
// "mma_bf16": bf16 at D % 16 == 0 (D <= 256) on the tensor cores
// ---------------------------------------------------------------------------

// Each instance's geometry by the padded head dim: rt row tiles of 16
// resident rows (K7 queries, K8 keys); cs warps a row tile (K8 only: they
// split the streamed queries for s and dp and the columns of dk and dv);
// streamed tiles of ``tile`` rows (K7 keys, K8 queries); and the blocks an
// SM the register budget is set for (__launch_bounds__).  Picked by
// measurement (tools/bwd_plans.py; see the header).
struct BfPlan {
  int rt, cs, tile, min_blocks;
};
__host__ __device__ constexpr BfPlan bf_plan(int dpad, bool dkv) {
  return dkv ? (dpad <= 64   ? BfPlan{4, 2, 64, 2}
                : dpad <= 80 ? BfPlan{4, 1, 32, 2}
                : dpad <= 128 ? BfPlan{4, 2, 64, 1}
                              : BfPlan{2, 4, 64, 1})
             : (dpad <= 64   ? BfPlan{4, 1, 64, 3}
                : dpad <= 96 ? BfPlan{4, 1, 32, 3}
                : dpad <= 128 ? BfPlan{4, 1, 64, 2}
                              : BfPlan{4, 1, 16, 1});
}
__host__ __device__ constexpr int bf_threads(int dpad, bool dkv) {
  return 32 * bf_plan(dpad, dkv).rt * bf_plan(dpad, dkv).cs;
}

// x0, x1 as two bf16 pairs: hi = bf16(x), lo = bf16(x - hi), each rounded to
// nearest even (x - hi is exact in f32)
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi,
                                             uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  lo = pack_bf16(x0 - __uint_as_float(hi << 16),
                 x1 - __uint_as_float(hi & 0xFFFF0000u));
}

// The m16n8 accumulators of two adjacent n-tiles (16 rows, 16 columns) as
// the hi and lo A fragments of an m16n8k16 product over those 16 columns
__device__ __forceinline__ void acc_to_a(const float (&c0)[4],
                                         const float (&c1)[4],
                                         uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_bf16x2(c0[0], c0[1], hi[0], lo[0]);
  split_bf16x2(c0[2], c0[3], hi[1], lo[1]);
  split_bf16x2(c1[0], c1[1], hi[2], lo[2]);
  split_bf16x2(c1[2], c1[3], hi[3], lo[3]);
}

// Rows [row0, row0 + n) of one head's [rows, D] bf16 matrix into sm[n][DS]
// by 16-byte cp.async (D % 8 == 0); rows past ``rows`` read as zeros.
template <int DS, int NTHR>
__device__ __forceinline__ void bf_load_rows(uint16_t* sm, const uint16_t* g,
                                             int row0, int n, int rows,
                                             int D) {
  const int cpr = D / 8;
  for (int idx = threadIdx.x; idx < n * cpr; idx += NTHR) {
    const int r = idx / cpr, c = (idx % cpr) * 8;
    const int row = row0 + r;
    const bool ok = row < rows;
    cp_async16(sm + r * DS + c, g + static_cast<size_t>(ok ? row : 0) * D + c,
               ok);
  }
}

// One warp's score products over the padded head dim: sa = A B^T and pa =
// A2 B2^T, A and A2 its 16 resident rows (ldmatrix offset a_off), B and B2
// the NT * 8 rows of the streamed tile; every operand exact in bf16
template <int KS, int NT, int DS>
__device__ __forceinline__ void bf_scores(float (&sa)[NT][4], float (&pa)[NT][4],
                                          const uint16_t* as,
                                          const uint16_t* a2s,
                                          const uint16_t* bs,
                                          const uint16_t* b2s, int a_off,
                                          int kb_row, int kb_col) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
    sa[i][0] = sa[i][1] = sa[i][2] = sa[i][3] = pa[i][0] = pa[i][1] =
        pa[i][2] = pa[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t a[4], a2[4];
    ldmatrix_x4(a, as + a_off + kk * 16);
    ldmatrix_x4(a2, a2s + a_off + kk * 16);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      const int off = (np * 16 + kb_row) * DS + kk * 16 + kb_col;
      uint32_t b[4];
      ldmatrix_x4(b, bs + off);
      mma_bf16(sa[2 * np], a, b[0], b[1]);
      mma_bf16(sa[2 * np + 1], a, b[2], b[3]);
      ldmatrix_x4(b, b2s + off);
      mma_bf16(pa[2 * np], a2, b[0], b[1]);
      mma_bf16(pa[2 * np + 1], a2, b[2], b[3]);
    }
  }
}

// acc += X . Bt over the KT 16-row k-steps of the streamed tile bt (rows the
// k index; this warp's columns from col0), X given as its hi and lo A
// fragments: lo then hi into a fresh f32 fragment a tile, which is then added
// to acc in f32, so that the tensor cores' own sums span one tile only
template <int KT, int NT, int DS>
__device__ __forceinline__ void bf_grad(float (&acc)[NT][4],
                                        const uint32_t (&hi)[KT][4],
                                        const uint32_t (&lo)[KT][4],
                                        const uint16_t* bt, int col0,
                                        int vb_row, int vb_col) {
#pragma unroll
  for (int dp = 0; dp < NT / 2; ++dp) {
    float f0[4] = {0.f, 0.f, 0.f, 0.f}, f1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, bt + (kk * 16 + vb_row) * DS + col0 + dp * 16 + vb_col);
      mma_bf16(f0, lo[kk], b[0], b[1]);
      mma_bf16(f0, hi[kk], b[0], b[1]);
      mma_bf16(f1, lo[kk], b[2], b[3]);
      mma_bf16(f1, hi[kk], b[2], b[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[2 * dp][e] += f0[e];
      acc[2 * dp + 1][e] += f1[e];
    }
  }
}

// Rows row_lo (accumulator elements 0, 1) and row_lo + 8 (2, 3) of one
// head's [rows, D] output, this warp's columns from col0, as bf16
template <int NT>
__device__ __forceinline__ void bf_store(uint16_t* out, const float (&acc)[NT][4],
                                         int row_lo, int rows, int D, int col0,
                                         int t4) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row_lo + 8 * half;
    if (r >= rows) continue;
    uint16_t* row = out + static_cast<size_t>(r) * D;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = col0 + nt * 8 + 2 * t4;
      if (col < D)  // the head dim's padding is never stored
        *reinterpret_cast<uint32_t*>(row + col) =
            pack_bf16(acc[nt][2 * half], acc[nt][2 * half + 1]);
    }
  }
}

// Zero columns [D, DPAD) of n shared rows: no load touches them, and they
// change no product
template <int DPAD, int NTHR>
__device__ __forceinline__ void bf_zero_pad(uint16_t* sm, int n, int D) {
  constexpr int DS = DPAD + 8;
  if (DPAD == D) return;
  const int np = DPAD - D;
  for (int idx = threadIdx.x; idx < n * np; idx += NTHR)
    sm[(idx / np) * DS + D + idx % np] = 0;
}

// K7: one block per (b, h, 64-query tile), warps by bf_plan.
template <int DPAD>
__global__ void __launch_bounds__(bf_threads(DPAD, false),
                                  bf_plan(DPAD, false).min_blocks)
flash_bwd_dq_bf16_kernel(const uint16_t* __restrict__ q,   // [B, H, T, D]
                         const uint16_t* __restrict__ k,   // [B, H, S, D]
                         const uint16_t* __restrict__ v,   // [B, H, S, D]
                         const uint16_t* __restrict__ do_, // [B, H, T, D]
                         const float* __restrict__ lse,    // [B, H, T]
                         const float* __restrict__ dsum,   // [B, H, T]
                         uint16_t* __restrict__ dq,        // [B, H, T, D]
                         const float* __restrict__ slopes,  // [H] or null
                         int H, int T, int S, int D, int n_past, float scale) {
  constexpr BfPlan P = bf_plan(DPAD, false);
  constexpr int NTHR = bf_threads(DPAD, false);
  constexpr int BS = P.tile;
  constexpr int DS = DPAD + 8;   // shared row: 16 bytes of padding
  constexpr int KS = DPAD / 16;  // k-steps of the score products
  constexpr int NS = BS / 8;     // 8-key n-tiles of a score tile
  constexpr int ND = DPAD / 8;   // 8-column n-tiles of dq
  extern __shared__ __align__(16) uint16_t smb[];
  uint16_t* qs = smb;                  // [64][DS]
  uint16_t* dos = qs + kTcRows * DS;   // [64][DS]
  uint16_t* ks = dos + kTcRows * DS;   // [2][BS][DS]
  uint16_t* vs = ks + 2 * BS * DS;     // [2][BS][DS]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;  // mma row group, lane in quad
  static_assert(P.rt * 16 == kTcRows && P.cs == 1,
                "K7: 64 queries a block, a warp's 16 rows whole");
  const int r0 = warp * 16;
  const int bh = blockIdx.y, h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcRows;  // longest first
  const uint16_t* qg = q + static_cast<size_t>(bh) * T * D;
  const uint16_t* dog = do_ + static_cast<size_t>(bh) * T * D;
  const uint16_t* kg = k + static_cast<size_t>(bh) * S * D;
  const uint16_t* vg = v + static_cast<size_t>(bh) * S * D;
  const size_t rbase = static_cast<size_t>(bh) * T;
  const float slope = slopes ? slopes[h] : 0.f;

  bf_zero_pad<DPAD, NTHR>(smb, 2 * kTcRows + 4 * BS, D);
  // keys any query of this tile can see
  const int last_t = min(q0 + kTcRows, T) - 1;
  const int n_keys = min(S, n_past + last_t + 1);
  const int n_tiles = n_keys > 0 ? (n_keys + BS - 1) / BS : 0;
  bf_load_rows<DS, NTHR>(qs, qg, q0, kTcRows, T, D);
  bf_load_rows<DS, NTHR>(dos, dog, q0, kTcRows, T, D);
  if (n_tiles > 0) {
    bf_load_rows<DS, NTHR>(ks, kg, 0, BS, S, D);
    bf_load_rows<DS, NTHR>(vs, vg, 0, BS, S, D);
  }
  cp_async_commit();

  // this thread's rows: t_lo (accumulator elements 0, 1) and t_hi (2, 3)
  const int t_lo = q0 + r0 + g, t_hi = t_lo + 8;
  const float lse_lo = tc_row_lse(lse, rbase, t_lo, T);
  const float lse_hi = tc_row_lse(lse, rbase, t_hi, T);
  const float dsum_lo = t_lo < T ? dsum[rbase + t_lo] : 0.f;
  const float dsum_hi = t_hi < T ? dsum[rbase + t_hi] : 0.f;
  const bool warp_live = q0 + r0 < T;
  const int warp_horizon = n_past + min(q0 + r0 + 15, T - 1);  // last key seen
  // ldmatrix addresses of this lane: an A tile, a B tile pair, a .trans pair
  const int a_off = (r0 + lane % 16) * DS + (lane / 16) * 8;
  const int kb_row = (lane % 8) + (lane / 16) * 8, kb_col = ((lane / 8) % 2) * 8;
  const int vb_row = (lane % 8) + ((lane / 8) % 2) * 8, vb_col = (lane / 16) * 8;

  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles) {  // prefetch the next tile into the other stage
      bf_load_rows<DS, NTHR>(ks + (st ^ 1) * BS * DS, kg, (it + 1) * BS, BS, S, D);
      bf_load_rows<DS, NTHR>(vs + (st ^ 1) * BS * DS, vg, (it + 1) * BS, BS, S, D);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int s0 = it * BS;
    if (warp_live && s0 <= warp_horizon) {
      const uint16_t* kt = ks + st * BS * DS;
      const uint16_t* vt = vs + st * BS * DS;
      float sa[NS][4], pa[NS][4];  // S and dP
      bf_scores<KS, NS, DS>(sa, pa, qs, dos, kt, vt, a_off, kb_row, kb_col);
      // ds in place of S; keys s0 + 8 nt + 2 t4 + (e & 1).  The mask is
      // tested only where a row of the warp misses a key of the tile
      const bool full = s0 + BS - 1 <= n_past + q0 + r0 && s0 + BS <= S;
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = s0 + nt * 8 + 2 * t4 + (e & 1);
          const int t = e < 2 ? t_lo : t_hi;
          const float p = full || (s < S && s <= n_past + t)
              ? tc_prob(sa[nt][e], scale, slope, s, e < 2 ? lse_lo : lse_hi)
              : 0.f;
          sa[nt][e] = p * (pa[nt][e] - (e < 2 ? dsum_lo : dsum_hi)) * scale;
        }
      }
      // dQ += dS K: two score n-tiles are one 16-key A fragment
      uint32_t dh[BS / 16][4], dl[BS / 16][4];
#pragma unroll
      for (int j = 0; j < BS / 16; ++j) acc_to_a(sa[2 * j], sa[2 * j + 1], dh[j], dl[j]);
      bf_grad<BS / 16, ND, DS>(acc, dh, dl, kt, 0, vb_row, vb_col);
    }
    __syncthreads();  // this stage is refilled by the next prefetch
  }
  cp_async_wait<0>();
  bf_store<ND>(dq + rbase * D, acc, t_lo, T, D, 0, t4);
}

// K8: one block per (b, h, 16 * rt-key tile), warps by bf_plan.  With cs
// > 1 the cs warps of a row tile split the streamed tile's queries for s and
// dp, stage their hi/lo p and ds in shared memory, and after a barrier each
// takes its share of dk's and dv's columns over all the tile's queries.
template <int DPAD>
__global__ void __launch_bounds__(bf_threads(DPAD, true),
                                  bf_plan(DPAD, true).min_blocks)
flash_bwd_dkv_bf16_kernel(const uint16_t* __restrict__ q,
                          const uint16_t* __restrict__ k,
                          const uint16_t* __restrict__ v,
                          const uint16_t* __restrict__ do_,
                          const float* __restrict__ lse,
                          const float* __restrict__ dsum,
                          uint16_t* __restrict__ dk,  // [B, H, S, D]
                          uint16_t* __restrict__ dv,  // [B, H, S, D]
                          const float* __restrict__ slopes, int H, int T,
                          int S, int D, int n_past, float scale) {
  constexpr BfPlan P = bf_plan(DPAD, true);
  constexpr int NTHR = bf_threads(DPAD, true);
  constexpr int RT = P.rt;
  constexpr int ROWS = 16 * RT;  // resident keys
  constexpr int BQ = P.tile;
  constexpr int QW = BQ / P.cs;  // queries of a warp's s and dp
  constexpr int DS = DPAD + 8;
  constexpr int PS = BQ + 8;     // a staged row: 16 bytes of padding
  constexpr int KS = DPAD / 16;
  constexpr int NQ = QW / 8;     // 8-query n-tiles of a warp's score tile
  constexpr int DH = DPAD / P.cs;
  constexpr int ND = DH / 8;
  static_assert(QW % 16 == 0 && DH % 16 == 0, "whole 16-wide fragments");
  extern __shared__ __align__(16) uint16_t smb[];
  uint16_t* ks = smb;                   // [ROWS][DS]
  uint16_t* vs = ks + ROWS * DS;        // [ROWS][DS]
  uint16_t* qs = vs + ROWS * DS;        // [2][BQ][DS]
  uint16_t* dos = qs + 2 * BQ * DS;     // [2][BQ][DS]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BQ * DS);  // [2][BQ]
  float* dsum_s = lse_s + 2 * BQ;                               // [2][BQ]
  // cs > 1: p hi, p lo, ds hi, ds lo, each [ROWS][PS]
  uint16_t* stg = reinterpret_cast<uint16_t*>(dsum_s + 2 * BQ);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int r0 = (warp % RT) * 16, col0 = (warp / RT) * DH;
  const int qc = (warp / RT) * QW;  // this warp's queries in the tile
  const int bh = blockIdx.y, h = bh % H;
  const int s0 = blockIdx.x * ROWS;
  const uint16_t* qg = q + static_cast<size_t>(bh) * T * D;
  const uint16_t* dog = do_ + static_cast<size_t>(bh) * T * D;
  const float* lseg = lse + static_cast<size_t>(bh) * T;
  const float* dsumg = dsum + static_cast<size_t>(bh) * T;
  const size_t kvbase = static_cast<size_t>(bh) * S * D;
  const float slope = slopes ? slopes[h] : 0.f;

  // q, do, lse and dsum rows [q0, q0 + BQ) into stage st of the ring
  auto load_queries = [&](int st, int q0) {
    bf_load_rows<DS, NTHR>(qs + st * BQ * DS, qg, q0, BQ, T, D);
    bf_load_rows<DS, NTHR>(dos + st * BQ * DS, dog, q0, BQ, T, D);
    for (int i = threadIdx.x; i < BQ; i += NTHR) {
      const int t = q0 + i;
      const bool ok = t < T;  // past T: zeros, masked by t < T
      cp_async4(lse_s + st * BQ + i, lseg + (ok ? t : 0), ok);
      cp_async4(dsum_s + st * BQ + i, dsumg + (ok ? t : 0), ok);
    }
  };

  bf_zero_pad<DPAD, NTHR>(smb, 2 * ROWS + 4 * BQ, D);
  // query t sees key s0 iff n_past + t >= s0: start at the tile of
  // t = s0 - n_past; tiles no query reaches leave the zeros
  const int first = s0 > n_past ? (s0 - n_past) / BQ : 0;
  const int n_qt = (T + BQ - 1) / BQ;
  bf_load_rows<DS, NTHR>(ks, k + kvbase, s0, ROWS, S, D);
  bf_load_rows<DS, NTHR>(vs, v + kvbase, s0, ROWS, S, D);
  if (first < n_qt) load_queries(0, first * BQ);
  cp_async_commit();

  // this thread's keys: s_lo (accumulator elements 0, 1) and s_hi (2, 3)
  const int s_lo = s0 + r0 + g, s_hi = s_lo + 8;
  const bool warp_live = s0 + r0 < S;
  const int a_off = (r0 + lane % 16) * DS + (lane / 16) * 8;
  const int p_off = (r0 + lane % 16) * PS + (lane / 16) * 8;
  const int kb_row = (lane % 8) + (lane / 16) * 8, kb_col = ((lane / 8) % 2) * 8;
  const int vb_row = (lane % 8) + ((lane / 8) % 2) * 8, vb_col = (lane / 16) * 8;
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
    dka[i][0] = dka[i][1] = dka[i][2] = dka[i][3] = dva[i][0] = dva[i][1] =
        dva[i][2] = dva[i][3] = 0.f;

  for (int it = first; it < n_qt; ++it) {
    const int st = (it - first) & 1;
    if (it + 1 < n_qt) load_queries(st ^ 1, (it + 1) * BQ);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int q0 = it * BQ;
    const uint16_t* qt = qs + st * BQ * DS;
    const uint16_t* ot = dos + st * BQ * DS;
    // the tile's last query sees keys up to n_past + that query (the same
    // for every warp of a row tile)
    const bool live = warp_live && s0 + r0 <= n_past + min(q0 + BQ, T) - 1;
    uint32_t hi[BQ / 16][4], lo[BQ / 16][4];
    if (live) {
      const float* lt = lse_s + st * BQ + qc;
      const float* dt = dsum_s + st * BQ + qc;
      float sa[NQ][4], pa[NQ][4];  // S^T and dP^T: rows keys, columns queries
      bf_scores<KS, NQ, DS>(sa, pa, ks, vs, qt + qc * DS, ot + qc * DS, a_off,
                            kb_row, kb_col);
      // p in place of S^T, ds in place of dP^T; queries q0 + qc + 8 nt +
      // 2 t4 + (e & 1).  The mask is tested only where a query of the warp's
      // share misses a key of the warp
      const int qw0 = q0 + qc;
      const bool full = s0 + r0 + 15 <= n_past + qw0 && qw0 + QW <= T &&
                        s0 + r0 + 16 <= S;
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt) {
        const float2 l = *reinterpret_cast<const float2*>(lt + nt * 8 + 2 * t4);
        const float2 d2 = *reinterpret_cast<const float2*>(dt + nt * 8 + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = e < 2 ? s_lo : s_hi;
          const int t = qw0 + nt * 8 + 2 * t4 + (e & 1);
          const float p = full || (t < T && s < S && s <= n_past + t)
              ? tc_prob(sa[nt][e], scale, slope, s,
                        tc_live_lse((e & 1) ? l.y : l.x))
              : 0.f;
          sa[nt][e] = p;
          pa[nt][e] = p * (pa[nt][e] - ((e & 1) ? d2.y : d2.x)) * scale;
        }
      }
      if constexpr (P.cs == 1) {
        // dV += P^T dO, then dK += dS^T Q: two score n-tiles are one
        // 16-query A fragment
#pragma unroll
        for (int j = 0; j < BQ / 16; ++j)
          acc_to_a(sa[2 * j], sa[2 * j + 1], hi[j], lo[j]);
        bf_grad<BQ / 16, ND, DS>(dva, hi, lo, ot, 0, vb_row, vb_col);
#pragma unroll
        for (int j = 0; j < BQ / 16; ++j)
          acc_to_a(pa[2 * j], pa[2 * j + 1], hi[j], lo[j]);
        bf_grad<BQ / 16, ND, DS>(dka, hi, lo, qt, 0, vb_row, vb_col);
      } else {
        // stage p and ds as hi/lo bf16 pairs: rows keys, columns queries
#pragma unroll
        for (int nt = 0; nt < NQ; ++nt) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int at = (r0 + g + 8 * half) * PS + qc + nt * 8 + 2 * t4;
            uint32_t h2, l2;
            split_bf16x2(sa[nt][2 * half], sa[nt][2 * half + 1], h2, l2);
            *reinterpret_cast<uint32_t*>(stg + at) = h2;
            *reinterpret_cast<uint32_t*>(stg + ROWS * PS + at) = l2;
            split_bf16x2(pa[nt][2 * half], pa[nt][2 * half + 1], h2, l2);
            *reinterpret_cast<uint32_t*>(stg + 2 * ROWS * PS + at) = h2;
            *reinterpret_cast<uint32_t*>(stg + 3 * ROWS * PS + at) = l2;
          }
        }
      }
    }
    if constexpr (P.cs > 1) {
      __syncthreads();  // a row tile's p and ds are staged
      if (live) {
        // dV += P^T dO, then dK += dS^T Q over every query of the tile,
        // this warp's columns
#pragma unroll
        for (int j = 0; j < BQ / 16; ++j) {
          ldmatrix_x4(hi[j], stg + p_off + j * 16);
          ldmatrix_x4(lo[j], stg + ROWS * PS + p_off + j * 16);
        }
        bf_grad<BQ / 16, ND, DS>(dva, hi, lo, ot, col0, vb_row, vb_col);
#pragma unroll
        for (int j = 0; j < BQ / 16; ++j) {
          ldmatrix_x4(hi[j], stg + 2 * ROWS * PS + p_off + j * 16);
          ldmatrix_x4(lo[j], stg + 3 * ROWS * PS + p_off + j * 16);
        }
        bf_grad<BQ / 16, ND, DS>(dka, hi, lo, qt, col0, vb_row, vb_col);
      }
    }
    __syncthreads();  // this stage and the staged tiles are refilled next
  }
  cp_async_wait<0>();
  bf_store<ND>(dk + kvbase, dka, s_lo, S, D, col0, t4);
  bf_store<ND>(dv + kvbase, dva, s_lo, S, D, col0, t4);
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

template <int NG>
int launch_dq(const Args& a) {
  auto kern = flash_bwd_dq_kernel<NG>;
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

template <int NG>
int launch_dkv(const Args& a) {
  auto kern = flash_bwd_dkv_kernel<NG>;
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

template <int DPAD>
int launch_dq_bf16(const Args& a) {
  auto kern = flash_bwd_dq_bf16_kernel<DPAD>;
  const size_t smem =
      sizeof(uint16_t) * (2 * kTcRows + 4 * bf_plan(DPAD, false).tile) *
      (DPAD + 8);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.T + kTcRows - 1) / kTcRows, a.B * a.H);
  kern<<<grid, bf_threads(DPAD, false), smem, a.stream>>>(
      static_cast<const uint16_t*>(a.q), static_cast<const uint16_t*>(a.k),
      static_cast<const uint16_t*>(a.v), static_cast<const uint16_t*>(a.do_),
      a.lse, a.dsum, static_cast<uint16_t*>(a.out0), a.slopes, a.H, a.T, a.S,
      a.D, a.n_past, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DPAD>
int launch_dkv_bf16(const Args& a) {
  auto kern = flash_bwd_dkv_bf16_kernel<DPAD>;
  constexpr BfPlan P = bf_plan(DPAD, true);
  constexpr int BQ = P.tile, ROWS = 16 * P.rt;
  const size_t smem = sizeof(uint16_t) * (2 * ROWS + 4 * BQ) * (DPAD + 8) +
                      sizeof(float) * 4 * BQ +
                      (P.cs > 1 ? sizeof(uint16_t) * 4 * ROWS * (BQ + 8) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + ROWS - 1) / ROWS, a.B * a.H);
  kern<<<grid, bf_threads(DPAD, true), smem, a.stream>>>(
      static_cast<const uint16_t*>(a.q), static_cast<const uint16_t*>(a.k),
      static_cast<const uint16_t*>(a.v), static_cast<const uint16_t*>(a.do_),
      a.lse, a.dsum, static_cast<uint16_t*>(a.out0),
      static_cast<uint16_t*>(a.out1), a.slopes, a.H, a.T, a.S, a.D, a.n_past,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DPAD, bool DKV>
int launch_3xtf32_pad(const Args& a) {
  auto kern = DKV ? flash_bwd_dkv_3xtf32_pad_kernel<DPAD>
                 : flash_bwd_dq_3xtf32_pad_kernel<DPAD>;
  constexpr size_t smem = tf_smem_bytes(DPAD, DKV);
  static_assert(smem <= 232448, "a block's shared memory on the H100");
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int R = 16 * tf_plan(DPAD, DKV).rt;
  const dim3 grid(((DKV ? a.S : a.T) + R - 1) / R, a.B * a.H);
  kern<<<grid, tf_threads(DPAD, DKV), smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.do_), a.lse,
      a.dsum, static_cast<float*>(a.out0), static_cast<float*>(a.out1),
      a.slopes, a.H, a.T, a.S, a.D, a.n_past, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// "mma_3xtf32" at head dim D: the D = 64 and 128 kernels, else the instance
// padded to the next of 64, 80, 96, 128, 256
template <bool DKV>
int launch_3xtf32(const Args& a) {
  if (a.D == 64) return DKV ? launch_dkv_3xtf32<64>(a) : launch_dq_3xtf32<64>(a);
  if (a.D == 128) return DKV ? launch_dkv_3xtf32<128>(a) : launch_dq_3xtf32<128>(a);
  if (a.D <= 64) return launch_3xtf32_pad<64, DKV>(a);
  if (a.D <= 80) return launch_3xtf32_pad<80, DKV>(a);
  if (a.D <= 96) return launch_3xtf32_pad<96, DKV>(a);
  if (a.D <= 128) return launch_3xtf32_pad<128, DKV>(a);
  return launch_3xtf32_pad<256, DKV>(a);
}

// "mma_bf16" at head dim D, padded to the next of 64, 80, 96, 128, 256
template <bool DKV>
int launch_bf16(const Args& a) {
  if (a.D <= 64) return DKV ? launch_dkv_bf16<64>(a) : launch_dq_bf16<64>(a);
  if (a.D <= 80) return DKV ? launch_dkv_bf16<80>(a) : launch_dq_bf16<80>(a);
  if (a.D <= 96) return DKV ? launch_dkv_bf16<96>(a) : launch_dq_bf16<96>(a);
  if (a.D <= 128) return DKV ? launch_dkv_bf16<128>(a) : launch_dq_bf16<128>(a);
  return DKV ? launch_dkv_bf16<256>(a) : launch_dq_bf16<256>(a);
}

// The instance the caller picked (ops/attention.py:_INSTANCES): 1
// "mma_3xtf32" (f32), 2 "mma_bf16" (bf16 at D % 16 == 0), 0 the FMA tiles
// (bf16), NG column groups of 32 covering D.  An instance that does not
// exist for (dtype, D) is an error, never a substitute.
template <bool DKV>
int dispatch(const Args& a, int is_bf16, int inst) {
  if (a.D % 4 != 0 || a.D > kMaxD || a.D <= 0 || inst < 0 || inst > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (inst == 1) {
    if (is_bf16) return static_cast<int>(cudaErrorInvalidValue);
    return launch_3xtf32<DKV>(a);
  }
  if (inst == 2) {
    if (!is_bf16 || a.D % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
    return launch_bf16<DKV>(a);
  }
  if (!is_bf16) return static_cast<int>(cudaErrorInvalidValue);
  const int ng = a.D <= 64 ? 2 : a.D <= 128 ? 4 : 8;
  if (DKV) {
    if (ng == 2) return launch_dkv<2>(a);
    if (ng == 4) return launch_dkv<4>(a);
    return launch_dkv<8>(a);
  }
  if (ng == 2) return launch_dq<2>(a);
  if (ng == 4) return launch_dq<4>(a);
  return launch_dq<8>(a);
}

}  // namespace

// VSIM_BWD_PASS 0 or 1 builds one pass's entry (and so its instances)
// alone: ops/_build.py builds the two as two libraries at once.
#if !defined(VSIM_BWD_PASS) || VSIM_BWD_PASS == 0
extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* do_,
    const void* lse, const void* dsum, void* dq, const void* slopes,
    int is_bf16, int inst, int B, int H, int T, int S, int D, int n_past,
    float scale, void* stream) {
  const Args a{q, k, v, do_, static_cast<const float*>(lse),
               static_cast<const float*>(dsum), dq, nullptr,
               static_cast<const float*>(slopes), B, H, T, S, D, n_past, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, is_bf16, inst);
}
#endif

#if !defined(VSIM_BWD_PASS) || VSIM_BWD_PASS == 1
extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* do_,
    const void* lse, const void* dsum, void* dk, void* dv, const void* slopes,
    int is_bf16, int inst, int B, int H, int T, int S, int D, int n_past,
    float scale, void* stream) {
  const Args a{q, k, v, do_, static_cast<const float*>(lse),
               static_cast<const float*>(dsum), dk, dv,
               static_cast<const float*>(slopes), B, H, T, S, D, n_past, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, is_bf16, inst);
}
#endif
