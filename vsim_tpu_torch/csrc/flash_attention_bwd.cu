// K7 flash_attention_bwd_dq and K8 flash_attention_bwd_dkv: the backward of
// causal blockwise attention (K4), recomputing p from q, k and the saved lse.
//
// Replaces vsim_tpu/ops/attention.py:_bwd_dq_kernel (:196, K7) and
// _bwd_dkv_kernel (:236, K8) with the same numerics: q, k, v and do (do
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
// per visible (query, key) pair), here run on f32 FMA units from shared
// memory; wgmma and TMA are later work.  Design: 256 threads, 32-row query
// tiles and 32-key tiles, rows padded to D + 4 floats so each lane reads its
// own key row as float4 without bank conflicts.  In the score pass a warp
// takes 4 query rows and a lane one key, and both dot products (q.k, do.v)
// share each float4 of k and v.  In the accumulation pass a thread owns one
// row (K7: a query row of dq; K8: a key row of dk and dv) and D/8 of its
// columns in registers.  K7 walks the key tiles up to the query tile's
// causal horizon; K8 walks the query tiles from the first one that sees its
// key tile, and writes zeros for key rows no query sees.  At D = 256 K8
// takes 142 KB of dynamic shared memory and 64 accumulator registers.

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

// the instance for (dtype, D): NG column groups of 32 cover D
template <bool DKV>
int dispatch(const Args& a, int is_bf16) {
  if (a.D % 4 != 0 || a.D > kMaxD || a.D <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
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
    int is_bf16, int B, int H, int T, int S, int D, int n_past, float scale,
    void* stream) {
  const Args a{q, k, v, do_, static_cast<const float*>(lse),
               static_cast<const float*>(dsum), dq, nullptr,
               static_cast<const float*>(slopes), B, H, T, S, D, n_past, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, is_bf16);
}

extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* do_,
    const void* lse, const void* dsum, void* dk, void* dv, const void* slopes,
    int is_bf16, int B, int H, int T, int S, int D, int n_past, float scale,
    void* stream) {
  const Args a{q, k, v, do_, static_cast<const float*>(lse),
               static_cast<const float*>(dsum), dk, dv,
               static_cast<const float*>(slopes), B, H, T, S, D, n_past, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, is_bf16);
}
