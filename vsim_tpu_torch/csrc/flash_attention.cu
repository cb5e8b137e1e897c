// K4 flash_attention_fwd: causal blockwise attention for prefill.
//
// Replaces vsim_tpu/ops/attention.py:_fwd_kernel (:62), forward only, same
// numerics: q and k widened to f32, score = q.k * scale (+ slope_h * s),
// query t (cache offset n_past) sees key s iff s <= n_past + t, f32 online
// softmax, p rounded to v's dtype before the p.v product (as
// `p.astype(v_ref.dtype)`), out = acc / l in q's dtype, lse = m + log l (f32;
// kept for the training slice's backward).  Key tiles past the causal horizon
// of a query tile are never visited.
//
// Bound on the H100: operations at long T (4 T S D / 2 multiply-adds with the
// causal half), here run on f32 FMA units from shared memory; the tensor
// cores (wgmma on bf16 tiles) are later work.  Design: one block per
// (b, h, 16-query tile), looping over 32-key tiles.  GPT-J's D = 256 sets the
// shared memory: q [16 x 257], k [32 x 257] (rows padded one float so the
// score loop, one key per lane, is free of bank conflicts), v [32 x 256] and
// the p tile: 84 KB of dynamic shared memory.  Each thread owns one query row
// and D/8 of its output columns in registers.

#include "common.cuh"

namespace {

constexpr int kBQ = 16;       // query rows per block
constexpr int kBS = 32;       // keys per tile (one per lane in the score pass)
constexpr int kThreads = 128; // 4 warps
constexpr int kMaxD = 256;
constexpr int kColsPerThread = kMaxD / 8;  // 8 threads share a query row

template <bool BF16>
__device__ __forceinline__ float load_val(const void* p, size_t i) {
  if (BF16) return bf16_to_float(static_cast<const uint16_t*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const void* __restrict__ q,   // [B, H, T, D]
                 const void* __restrict__ k,   // [B, H, S, D]
                 const void* __restrict__ v,   // [B, H, S, D]
                 void* __restrict__ out,       // [B, H, T, D], q's dtype
                 float* __restrict__ lse,      // [B, H, T]
                 const float* __restrict__ slopes,  // [H] or null
                 int H, int T, int S, int D, int n_past, float scale) {
  extern __shared__ float sm[];
  const int DP = D + 1;
  float* qs = sm;               // [kBQ][DP]
  float* ks = qs + kBQ * DP;    // [kBS][DP]
  float* vs = ks + kBS * DP;    // [kBS][D]
  float* ps = vs + kBS * D;     // [kBQ][kBS]
  float* m_s = ps + kBQ * kBS;  // [kBQ]
  float* l_s = m_s + kBQ;       // [kBQ]
  float* a_s = l_s + kBQ;       // [kBQ]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const size_t qbase = static_cast<size_t>(bh) * T * D;
  const size_t kvbase = static_cast<size_t>(bh) * S * D;
  const float slope = slopes ? slopes[h] : 0.f;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int t = q0 + r;
    qs[r * DP + d] = t < T ? load_val<BF16>(q, qbase + static_cast<size_t>(t) * D + d) : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = VSIM_NEG_INF;
    l_s[tid] = 0.f;
  }
  // keys any query of this tile can see
  const int last_t = min(q0 + kBQ, T) - 1;
  const int n_keys = min(S, n_past + last_t + 1);

  const int row = tid / 8, c0 = tid % 8;
  float acc[kColsPerThread];
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) acc[j] = 0.f;

  for (int s0 = 0; s0 < n_keys; s0 += kBS) {
    __syncthreads();  // q staged / previous tile consumed
    for (int idx = tid; idx < kBS * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      const int s = s0 + r;
      float kv = 0.f, vv = 0.f;
      if (s < S) {
        const size_t off = kvbase + static_cast<size_t>(s) * D + d;
        kv = load_val<BF16>(k, off);
        vv = load_val<BF16>(v, off);
      }
      ks[r * DP + d] = kv;
      vs[r * D + d] = vv;
    }
    __syncthreads();
    // scores: warp w takes query rows w, w+4, ...; lane = key
    for (int r = warp; r < kBQ; r += kThreads / 32) {
      const float* qr = qs + r * DP;
      const float* kr = ks + lane * DP;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      const int s = s0 + lane;
      float sc = dot * scale + slope * static_cast<float>(s);
      const int t = n_past + q0 + r;
      if (s >= S || s > t) sc = VSIM_NEG_INF;
      // online softmax update for row r (this warp owns the row)
      const float mx = warp_max(sc);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float p = sc == VSIM_NEG_INF ? 0.f : expf(sc - m_new);
      const float sum = warp_sum(p);
      ps[r * kBS + lane] = BF16 ? round_bf16(p) : p;
      if (lane == 0) {
        const float alpha = m_prev == VSIM_NEG_INF ? 0.f : expf(m_prev - m_new);
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();
    const float alpha = a_s[row];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[j] *= alpha;
    for (int jj = 0; jj < kBS; ++jj) {
      const float p = ps[row * kBS + jj];
      const float* vr = vs + jj * D + c0;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        if (c0 + 8 * j < D) acc[j] = fmaf(p, vr[8 * j], acc[j]);
    }
  }
  __syncthreads();

  const int t = q0 + row;
  if (t >= T) return;
  const float l = l_s[row], m = m_s[row];
  const float inv = l > 0.f ? 1.f / l : 0.f;
  const size_t obase = qbase + static_cast<size_t>(t) * D;
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) {
    const int d = c0 + 8 * j;
    if (d >= D) continue;
    const float val = acc[j] * inv;
    if (BF16)
      static_cast<uint16_t*>(out)[obase + d] = float_to_bf16_bits(val);
    else
      static_cast<float*>(out)[obase + d] = val;
  }
  if (c0 == 0)
    lse[static_cast<size_t>(bh) * T + t] = l > 0.f ? m + logf(l) : VSIM_NEG_INF;
}

size_t smem_bytes(int D) {
  return sizeof(float) *
         (static_cast<size_t>(kBQ) * (D + 1) + static_cast<size_t>(kBS) * (D + 1) +
          static_cast<size_t>(kBS) * D + kBQ * kBS + 3 * kBQ);
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      const void* slopes, int is_bf16, int B,
                                      int H, int T, int S, int D, int n_past,
                                      float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid((T + kBQ - 1) / kBQ, B * H);
  const size_t smem = smem_bytes(D);
  auto lp = static_cast<float*>(lse);
  auto sl = static_cast<const float*>(slopes);
  cudaError_t err;
  if (is_bf16) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_kernel<true><<<grid, kThreads, smem, st>>>(
        q, k, v, out, lp, sl, H, T, S, D, n_past, scale);
  } else {
    err = cudaFuncSetAttribute(flash_fwd_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_kernel<false><<<grid, kThreads, smem, st>>>(
        q, k, v, out, lp, sl, H, T, S, D, n_past, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
