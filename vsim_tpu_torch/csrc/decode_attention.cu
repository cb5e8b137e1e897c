// K3 decode_attention_q: single-token attention over one layer of the stacked
// quantized KV cache, per-row horizon n_past[b].
//
// Replaces vsim_tpu/ops/decode_attention.py:_kernel (:82) in non-fresh mode
// (the cache already holds this step's row).  Same numerics:
//   score[s] = (q . k_int[s]) * ks[s] * scale (+ slope_h * s),  s <= n_past[b]
//   out      = sum_s p[s] vs[s] v_int[s] / sum_s p[s]   (online softmax, f32)
// with q bf16 (rounded by the wrapper, as the JAX wrapper does), int8 values,
// or int4 plane-packed bytes (byte c holds dims c | c + D/2, value nibble - 8),
// and one bf16 scale per (token, head).
//
// Bound on the H100: bytes, the cache rows up to n_past (2 (Dp + 2) bytes a
// key per head).  The layer is read in place from the stacked [L, B, H, S, Dp]
// cache through il (no copy), and keys past n_past[b] are never read, so
// traffic follows each row's own length.  Design, simple first: one block per
// (b, h) walks its keys in tiles of 64; each warp dots whole key rows against
// q in shared memory (a warp reads 32 contiguous bytes per step), warp 0 folds
// the tile into the running max / denominator, then every thread accumulates
// its own value columns.  At B = 1, H = 16 that is 16 blocks on 132 SMs: a
// split-S (flash-decoding) redesign with a combine step is the next target.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;   // keys per tile
constexpr int kMaxCols = 2; // packed columns per thread: Dp <= 512

template <bool PACKED4>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const uint16_t* __restrict__ q,    // [B, H, D] bf16
                   const uint8_t* __restrict__ kq,    // [L, B, H, S, Dp]
                   const uint16_t* __restrict__ ks,   // [L, B, H, S] bf16
                   const uint8_t* __restrict__ vq,
                   const uint16_t* __restrict__ vs,
                   const int* __restrict__ n_past,    // [B]
                   const float* __restrict__ slopes,  // [H] or null
                   float* __restrict__ out,           // [B, H, D]
                   int il, int B, int H, int S, int D, float scale) {
  extern __shared__ float q_s[];  // [D]
  __shared__ float sc[kTile];
  __shared__ float m_run, l_run, alpha_s;
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int Dp = PACKED4 ? D / 2 : D;
  const size_t bh = (static_cast<size_t>(il) * B + b) * H + h;
  const uint8_t* kbase = kq + bh * S * Dp;
  const uint8_t* vbase = vq + bh * S * Dp;
  const uint16_t* ksb = ks + bh * S;
  const uint16_t* vsb = vs + bh * S;
  const float slope = slopes ? slopes[h] : 0.f;

  for (int d = tid; d < D; d += kThreads)
    q_s[d] = bf16_to_float(q[(static_cast<size_t>(b) * H + h) * D + d]);
  if (tid == 0) {
    m_run = VSIM_NEG_INF;
    l_run = 0.f;
  }
  const int n_keys = max(0, min(n_past[b] + 1, S));

  float acc[kMaxCols][2];
#pragma unroll
  for (int i = 0; i < kMaxCols; ++i) acc[i][0] = acc[i][1] = 0.f;
  __syncthreads();

  for (int s0 = 0; s0 < n_keys; s0 += kTile) {
    const int ns = min(kTile, n_keys - s0);
    for (int j = warp; j < ns; j += kWarps) {
      const uint8_t* row = kbase + static_cast<size_t>(s0 + j) * Dp;
      float dot = 0.f;
      for (int c = lane; c < Dp; c += 32) {
        const uint32_t u = row[c];
        if (PACKED4) {
          dot = fmaf(q_s[c], static_cast<float>(static_cast<int>(u & 0xFu) - 8), dot);
          dot = fmaf(q_s[c + Dp], static_cast<float>(static_cast<int>(u >> 4) - 8), dot);
        } else {
          dot = fmaf(q_s[c], static_cast<float>(static_cast<int8_t>(u)), dot);
        }
      }
      dot = warp_sum(dot);
      if (lane == 0) {
        const int s = s0 + j;
        sc[j] = dot * bf16_to_float(ksb[s]) * scale + slope * static_cast<float>(s);
      }
    }
    __syncthreads();
    if (warp == 0) {
      float mx = VSIM_NEG_INF;
      for (int j = lane; j < ns; j += 32) mx = fmaxf(mx, sc[j]);
      mx = warp_max(mx);
      const float m_prev = m_run;
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < ns; j += 32) {
        const float p = expf(sc[j] - m_new);
        sum += p;
        sc[j] = p * bf16_to_float(vsb[s0 + j]);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = m_prev == VSIM_NEG_INF ? 0.f : expf(m_prev - m_new);
        l_run = alpha * l_run + sum;
        m_run = m_new;
        alpha_s = alpha;
      }
    }
    __syncthreads();
    const float alpha = alpha_s;
#pragma unroll
    for (int i = 0; i < kMaxCols; ++i) {
      const int c = tid + i * kThreads;
      if (c >= Dp) continue;
      float a0 = acc[i][0] * alpha, a1 = acc[i][1] * alpha;
      const uint8_t* col = vbase + static_cast<size_t>(s0) * Dp + c;
      for (int j = 0; j < ns; ++j) {
        const uint32_t u = col[static_cast<size_t>(j) * Dp];
        const float w = sc[j];
        if (PACKED4) {
          a0 = fmaf(w, static_cast<float>(static_cast<int>(u & 0xFu) - 8), a0);
          a1 = fmaf(w, static_cast<float>(static_cast<int>(u >> 4) - 8), a1);
        } else {
          a0 = fmaf(w, static_cast<float>(static_cast<int8_t>(u)), a0);
        }
      }
      acc[i][0] = a0;
      acc[i][1] = a1;
    }
    __syncthreads();  // sc is rewritten by the next tile
  }

  const float l = l_run;
  const float inv = l > 0.f ? 1.f / l : 0.f;
  float* o = out + (static_cast<size_t>(b) * H + h) * D;
#pragma unroll
  for (int i = 0; i < kMaxCols; ++i) {
    const int c = tid + i * kThreads;
    if (c >= Dp) continue;
    o[c] = acc[i][0] * inv;
    if (PACKED4) o[c + Dp] = acc[i][1] * inv;
  }
}

}  // namespace

extern "C" int decode_attention_launch(const void* q, const void* kq,
                                       const void* ks, const void* vq,
                                       const void* vs, const void* n_past,
                                       const void* slopes, void* out,
                                       int packed4, int il, int B, int H,
                                       int S, int D, float scale,
                                       void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(H, B);
  const size_t smem = static_cast<size_t>(D) * sizeof(float);
  auto qp = static_cast<const uint16_t*>(q);
  auto kp = static_cast<const uint8_t*>(kq);
  auto ksp = static_cast<const uint16_t*>(ks);
  auto vp = static_cast<const uint8_t*>(vq);
  auto vsp = static_cast<const uint16_t*>(vs);
  auto np = static_cast<const int*>(n_past);
  auto sl = static_cast<const float*>(slopes);
  auto op = static_cast<float*>(out);
  if (packed4)
    decode_attn_kernel<true><<<grid, kThreads, smem, st>>>(
        qp, kp, ksp, vp, vsp, np, sl, op, il, B, H, S, D, scale);
  else
    decode_attn_kernel<false><<<grid, kThreads, smem, st>>>(
        qp, kp, ksp, vp, vsp, np, sl, op, il, B, H, S, D, scale);
  return static_cast<int>(cudaGetLastError());
}
