// K3 decode_attention_q and K5 decode_attention_fresh: single-token attention
// over one layer of the stacked quantized KV cache, per-row horizon n_past[b].
//
// Replace vsim_tpu/ops/decode_attention.py:_kernel (:82) in its two modes.
// K3, non-fresh: the cache already holds this step's row.  K5, fresh (the
// ragged serving step, which defers the cache write): the cache holds rows
// s < n_past[b] only, and this step's own row arrives quantized beside it
// (knq/vnq [B, H, Dp], kns/vns [B, H] bf16); the epilogue dequantizes it
// through the same round trip as the cache write and merges it into the
// online softmax, with its ALiBi term at position n_past[b].  Same numerics:
//   score[s] = (q . k_int[s]) * ks[s] * scale (+ slope_h * s),
//              s <= n_past[b] (K3) or s < n_past[b] (K5), s < S
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
// K5 reads min(n_past[b], S) rows, never row S: the serving sentinel
// n_past = S (an inactive slot) attends all S rows and its output is dropped.
// With n_past[b] = 0 only the fresh row counts: m stays -FLT_MAX, so its
// rescale factor is 0 and the fresh row's weight exp(0) = 1, never a NaN.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;   // keys per tile
constexpr int kMaxCols = 2; // packed columns per thread: Dp <= 512

template <bool PACKED4, bool FRESH>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const uint16_t* __restrict__ q,    // [B, H, D] bf16
                   const uint8_t* __restrict__ kq,    // [L, B, H, S, Dp]
                   const uint16_t* __restrict__ ks,   // [L, B, H, S] bf16
                   const uint8_t* __restrict__ vq,
                   const uint16_t* __restrict__ vs,
                   const int* __restrict__ n_past,    // [B]
                   const float* __restrict__ slopes,  // [H] or null
                   const uint8_t* __restrict__ knq,   // [B, H, Dp] (FRESH)
                   const uint16_t* __restrict__ kns,  // [B, H] bf16 (FRESH)
                   const uint8_t* __restrict__ vnq,
                   const uint16_t* __restrict__ vns,
                   float* __restrict__ out,           // [B, H, D]
                   int il, int B, int H, int S, int D, float scale) {
  extern __shared__ float q_s[];  // [D]
  __shared__ float sc[kTile];
  __shared__ float m_run, l_run, alpha_s;
  __shared__ float red[kWarps];
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
  const int np = n_past[b];
  const int n_keys = max(0, min(FRESH ? np : np + 1, S));

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

  float l = l_run;
  if (FRESH) {
    // this step's own row: its score needs the whole q . k, so a block sum
    const size_t row = static_cast<size_t>(b) * H + h;
    const uint8_t* krow = knq + row * Dp;
    const uint8_t* vrow = vnq + row * Dp;
    float part = 0.f;
    for (int c = tid; c < Dp; c += kThreads) {
      const uint32_t u = krow[c];
      if (PACKED4) {
        part = fmaf(q_s[c], static_cast<float>(static_cast<int>(u & 0xFu) - 8), part);
        part = fmaf(q_s[c + Dp], static_cast<float>(static_cast<int>(u >> 4) - 8), part);
      } else {
        part = fmaf(q_s[c], static_cast<float>(static_cast<int8_t>(u)), part);
      }
    }
    part = warp_sum(part);
    if (lane == 0) red[warp] = part;
    __syncthreads();
    float dot = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) dot += red[w];
    const float s_new = dot * bf16_to_float(kns[row]) * scale
                        + slope * static_cast<float>(np);
    const float m = m_run;
    const float m2 = fmaxf(m, s_new);
    const float a = m == VSIM_NEG_INF ? 0.f : expf(m - m2);
    const float p_new = expf(s_new - m2);
    l = a * l + p_new;
    const float pv = p_new * bf16_to_float(vns[row]);
#pragma unroll
    for (int i = 0; i < kMaxCols; ++i) {
      const int c = tid + i * kThreads;
      if (c >= Dp) continue;
      const uint32_t u = vrow[c];
      if (PACKED4) {
        acc[i][0] = fmaf(pv, static_cast<float>(static_cast<int>(u & 0xFu) - 8), acc[i][0] * a);
        acc[i][1] = fmaf(pv, static_cast<float>(static_cast<int>(u >> 4) - 8), acc[i][1] * a);
      } else {
        acc[i][0] = fmaf(pv, static_cast<float>(static_cast<int8_t>(u)), acc[i][0] * a);
      }
    }
  }
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

template <bool FRESH>
int launch(const void* q, const void* kq, const void* ks, const void* vq,
           const void* vs, const void* n_past, const void* slopes,
           const void* knq, const void* kns, const void* vnq, const void* vns,
           void* out, int packed4, int il, int B, int H, int S, int D,
           float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(H, B);
  const size_t smem = static_cast<size_t>(D) * sizeof(float);
  auto u8 = [](const void* p) { return static_cast<const uint8_t*>(p); };
  auto u16 = [](const void* p) { return static_cast<const uint16_t*>(p); };
  auto np = static_cast<const int*>(n_past);
  auto sl = static_cast<const float*>(slopes);
  auto op = static_cast<float*>(out);
  if (packed4)
    decode_attn_kernel<true, FRESH><<<grid, kThreads, smem, st>>>(
        u16(q), u8(kq), u16(ks), u8(vq), u16(vs), np, sl, u8(knq), u16(kns),
        u8(vnq), u16(vns), op, il, B, H, S, D, scale);
  else
    decode_attn_kernel<false, FRESH><<<grid, kThreads, smem, st>>>(
        u16(q), u8(kq), u16(ks), u8(vq), u16(vs), np, sl, u8(knq), u16(kns),
        u8(vnq), u16(vns), op, il, B, H, S, D, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K3: the cache already holds this step's row.
extern "C" int decode_attention_launch(const void* q, const void* kq,
                                       const void* ks, const void* vq,
                                       const void* vs, const void* n_past,
                                       const void* slopes, void* out,
                                       int packed4, int il, int B, int H,
                                       int S, int D, float scale,
                                       void* stream) {
  return launch<false>(q, kq, ks, vq, vs, n_past, slopes, nullptr, nullptr,
                       nullptr, nullptr, out, packed4, il, B, H, S, D, scale,
                       stream);
}

// K5: rows < n_past[b] from the cache, this step's row from knq/kns/vnq/vns.
extern "C" int decode_attention_fresh_launch(
    const void* q, const void* kq, const void* ks, const void* vq,
    const void* vs, const void* n_past, const void* slopes, const void* knq,
    const void* kns, const void* vnq, const void* vns, void* out, int packed4,
    int il, int B, int H, int S, int D, float scale, void* stream) {
  return launch<true>(q, kq, ks, vq, vs, n_past, slopes, knq, kns, vnq, vns,
                      out, packed4, il, B, H, S, D, scale, stream);
}
