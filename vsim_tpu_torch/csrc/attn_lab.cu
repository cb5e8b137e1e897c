// K16 attn_lab: the attention lab's decode attention over one layer of an
// int8 KV cache, one query per (b, h).
//
// Replaces tools/attn_lab.py:variant_call (:159) with its two bodies,
// _k_vpu3d (:41) and _k_mxu (:86).  q [B, H, D] bf16 attends layer *il
// (an int32 on the device, clamped to [0, L)) of k_q, v_q [L, B, H, S, D]
// int8 with bf16 scales [L, B, H, S], keys s <= n_past[b] (per row, on the
// device), out [B, H, D] f32:
//   score[s] = (q . k_int[s]) * ks[s] * scale
//   online softmax over tiles of ts = min(128, S) keys, in order, as the
//   body's sequential grid walks them: m, l, acc in f32; a tile past
//   n_past[b] is skipped; out = acc * (1 / l), 0 where l = 0
//   vpu3d: acc += sum_s (p[s] vs[s]) v_int[s]            (all f32)
//   mxu:   acc += sum_s bf16(p[s] vs[s]) v_int[s]        (p vs rounded)
// mxu's scores are the exact dot rounded once to f32: the bf16 x int8
// products are exact, and their f64 sums are exact in any order while q's
// nonzero elements span at most 2^30 in magnitude.  Its plain version sums
// in f64 too, so both compute the same p vs bit for bit: an f32 score that
// hangs on the order of its sums can move p by an ulp and so flip one
// bf16(p vs) by a whole bf16 step, far more than the sums' own noise.
// The mxu body's products of bf16 q and int8 keys, and of bf16(p vs) and
// int8 values, are exact in f32, so FMAs compute its function too; one
// query row a head leaves the tensor cores nothing to do.  vpu3d is the
// function of K3's int8 mode (csrc/decode_attention.cu).  The TPU kernel's
// unused ALiBi input is dropped.
//
// Bound on the H100: bytes, the cache rows up to n_past (2 (D + 2) bytes a
// key a head).  Design: one block per (b, h) walks its tiles in order, as
// the TPU grid does, because mxu's rounding of p vs depends on the running
// max of the tiles before: a split of S (K3's design) would round at other
// maxima.  A tile: each of 8 warps takes 4 keys at a time, their rows'
// 4-byte words loaded first (D <= 256: at most two a lane), dots reduced by
// shuffles; every warp then folds the tile's scores into the same m and l;
// warp 0 writes p vs (rounded for mxu) to shared memory; the value pass
// gives each thread one 4-byte column chunk of every R-th key (R = 256 /
// (D/4) row groups), four rows' loads first, and the row groups are summed
// in order at the end.  Deterministic: no atomics.  Parallelism is B x H
// blocks (512 at the lab's default GPT-J B=32, 40 at Pythia-12B B=1).

#include "common.cuh"

namespace {

// the bodies, in the order of vsim_tpu_torch/ops/attn_lab.py:ATTN_VARIANTS
enum AttnMath { kVpu3d, kMxu };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;   // the body's block_s
constexpr int kKeyUnroll = 4;
constexpr int kMaxWords = 2;  // 4-byte words of a key row a lane (D <= 256)

__device__ __forceinline__ float i8(uint32_t w, int e) {
  return static_cast<float>(static_cast<int8_t>((w >> (8 * e)) & 0xFFu));
}

__device__ __forceinline__ double warp_sum_f64(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int MATH>
__global__ void __launch_bounds__(kThreads)
attn_lab_kernel(const uint16_t* __restrict__ q,    // [B, H, D] bf16
                const int8_t* __restrict__ kq,     // [L, B, H, S, D]
                const uint16_t* __restrict__ ks,   // [L, B, H, S] bf16
                const int8_t* __restrict__ vq,
                const uint16_t* __restrict__ vs,
                const int* __restrict__ il_ptr,    // the layer, one int32
                const int* __restrict__ n_past,    // [B]
                float* __restrict__ out,           // [B, H, D]
                int L, int B, int H, int S, int D, float scale) {
  extern __shared__ float sm[];  // q_s [D], then red [R][D]
  __shared__ float sc[kTile], pw[kTile];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int DW = D / 4;              // 4-byte words a row
  const int R = kThreads / DW;       // row groups of the value pass
  const int cw = tid % DW, rg = tid / DW;
  const bool vthr = rg < R;
  const int il = min(max(*il_ptr, 0), L - 1);
  const size_t bh = (static_cast<size_t>(il) * B + b) * H + h;
  const uint32_t* kbase = reinterpret_cast<const uint32_t*>(kq + bh * S * D);
  const uint32_t* vbase = reinterpret_cast<const uint32_t*>(vq + bh * S * D);
  const uint16_t* ksb = ks + bh * S;
  const uint16_t* vsb = vs + bh * S;
  const int np = n_past[b];
  const int ts = min(kTile, S);

  float* q_s = sm;
  for (int d = tid; d < D; d += kThreads)
    q_s[d] = bf16_to_float(q[(static_cast<size_t>(b) * H + h) * D + d]);
  __syncthreads();
  float ql[kMaxWords][4];
#pragma unroll
  for (int w = 0; w < kMaxWords; ++w)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int wv = lane + 32 * w;
      ql[w][e] = wv < DW ? q_s[4 * wv + e] : 0.f;
    }

  float m_run = VSIM_NEG_INF, l_run = 0.f;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s0 = 0; s0 < S && s0 <= np; s0 += ts) {
    const int ns = min(ts, S - s0);
    // scores: warp w takes keys [4 w + 32 i, 4 w + 32 i + 4), loads first
    for (int t0 = warp * kKeyUnroll; t0 < ns; t0 += kWarps * kKeyUnroll) {
      uint32_t kw[kKeyUnroll][kMaxWords];
#pragma unroll
      for (int u = 0; u < kKeyUnroll; ++u)
#pragma unroll
        for (int w = 0; w < kMaxWords; ++w) {
          const int wv = lane + 32 * w;
          kw[u][w] = t0 + u < ns && wv < DW
                         ? __ldg(kbase + static_cast<size_t>(s0 + t0 + u) * DW + wv)
                         : 0u;
        }
#pragma unroll
      for (int u = 0; u < kKeyUnroll; ++u) {
        float dot = 0.f;
        if constexpr (MATH == kMxu) {
          // the exact dot rounded once: its terms are exact, and so are
          // their f64 sums, so no order of the sums changes a score
          double d = 0.0;
#pragma unroll
          for (int w = 0; w < kMaxWords; ++w)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              d = __fma_rn(static_cast<double>(ql[w][e]),
                           static_cast<double>(i8(kw[u][w], e)), d);
          dot = static_cast<float>(warp_sum_f64(d));
        } else {
#pragma unroll
          for (int w = 0; w < kMaxWords; ++w)
#pragma unroll
            for (int e = 0; e < 4; ++e) dot = fmaf(ql[w][e], i8(kw[u][w], e), dot);
          dot = warp_sum(dot);
        }
        if (lane == 0 && t0 + u < ns) sc[t0 + u] = dot;
      }
    }
    __syncthreads();
    // every warp folds the tile (four scores a lane) into the same m and l
    float v[kTile / 32], p[kTile / 32];
    float mx = VSIM_NEG_INF;
#pragma unroll
    for (int j = 0; j < kTile / 32; ++j) {
      const int t = lane + 32 * j;
      v[j] = t < ns && s0 + t <= np
                 ? sc[t] * bf16_to_float(ksb[s0 + t]) * scale : VSIM_NEG_INF;
      mx = fmaxf(mx, v[j]);
    }
    const float m_new = fmaxf(m_run, warp_max(mx));
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kTile / 32; ++j) {
      p[j] = v[j] == VSIM_NEG_INF ? 0.f : expf(v[j] - m_new);
      psum += p[j];
    }
    const float alpha = m_run == VSIM_NEG_INF ? 0.f : expf(m_run - m_new);
    l_run = alpha * l_run + warp_sum(psum);
    m_run = m_new;
    if (warp == 0) {
#pragma unroll
      for (int j = 0; j < kTile / 32; ++j) {
        const int t = lane + 32 * j;
        if (t < ns) {
          const float w = __fmul_rn(p[j], bf16_to_float(vsb[s0 + t]));
          pw[t] = MATH == kMxu ? round_bf16(w) : w;
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] *= alpha;
    __syncthreads();
    if (vthr) {
      for (int t = rg; t < ns; t += kKeyUnroll * R) {
        uint32_t vw[kKeyUnroll];
#pragma unroll
        for (int u = 0; u < kKeyUnroll; ++u)
          vw[u] = t + u * R < ns
                      ? __ldg(vbase + static_cast<size_t>(s0 + t + u * R) * DW + cw)
                      : 0u;
#pragma unroll
        for (int u = 0; u < kKeyUnroll; ++u) {
          if (t + u * R < ns) {
            const float w = pw[t + u * R];
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[e] = fmaf(w, i8(vw[u], e), acc[e]);
          }
        }
      }
    }
    // no barrier here: the next tile writes sc before its first barrier and
    // pw after it, and every warp has read sc (the fold) and is past the
    // last barrier before any warp gets there
  }

  // sum the row groups in order
  float* red = sm + D;  // [R][D]
  if (vthr) {
#pragma unroll
    for (int e = 0; e < 4; ++e) red[rg * D + 4 * cw + e] = acc[e];
  }
  __syncthreads();
  const float inv = l_run > 0.f ? 1.f / l_run : 0.f;
  for (int d = tid; d < D; d += kThreads) {
    float s = 0.f;
    for (int r = 0; r < R; ++r) s += red[r * D + d];
    out[(static_cast<size_t>(b) * H + h) * D + d] = s * inv;
  }
}

template <int MATH>
void launch_t(const void* q, const void* kq, const void* ks, const void* vq,
              const void* vs, const void* il, const void* n_past, void* out,
              int L, int B, int H, int S, int D, float scale, cudaStream_t st) {
  const int R = kThreads / (D / 4);
  const size_t smem = sizeof(float) * static_cast<size_t>(D) * (1 + R);
  attn_lab_kernel<MATH><<<dim3(H, B), kThreads, smem, st>>>(
      static_cast<const uint16_t*>(q), static_cast<const int8_t*>(kq),
      static_cast<const uint16_t*>(ks), static_cast<const int8_t*>(vq),
      static_cast<const uint16_t*>(vs), static_cast<const int*>(il),
      static_cast<const int*>(n_past), static_cast<float*>(out), L, B, H, S,
      D, scale);
}

}  // namespace

// math: the index in ATTN_VARIANTS; D % 4 == 0, 4 <= D <= 256, the caches
// 4-byte aligned; il one int32 on the device, n_past [B] int32.
extern "C" int attn_lab_launch(const void* q, const void* kq, const void* ks,
                               const void* vq, const void* vs, const void* il,
                               const void* n_past, void* out, int L, int B,
                               int H, int S, int D, float scale, int math,
                               void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (L < 1 || B < 1 || H < 1 || S < 1 || D < 4 || D % 4 ||
      D > 4 * 32 * kMaxWords || math < kVpu3d || math > kMxu ||
      il == nullptr || n_past == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (math == kMxu)
    launch_t<kMxu>(q, kq, ks, vq, vs, il, n_past, out, L, B, H, S, D, scale, st);
  else
    launch_t<kVpu3d>(q, kq, ks, vq, vs, il, n_past, out, L, B, H, S, D, scale, st);
  return static_cast<int>(cudaGetLastError());
}
