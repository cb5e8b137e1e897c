// K3 decode_attention_q and K5 decode_attention_fresh: single-token attention
// over one layer of the stacked quantized KV cache, per-row horizon n_past[b].
//
// Replace vsim_tpu/ops/decode_attention.py:_kernel (:82) in its two modes.
// K3, non-fresh: the cache already holds this step's row.  K5, fresh (the
// ragged serving step, which defers the cache write): the cache holds rows
// s < n_past[b] only, and this step's own row arrives quantized beside it
// (knq/vnq [B, H, Dp], kns/vns [B, H] bf16); the combine dequantizes it
// through the same round trip as the cache write and merges it into the
// softmax, with its ALiBi term at position n_past[b].  Same numerics:
//   score[s] = (q . k_int[s]) * ks[s] * scale (+ slope_h * s),
//              s <= n_past[b] (K3) or s < n_past[b] (K5), s < S
//   out      = sum_s p[s] vs[s] v_int[s] / sum_s p[s]   (online softmax, f32)
// with q bf16 (rounded by the wrapper, as the JAX wrapper does) or f32 (the
// QF32 instances: the reference's einsum route, taken where D % 128 != 0,
// leaves q unrounded; the wrapper's round_q says which), int8 values,
// or int4 plane-packed bytes (byte c holds dims c | c + D/2, value nibble - 8),
// and one bf16 scale per (token, head).
//
// Bound on the H100: bytes, the cache rows up to n_past (2 (Dp + 2) bytes a
// key per head).  The layer is read in place from the stacked [L, B, H, S, Dp]
// cache through il (no copy), and keys past n_past[b] are never read, so
// traffic follows each row's own length.
//
// Both modes are split-S (flash-decoding), one template on FRESH, sharing
// pass 1 and the combine.  One block per (b, h) is 16 blocks on 132 SMs at
// GPT-J B=1 (128 at B=8, with rows up to 2048 keys long), so the keys of
// each (b, h) are cut into splits of c keys (a multiple of the 64-key tile,
// chosen by the wrapper from the shapes alone, so the call makes no host
// sync).  Pass 1, grid (split, h, b), 256 threads:
// a block reads its keys [split c, min(split c + c, n_keys)) in tiles of 64.
// Key rows are read W bytes a lane (16 where Dp allows: an int8 D=256 row is
// 16 lanes, an int4 D=128 row 4), q is held in registers against each lane's
// columns, and the dot is reduced by shuffles inside the key's lane group.
// Every warp folds the tile into the running max and sum itself (64 scores,
// two per lane), so no warp waits on another's serial loop.  The value pass
// reads W bytes a thread: thread (row group rg, chunk cc) owns columns
// [cc W, cc W + W) of keys rg, rg + RG, ....  A tile's value rows and its
// key and value scales are all loaded before the score pass, so a tile
// waits on memory once, and it takes two barriers.  Row groups are summed
// through shared memory at the end, and the block writes f32 partials
// (m, l, acc[D]) to a scratch [B, H, splits, D + 2]; an empty range writes
// m = -FLT_MAX, l = 0.  Pass 2
// (combine), one block per (b, h), merges the splits in index order:
// M = max m_i, L = sum l_i e^(m_i - M), out = sum acc_i e^(m_i - M) / L, and
// 0 where L = 0.  No atomics: the output is the same from run to run.
//
// Under FRESH (K5) pass 1 reads rows s < min(n_past[b], S), never row S: the
// serving sentinel n_past = S (an inactive slot) attends all S rows and its
// output is dropped.  The combine then computes the fresh row's score
// s_new = (q . knq) kns scale + slope n_past[b] (a block sum over D) and
// merges it after the splits, in that fixed order: M = max(m_i, s_new),
// L = sum l_i e^(m_i - M) + e^(s_new - M), its value row vns vnq weighted by
// e^(s_new - M).  With n_past[b] = 0 every split is empty and the fresh row
// alone has weight 1, never a NaN.

#include "common.cuh"

namespace {

constexpr int kSplitThreads = 256;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kSplitTile = 64;  // keys per tile (csrc contract with the plan)
// two blocks an SM (<= 128 registers a thread) hide the loads' latency
// better than one block with more loads in flight
constexpr int kSplitMinBlocks = 2;

// W bytes at p (W-aligned) into words; byte i is (w[i / 4] >> 8 (i % 4)).
template <int W>
__device__ __forceinline__ void load_chunk(const uint8_t* p,
                                           uint32_t (&w)[(W + 3) / 4]) {
  if constexpr (W == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = u.x;
    w[1] = u.y;
    w[2] = u.z;
    w[3] = u.w;
  } else if constexpr (W == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = u.x;
    w[1] = u.y;
  } else if constexpr (W == 4) {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (W == 2) {
    w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else {
    w[0] = __ldg(p);
  }
}

template <int W>
__device__ __forceinline__ uint32_t chunk_byte(const uint32_t (&w)[(W + 3) / 4],
                                               int i) {
  return (w[i / 4] >> (8 * (i % 4))) & 0xFFu;
}

__device__ __forceinline__ float lo_nibble(uint32_t u) {
  return static_cast<float>(static_cast<int>(u & 0xFu) - 8);
}
__device__ __forceinline__ float hi_nibble(uint32_t u) {
  return static_cast<float>(static_cast<int>(u >> 4) - 8);
}
__device__ __forceinline__ float int8_val(uint32_t u) {
  return static_cast<float>(static_cast<int8_t>(u));
}

// q[i] as f32: f32 q as is (QF32), else bf16 bits widened
template <bool QF32>
__device__ __forceinline__ float q_at(const void* q, size_t i) {
  if constexpr (QF32) return static_cast<const float*>(q)[i];
  else return bf16_to_float(static_cast<const uint16_t*>(q)[i]);
}

// Pass 1.  W: the load width in bytes (16 unless Dp or an address forbids);
// U: the row loads a thread keeps in flight in each pass (4 where a key
// takes 16 lanes, as an int8 D=256 row does, so that a 64-key tile is one
// round of key loads and one of value loads; else 2).  QF32: q is f32.
template <bool FRESH, bool PACKED4, int W, int U, bool QF32>
__global__ void __launch_bounds__(kSplitThreads, kSplitMinBlocks)
decode_split_kernel(const void* __restrict__ q,        // [B, H, D] bf16 or f32
                    const uint8_t* __restrict__ kq,    // [L, B, H, S, Dp]
                    const uint16_t* __restrict__ ks,   // [L, B, H, S] bf16
                    const uint8_t* __restrict__ vq,
                    const uint16_t* __restrict__ vs,
                    const int* __restrict__ n_past,    // [B]
                    const float* __restrict__ slopes,  // [H] or null
                    float* __restrict__ part,          // [B, H, splits, D + 2]
                    int il, int B, int H, int S, int D, int c, float scale) {
  constexpr int WW = (W + 3) / 4;
  constexpr int CPL = 16 / W;  // chunks a lane may own in the score pass
  constexpr int NV = PACKED4 ? 2 : 1;
  constexpr int kUnroll = U;
  extern __shared__ float sm[];  // q_s [D], then red [RG][D]
  __shared__ float sc[kSplitTile], pw[kSplitTile];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int Dp = PACKED4 ? D / 2 : D;
  const int cpr = Dp / W;  // chunks per row (<= 256)
  int G = 1;               // lanes per key in the score pass
  while (G < cpr && G < 32) G <<= 1;
  const int kpw = 32 / G, lig = lane % G, kw = lane / G;
  const int RG = kSplitThreads / cpr;  // row groups of the value pass
  const int cc = tid % cpr, rg = tid / cpr;
  const bool vthr = rg < RG;

  const int np = n_past[b];
  const int n_keys = max(0, min(FRESH ? np : np + 1, S));
  const int k0 = split * c, k1 = min(k0 + c, n_keys);
  float* pout = part + ((static_cast<size_t>(b) * H + h) * n_split + split) * (D + 2);
  if (k0 >= k1) {
    if (tid == 0) {
      pout[0] = VSIM_NEG_INF;
      pout[1] = 0.f;
    }
    return;
  }
  const size_t bh = (static_cast<size_t>(il) * B + b) * H + h;
  const uint8_t* kbase = kq + bh * S * Dp;
  const uint8_t* vbase = vq + bh * S * Dp;
  const uint16_t* ksb = ks + bh * S;
  const uint16_t* vsb = vs + bh * S;
  const float slope = slopes ? slopes[h] : 0.f;

  float* q_s = sm;
  for (int d = tid; d < D; d += kSplitThreads)
    q_s[d] = q_at<QF32>(q, (static_cast<size_t>(b) * H + h) * D + d);
  __syncthreads();
  float ql[CPL][W], qh[PACKED4 ? CPL : 1][W];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int ch = lig + i * G;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const int col = ch * W + j;
      ql[i][j] = ch < cpr ? q_s[col] : 0.f;
      if (PACKED4) qh[PACKED4 ? i : 0][j] = ch < cpr ? q_s[col + Dp] : 0.f;
    }
  }

  float m_run = VSIM_NEG_INF, l_run = 0.f;
  float acc[NV][W];
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int j = 0; j < W; ++j) acc[n][j] = 0.f;

  for (int s0 = k0; s0 < k1; s0 += kSplitTile) {
    const int ns = min(kSplitTile, k1 - s0);
    // the tile's scales (two keys a lane, in every warp) and the value
    // pass's first loads, in flight during the score pass
    const float ks0 = lane < ns ? bf16_to_float(ksb[s0 + lane]) : 0.f;
    const float ks1 = lane + 32 < ns ? bf16_to_float(ksb[s0 + lane + 32]) : 0.f;
    const float vs0 = lane < ns ? bf16_to_float(vsb[s0 + lane]) : 0.f;
    const float vs1 = lane + 32 < ns ? bf16_to_float(vsb[s0 + lane + 32]) : 0.f;
    uint32_t vraw[kUnroll][WW];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = rg + u * RG;
      if (vthr && j < ns)
        load_chunk<W>(vbase + static_cast<size_t>(s0 + j) * Dp + cc * W, vraw[u]);
    }
    // scores: warp rounds of kUnroll key steps, loads first; every lane of
    // a warp runs the same trip count, so the shuffles see the whole warp
    for (int jb = warp * kpw; jb < ns; jb += kUnroll * kSplitWarps * kpw) {
      uint32_t kraw[kUnroll][CPL][WW];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = jb + u * kSplitWarps * kpw + kw;
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          const int ch = lig + i * G;
          if (j < ns && ch < cpr)
            load_chunk<W>(kbase + static_cast<size_t>(s0 + j) * Dp + ch * W,
                          kraw[u][i]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = jb + u * kSplitWarps * kpw + kw;
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          if (j < ns && lig + i * G < cpr) {
#pragma unroll
            for (int e = 0; e < W; ++e) {
              const uint32_t by = chunk_byte<W>(kraw[u][i], e);
              if (PACKED4) {
                dot = fmaf(ql[i][e], lo_nibble(by), dot);
                dot = fmaf(qh[PACKED4 ? i : 0][e], hi_nibble(by), dot);
              } else {
                dot = fmaf(ql[i][e], int8_val(by), dot);
              }
            }
          }
        }
        for (int off = G / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (j < ns && lig == 0) sc[j] = dot;
      }
    }
    __syncthreads();
    // every warp folds the tile (two scores a lane) into the same m and l
    const float v0 = lane < ns ? sc[lane] * ks0 * scale
                                     + slope * static_cast<float>(s0 + lane)
                               : VSIM_NEG_INF;
    const float v1 = lane + 32 < ns ? sc[lane + 32] * ks1 * scale
                                          + slope * static_cast<float>(s0 + lane + 32)
                                    : VSIM_NEG_INF;
    const float m_new = fmaxf(m_run, warp_max(fmaxf(v0, v1)));
    const float p0 = lane < ns ? expf(v0 - m_new) : 0.f;
    const float p1 = lane + 32 < ns ? expf(v1 - m_new) : 0.f;
    const float alpha = m_run == VSIM_NEG_INF ? 0.f : expf(m_run - m_new);
    l_run = alpha * l_run + warp_sum(p0 + p1);
    m_run = m_new;
    if (warp == 0) {
      if (lane < ns) pw[lane] = p0 * vs0;
      if (lane + 32 < ns) pw[lane + 32] = p1 * vs1;
    }
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < W; ++e) acc[n][e] *= alpha;
    __syncthreads();
    if (vthr) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = rg + u * RG;
        if (j < ns) {
          const float wgt = pw[j];
#pragma unroll
          for (int e = 0; e < W; ++e) {
            const uint32_t by = chunk_byte<W>(vraw[u], e);
            if (PACKED4) {
              acc[0][e] = fmaf(wgt, lo_nibble(by), acc[0][e]);
              acc[NV - 1][e] = fmaf(wgt, hi_nibble(by), acc[NV - 1][e]);
            } else {
              acc[0][e] = fmaf(wgt, int8_val(by), acc[0][e]);
            }
          }
        }
      }
      for (int j = rg + kUnroll * RG; j < ns; j += RG) {  // rows left
        uint32_t w[WW];
        load_chunk<W>(vbase + static_cast<size_t>(s0 + j) * Dp + cc * W, w);
        const float wgt = pw[j];
#pragma unroll
        for (int e = 0; e < W; ++e) {
          const uint32_t by = chunk_byte<W>(w, e);
          if (PACKED4) {
            acc[0][e] = fmaf(wgt, lo_nibble(by), acc[0][e]);
            acc[NV - 1][e] = fmaf(wgt, hi_nibble(by), acc[NV - 1][e]);
          } else {
            acc[0][e] = fmaf(wgt, int8_val(by), acc[0][e]);
          }
        }
      }
    }
    // no barrier here: the next tile writes sc before its first barrier and
    // pw after it, and every warp has read sc (softmax) and is past the last
    // barrier before any warp gets there
  }

  // sum the row groups in order
  float* red = sm + D;  // [RG][D]
  if (vthr) {
#pragma unroll
    for (int e = 0; e < W; ++e) {
      red[rg * D + cc * W + e] = acc[0][e];
      if (PACKED4) red[rg * D + cc * W + e + Dp] = acc[NV - 1][e];
    }
  }
  __syncthreads();
  for (int d = tid; d < D; d += kSplitThreads) {
    float s = 0.f;
    for (int r = 0; r < RG; ++r) s += red[r * D + d];
    pout[2 + d] = s;
  }
  if (tid == 0) {
    pout[0] = m_run;
    pout[1] = l_run;
  }
}

// K5's own row for the combine: q [B, H, D] (bf16, or f32 under QF32),
// knq/vnq [B, H, Dp], kns/vns [B, H] bf16 (all null for K3).
struct FreshRow {
  const void* q;
  const uint8_t* knq;
  const uint16_t* kns;
  const uint8_t* vnq;
  const uint16_t* vns;
};

constexpr int kCombineThreads = 128;

// Pass 2: merge the splits of one (b, h) in index order, then (FRESH) the
// fresh row.
template <bool FRESH, bool PACKED4, bool QF32>
__global__ void __launch_bounds__(kCombineThreads)
decode_combine_kernel(const float* __restrict__ part, float* __restrict__ out,
                      FreshRow fr, const int* __restrict__ n_past,
                      const float* __restrict__ slopes, int H, int D,
                      int n_split, float scale) {
  extern __shared__ float wgt[];  // [n_split]
  __shared__ float L_s, red[kCombineThreads / 32];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int Dp = PACKED4 ? D / 2 : D;
  const size_t row = static_cast<size_t>(b) * H + h;
  const float* p = part + row * n_split * (D + 2);
  float s_new = VSIM_NEG_INF;
  if (FRESH) {  // q . knq over D: a block sum in warp order
    const size_t qr = row * D;
    const uint8_t* kr = fr.knq + row * Dp;
    float dot = 0.f;
    for (int c = tid; c < Dp; c += kCombineThreads) {
      const uint32_t u = kr[c];
      if (PACKED4) {
        dot = fmaf(q_at<QF32>(fr.q, qr + c), lo_nibble(u), dot);
        dot = fmaf(q_at<QF32>(fr.q, qr + c + Dp), hi_nibble(u), dot);
      } else {
        dot = fmaf(q_at<QF32>(fr.q, qr + c), int8_val(u), dot);
      }
    }
    dot = warp_sum(dot);
    if (tid % 32 == 0) red[tid / 32] = dot;
    __syncthreads();
    dot = 0.f;
#pragma unroll
    for (int w = 0; w < kCombineThreads / 32; ++w) dot += red[w];
    s_new = dot * bf16_to_float(fr.kns[row]) * scale
            + (slopes ? slopes[h] : 0.f) * static_cast<float>(n_past[b]);
  }
  float M = s_new;
  for (int i = 0; i < n_split; ++i)
    if (p[i * (D + 2) + 1] > 0.f) M = fmaxf(M, p[i * (D + 2)]);
  for (int i = tid; i < n_split; i += kCombineThreads) {
    const float l = p[i * (D + 2) + 1];
    wgt[i] = l > 0.f ? expf(p[i * (D + 2)] - M) : 0.f;
  }
  const float p_new = FRESH ? expf(s_new - M) : 0.f;
  __syncthreads();
  if (tid == 0) {
    float L = 0.f;
    for (int i = 0; i < n_split; ++i)
      if (wgt[i] > 0.f) L += p[i * (D + 2) + 1] * wgt[i];
    L_s = L + p_new;
  }
  __syncthreads();
  const float L = L_s;
  const float pv = FRESH ? p_new * bf16_to_float(fr.vns[row]) : 0.f;
  for (int d = tid; d < D; d += kCombineThreads) {
    float s = 0.f;
    for (int i = 0; i < n_split; ++i)
      if (wgt[i] > 0.f) s = fmaf(p[i * (D + 2) + 2 + d], wgt[i], s);
    if (FRESH) {
      float v;
      if (PACKED4) {
        const uint32_t u = fr.vnq[row * Dp + (d < Dp ? d : d - Dp)];
        v = d < Dp ? lo_nibble(u) : hi_nibble(u);
      } else {
        v = int8_val(fr.vnq[row * Dp + d]);
      }
      s = fmaf(pv, v, s);
    }
    out[row * D + d] = L > 0.f ? s / L : 0.f;
  }
}

template <bool FRESH, bool PACKED4, bool QF32, int W, int U>
cudaError_t launch_w(const void* q, const void* kq, const void* ks,
                     const void* vq, const void* vs, const int* np,
                     const float* sl, float* part, int il, int B, int H, int S,
                     int D, int c, int n_split, float scale, cudaStream_t st) {
  const int Dp = PACKED4 ? D / 2 : D;
  const int RG = kSplitThreads / (Dp / W);
  const size_t smem = sizeof(float) * static_cast<size_t>(D) * (1 + RG);
  auto kern = decode_split_kernel<FRESH, PACKED4, W, U, QF32>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kern<<<dim3(n_split, H, B), kSplitThreads, smem, st>>>(
      q, static_cast<const uint8_t*>(kq),
      static_cast<const uint16_t*>(ks), static_cast<const uint8_t*>(vq),
      static_cast<const uint16_t*>(vs), np, sl, part, il, B, H, S, D, c, scale);
  return cudaGetLastError();
}

// Pass 1 at load width W, then the combine.
template <bool FRESH, bool PACKED4, bool QF32>
cudaError_t launch_mode(int W, const void* q, const void* kq, const void* ks,
                        const void* vq, const void* vs, const int* np,
                        const float* sl, FreshRow fr, float* part, float* out,
                        int il, int B, int H, int S, int D, int c, int n_split,
                        float scale, cudaStream_t st) {
  cudaError_t err;
  const bool wide = (PACKED4 ? D / 2 : D) / W > 8;  // a key takes 16+ lanes
  switch (W) {
    case 16: err = wide ? launch_w<FRESH, PACKED4, QF32, 16, 4>(q, kq, ks, vq, vs, np, sl, part, il, B, H, S, D, c, n_split, scale, st)
                        : launch_w<FRESH, PACKED4, QF32, 16, 2>(q, kq, ks, vq, vs, np, sl, part, il, B, H, S, D, c, n_split, scale, st); break;
    case 8: err = wide ? launch_w<FRESH, PACKED4, QF32, 8, 4>(q, kq, ks, vq, vs, np, sl, part, il, B, H, S, D, c, n_split, scale, st)
                       : launch_w<FRESH, PACKED4, QF32, 8, 2>(q, kq, ks, vq, vs, np, sl, part, il, B, H, S, D, c, n_split, scale, st); break;
    case 4: err = launch_w<FRESH, PACKED4, QF32, 4, 2>(q, kq, ks, vq, vs, np, sl, part, il, B, H, S, D, c, n_split, scale, st); break;
    case 2: err = launch_w<FRESH, PACKED4, QF32, 2, 2>(q, kq, ks, vq, vs, np, sl, part, il, B, H, S, D, c, n_split, scale, st); break;
    case 1: err = launch_w<FRESH, PACKED4, QF32, 1, 2>(q, kq, ks, vq, vs, np, sl, part, il, B, H, S, D, c, n_split, scale, st); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  decode_combine_kernel<FRESH, PACKED4, QF32>
      <<<dim3(H, B), kCombineThreads, sizeof(float) * n_split, st>>>(
          part, out, fr, np, sl, H, D, n_split, scale);
  return cudaGetLastError();
}

template <bool FRESH, bool PACKED4>
int launch_q(int q_f32, int W, const void* q, const void* kq, const void* ks,
             const void* vq, const void* vs, const int* np, const float* sl,
             FreshRow fr, float* part, float* out, int il, int B, int H, int S,
             int D, int c, int n_split, float scale, cudaStream_t st) {
  return static_cast<int>(
      q_f32 ? launch_mode<FRESH, PACKED4, true>(W, q, kq, ks, vq, vs, np, sl, fr, part, out, il, B, H, S, D, c, n_split, scale, st)
            : launch_mode<FRESH, PACKED4, false>(W, q, kq, ks, vq, vs, np, sl, fr, part, out, il, B, H, S, D, c, n_split, scale, st));
}

template <bool FRESH>
int launch(int packed4, int q_f32, int W, const void* q, const void* kq, const void* ks,
           const void* vq, const void* vs, const void* n_past,
           const void* slopes, FreshRow fr, void* part, void* out, int il,
           int B, int H, int S, int D, int c, int n_split, float scale,
           void* stream) {
  if (c % kSplitTile != 0 || n_split < 1 || static_cast<long long>(c) * n_split < S)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto np = static_cast<const int*>(n_past);
  auto sl = static_cast<const float*>(slopes);
  auto pp = static_cast<float*>(part);
  auto op = static_cast<float*>(out);
  return packed4 ? launch_q<FRESH, true>(q_f32, W, q, kq, ks, vq, vs, np, sl, fr, pp, op, il, B, H, S, D, c, n_split, scale, st)
                 : launch_q<FRESH, false>(q_f32, W, q, kq, ks, vq, vs, np, sl, fr, pp, op, il, B, H, S, D, c, n_split, scale, st);
}

}  // namespace

// Both modes: pass 1 over n_split splits of c keys into ``part``
// [B, H, n_split, D + 2], then the combine; W is the load width in bytes (it
// divides Dp and the cache's base addresses); q is f32 where q_f32, else bf16.
// K3: the cache already holds this step's row.
extern "C" int decode_attention_launch(const void* q, const void* kq,
                                       const void* ks, const void* vq,
                                       const void* vs, const void* n_past,
                                       const void* slopes, void* part,
                                       void* out, int packed4, int q_f32,
                                       int il, int B, int H, int S, int D,
                                       int c, int n_split, int W, float scale,
                                       void* stream) {
  return launch<false>(packed4, q_f32, W, q, kq, ks, vq, vs, n_past, slopes,
                       FreshRow{}, part, out, il, B, H, S, D, c, n_split,
                       scale, stream);
}

// K5: rows < n_past[b] from the cache, this step's row from knq/kns/vnq/vns.
extern "C" int decode_attention_fresh_launch(
    const void* q, const void* kq, const void* ks, const void* vq,
    const void* vs, const void* n_past, const void* slopes, const void* knq,
    const void* kns, const void* vnq, const void* vns, void* part, void* out,
    int packed4, int q_f32, int il, int B, int H, int S, int D, int c,
    int n_split, int W, float scale, void* stream) {
  const FreshRow fr{q,
                    static_cast<const uint8_t*>(knq),
                    static_cast<const uint16_t*>(kns),
                    static_cast<const uint8_t*>(vnq),
                    static_cast<const uint16_t*>(vns)};
  return launch<true>(packed4, q_f32, W, q, kq, ks, vq, vs, n_past, slopes, fr, part,
                      out, il, B, H, S, D, c, n_split, scale, stream);
}
