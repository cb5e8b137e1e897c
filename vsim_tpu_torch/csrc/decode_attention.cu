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
// traffic follows each row's own length.
//
// K3 is split-S (flash-decoding): one block per (b, h) is 16 blocks on 132
// SMs at GPT-J B=1, so the keys of each (b, h) are cut into splits of c keys
// (a multiple of the 64-key tile, chosen by the wrapper from the shapes alone,
// so the call makes no host sync).  Pass 1, grid (split, h, b), 256 threads:
// a block reads its keys [split c, min(split c + c, n_keys)) in tiles of 64.
// Key rows are read W bytes a lane (16 where Dp allows: an int8 D=256 row is
// 16 lanes, an int4 D=128 row 4), q is held in registers against each lane's
// columns, and the dot is reduced by shuffles inside the key's lane group.
// Every warp folds the tile into the running max and sum itself (64 scores,
// two per lane), so no warp waits on another's serial loop.  The value pass
// reads W bytes a thread: thread (row group rg, chunk cc) owns columns
// [cc W, cc W + W) of keys rg, rg + RG, ..., and its first loads are issued
// before the score pass.  Row groups are summed through shared memory at the
// end, and the block writes f32 partials (m, l, acc[D]) to a scratch
// [B, H, splits, D + 2]; an empty range writes m = -FLT_MAX, l = 0.  Pass 2
// (combine), one block per (b, h), merges the splits in index order:
// M = max m_i, L = sum l_i e^(m_i - M), out = sum acc_i e^(m_i - M) / L, and
// 0 where L = 0.  No atomics: the output is the same from run to run.
//
// K5 keeps the one-block design: one block per (b, h) walks its keys in tiles
// of 64; each warp dots whole key rows against q in shared memory, warp 0
// folds the tile into the running max / denominator, then every thread
// accumulates its own value columns (split-S for it is the next target).
// K5 reads min(n_past[b], S) rows, never row S: the serving sentinel
// n_past = S (an inactive slot) attends all S rows and its output is dropped.
// With n_past[b] = 0 only the fresh row counts: m stays -FLT_MAX, so its
// rescale factor is 0 and the fresh row's weight exp(0) = 1, never a NaN.

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// K3: split-S
// ---------------------------------------------------------------------------

constexpr int kSplitThreads = 256;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kSplitTile = 64;  // keys per tile (csrc contract with the plan)
constexpr int kUnroll = 2;      // loads a thread keeps in flight
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

// Pass 1.  W: the load width in bytes (16 unless Dp or an address forbids).
template <bool PACKED4, int W>
__global__ void __launch_bounds__(kSplitThreads, kSplitMinBlocks)
decode_split_kernel(const uint16_t* __restrict__ q,    // [B, H, D] bf16
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
  const int n_keys = max(0, min(np + 1, S));
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
    q_s[d] = bf16_to_float(q[(static_cast<size_t>(b) * H + h) * D + d]);
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
    // the value pass's first loads, in flight during the score pass
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
        if (j < ns && lig == 0) {
          const int s = s0 + j;
          sc[j] = dot * bf16_to_float(ksb[s]) * scale + slope * static_cast<float>(s);
        }
      }
    }
    __syncthreads();
    // every warp folds the tile (two scores a lane) into the same m and l
    const float v0 = lane < ns ? sc[lane] : VSIM_NEG_INF;
    const float v1 = lane + 32 < ns ? sc[lane + 32] : VSIM_NEG_INF;
    const float m_new = fmaxf(m_run, warp_max(fmaxf(v0, v1)));
    const float p0 = lane < ns ? expf(v0 - m_new) : 0.f;
    const float p1 = lane + 32 < ns ? expf(v1 - m_new) : 0.f;
    const float alpha = m_run == VSIM_NEG_INF ? 0.f : expf(m_run - m_new);
    l_run = alpha * l_run + warp_sum(p0 + p1);
    m_run = m_new;
    if (warp == 0) {
      if (lane < ns) pw[lane] = p0 * bf16_to_float(vsb[s0 + lane]);
      if (lane + 32 < ns) pw[lane + 32] = p1 * bf16_to_float(vsb[s0 + lane + 32]);
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
    __syncthreads();  // sc and pw are rewritten by the next tile
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

// Pass 2: merge the splits of one (b, h) in index order.
__global__ void __launch_bounds__(128)
decode_combine_kernel(const float* __restrict__ part, float* __restrict__ out,
                      int H, int D, int n_split) {
  extern __shared__ float wgt[];  // [n_split]
  __shared__ float L_s;
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t row = static_cast<size_t>(b) * H + h;
  const float* p = part + row * n_split * (D + 2);
  float M = VSIM_NEG_INF;
  for (int i = 0; i < n_split; ++i)
    if (p[i * (D + 2) + 1] > 0.f) M = fmaxf(M, p[i * (D + 2)]);
  for (int i = threadIdx.x; i < n_split; i += blockDim.x) {
    const float l = p[i * (D + 2) + 1];
    wgt[i] = l > 0.f ? expf(p[i * (D + 2)] - M) : 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float L = 0.f;
    for (int i = 0; i < n_split; ++i)
      if (wgt[i] > 0.f) L += p[i * (D + 2) + 1] * wgt[i];
    L_s = L;
  }
  __syncthreads();
  const float L = L_s;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float s = 0.f;
    for (int i = 0; i < n_split; ++i)
      if (wgt[i] > 0.f) s = fmaf(p[i * (D + 2) + 2 + d], wgt[i], s);
    out[row * D + d] = L > 0.f ? s / L : 0.f;
  }
}

template <bool PACKED4, int W>
cudaError_t launch_split(const void* q, const void* kq, const void* ks,
                         const void* vq, const void* vs, const int* np,
                         const float* sl, float* part, int il, int B, int H,
                         int S, int D, int c, int n_split, float scale,
                         cudaStream_t st) {
  const int Dp = PACKED4 ? D / 2 : D;
  const int RG = kSplitThreads / (Dp / W);
  const size_t smem = sizeof(float) * static_cast<size_t>(D) * (1 + RG);
  auto kern = decode_split_kernel<PACKED4, W>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kern<<<dim3(n_split, H, B), kSplitThreads, smem, st>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint8_t*>(kq),
      static_cast<const uint16_t*>(ks), static_cast<const uint8_t*>(vq),
      static_cast<const uint16_t*>(vs), np, sl, part, il, B, H, S, D, c, scale);
  return cudaGetLastError();
}

template <bool PACKED4>
cudaError_t dispatch_split(int W, const void* q, const void* kq,
                           const void* ks, const void* vq, const void* vs,
                           const int* np, const float* sl, float* part, int il,
                           int B, int H, int S, int D, int c, int n_split,
                           float scale, cudaStream_t st) {
  switch (W) {
    case 16: return launch_split<PACKED4, 16>(q, kq, ks, vq, vs, np, sl, part, il, B, H, S, D, c, n_split, scale, st);
    case 8: return launch_split<PACKED4, 8>(q, kq, ks, vq, vs, np, sl, part, il, B, H, S, D, c, n_split, scale, st);
    case 4: return launch_split<PACKED4, 4>(q, kq, ks, vq, vs, np, sl, part, il, B, H, S, D, c, n_split, scale, st);
    case 2: return launch_split<PACKED4, 2>(q, kq, ks, vq, vs, np, sl, part, il, B, H, S, D, c, n_split, scale, st);
    case 1: return launch_split<PACKED4, 1>(q, kq, ks, vq, vs, np, sl, part, il, B, H, S, D, c, n_split, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// K5: one block per (b, h), fresh row merged in the epilogue
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;   // keys per tile
constexpr int kMaxCols = 2; // packed columns per thread: Dp <= 512

template <bool PACKED4>
__global__ void __launch_bounds__(kThreads)
decode_fresh_kernel(const uint16_t* __restrict__ q,    // [B, H, D] bf16
                    const uint8_t* __restrict__ kq,    // [L, B, H, S, Dp]
                    const uint16_t* __restrict__ ks,   // [L, B, H, S] bf16
                    const uint8_t* __restrict__ vq,
                    const uint16_t* __restrict__ vs,
                    const int* __restrict__ n_past,    // [B]
                    const float* __restrict__ slopes,  // [H] or null
                    const uint8_t* __restrict__ knq,   // [B, H, Dp]
                    const uint16_t* __restrict__ kns,  // [B, H] bf16
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
  const int n_keys = max(0, min(np, S));

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
          dot = fmaf(q_s[c], lo_nibble(u), dot);
          dot = fmaf(q_s[c + Dp], hi_nibble(u), dot);
        } else {
          dot = fmaf(q_s[c], int8_val(u), dot);
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
          a0 = fmaf(w, lo_nibble(u), a0);
          a1 = fmaf(w, hi_nibble(u), a1);
        } else {
          a0 = fmaf(w, int8_val(u), a0);
        }
      }
      acc[i][0] = a0;
      acc[i][1] = a1;
    }
    __syncthreads();  // sc is rewritten by the next tile
  }

  // this step's own row: its score needs the whole q . k, so a block sum
  const size_t row = static_cast<size_t>(b) * H + h;
  const uint8_t* krow = knq + row * Dp;
  const uint8_t* vrow = vnq + row * Dp;
  float part = 0.f;
  for (int c = tid; c < Dp; c += kThreads) {
    const uint32_t u = krow[c];
    if (PACKED4) {
      part = fmaf(q_s[c], lo_nibble(u), part);
      part = fmaf(q_s[c + Dp], hi_nibble(u), part);
    } else {
      part = fmaf(q_s[c], int8_val(u), part);
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
  const float l = a * l_run + p_new;
  const float pv = p_new * bf16_to_float(vns[row]);
#pragma unroll
  for (int i = 0; i < kMaxCols; ++i) {
    const int c = tid + i * kThreads;
    if (c >= Dp) continue;
    const uint32_t u = vrow[c];
    if (PACKED4) {
      acc[i][0] = fmaf(pv, lo_nibble(u), acc[i][0] * a);
      acc[i][1] = fmaf(pv, hi_nibble(u), acc[i][1] * a);
    } else {
      acc[i][0] = fmaf(pv, int8_val(u), acc[i][0] * a);
    }
  }
  const float inv = l > 0.f ? 1.f / l : 0.f;
  float* o = out + row * D;
#pragma unroll
  for (int i = 0; i < kMaxCols; ++i) {
    const int c = tid + i * kThreads;
    if (c >= Dp) continue;
    o[c] = acc[i][0] * inv;
    if (PACKED4) o[c + Dp] = acc[i][1] * inv;
  }
}

}  // namespace

// K3: the cache already holds this step's row.  Pass 1 over n_split splits
// of c keys into ``part`` [B, H, n_split, D + 2], then the combine; W is the
// load width in bytes (it divides Dp and the cache's base addresses).
extern "C" int decode_attention_launch(const void* q, const void* kq,
                                       const void* ks, const void* vq,
                                       const void* vs, const void* n_past,
                                       const void* slopes, void* part,
                                       void* out, int packed4, int il, int B,
                                       int H, int S, int D, int c, int n_split,
                                       int W, float scale, void* stream) {
  if (c % kSplitTile != 0 || n_split < 1 || static_cast<long long>(c) * n_split < S)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto np = static_cast<const int*>(n_past);
  auto sl = static_cast<const float*>(slopes);
  auto pp = static_cast<float*>(part);
  const cudaError_t err =
      packed4 ? dispatch_split<true>(W, q, kq, ks, vq, vs, np, sl, pp, il, B, H, S, D, c, n_split, scale, st)
              : dispatch_split<false>(W, q, kq, ks, vq, vs, np, sl, pp, il, B, H, S, D, c, n_split, scale, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<<<dim3(H, B), 128, sizeof(float) * n_split, st>>>(
      pp, static_cast<float*>(out), H, D, n_split);
  return static_cast<int>(cudaGetLastError());
}

// K5: rows < n_past[b] from the cache, this step's row from knq/kns/vnq/vns.
extern "C" int decode_attention_fresh_launch(
    const void* q, const void* kq, const void* ks, const void* vq,
    const void* vs, const void* n_past, const void* slopes, const void* knq,
    const void* kns, const void* vnq, const void* vns, void* out, int packed4,
    int il, int B, int H, int S, int D, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(H, B);
  const size_t smem = static_cast<size_t>(D) * sizeof(float);
  auto u8 = [](const void* p) { return static_cast<const uint8_t*>(p); };
  auto u16 = [](const void* p) { return static_cast<const uint16_t*>(p); };
  auto np = static_cast<const int*>(n_past);
  auto sl = static_cast<const float*>(slopes);
  auto op = static_cast<float*>(out);
  if (packed4)
    decode_fresh_kernel<true><<<grid, kThreads, smem, st>>>(
        u16(q), u8(kq), u16(ks), u8(vq), u16(vs), np, sl, u8(knq), u16(kns),
        u8(vnq), u16(vns), op, il, B, H, S, D, scale);
  else
    decode_fresh_kernel<false><<<grid, kThreads, smem, st>>>(
        u16(q), u8(kq), u16(ks), u8(vq), u16(vs), np, sl, u8(knq), u16(kns),
        u8(vnq), u16(vns), op, il, B, H, S, D, scale);
  return static_cast<int>(cudaGetLastError());
}
