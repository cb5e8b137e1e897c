// K4 flash_attention_fwd: causal blockwise attention for prefill and training.
//
// Replaces vsim_tpu/ops/attention.py:_fwd_kernel (:62), forward only, same
// numerics: q and k widened to f32, score = q.k * scale (+ slope_h * s),
// query t (cache offset n_past) sees key s iff s <= n_past + t and s < S, f32
// online softmax with l summing the unrounded p, p rounded to v's dtype
// before the p.v product (as `p.astype(v_ref.dtype)`), out = acc / l in q's
// dtype, lse = m + log l (f32, read by K7/K8); a row that sees no key gets
// out 0 and lse = -FLT_MAX.  Key tiles past a query tile's causal horizon
// are never loaded.
//
// Bound on the H100: operations at prefill and training lengths (4 D flops
// per visible (query, key) pair).  Two instances:
//
// bf16, on the tensor cores (FlashAttention-2 style, mma.sync m16n8k16 bf16
// -> f32).  One block of 4 warps takes 64 query rows of one (b, h), 16 rows a
// warp, and walks key tiles of 64 keys (D <= 128) or 32 (D = 256) through a
// two-stage ring of 16-byte cp.async copies; fragments come from shared
// memory by ldmatrix (.trans for V).  S = Q K^T, the mask, ALiBi and the
// online softmax stay in the accumulator registers (row max and sum reduced
// over each row's 4-lane quad); p goes back into the P V product as the A
// operand, rounded to bf16 there only.  Head dims are padded in shared memory
// to 64, 80, 96, 128 or 256 with zero columns (they change no dot product and
// are never stored); rows whose byte length is not a multiple of 16 are
// copied element by element into the same layout.  Shared-memory rows carry
// 16 bytes of padding so that ldmatrix is free of bank conflicts.  Q stays in
// registers up to D = 128; at D = 256 the 128-float O accumulator takes the
// room, so Q fragments are read from shared memory at each k-step.  Query
// tiles are scheduled longest first.
//
// f32, on the tensor cores as "mma_3xtf32" (the instance of K7/K8's f32
// backward): each f32 product is three mma.sync m16n8k8 TF32 products,
// small.big + big.small + big.big into an f32 accumulator, of operands split
// by common.cuh:split_tf32_trunc: big = x cut to TF32 by a mask, small = x -
// big passed whole (the tensor cores read its top 19 bits), so big + small
// is x to 2^-20 and the dropped small.small is below 2^-20 of |a| |b|.  That
// keeps the f32 contract where one TF32 product would not
// (tests/test_torch_flash_fwd_tf32.py emulates both: ~1e-6 of max|plain|
// against ~1e-3), at one integer operation a value where K7/K8's rounded
// split takes four.  A block takes 16 query rows a warp and walks key tiles
// through a ring of 16-byte cp.async copies (element copies where rows are
// not 16-byte multiples); shared rows are f32, padded to D + 4 floats so
// that both fragment patterns (row g col t; row 2t col g) hit 32 distinct
// banks, and head dims are zero-padded to 64, 80, 96, 128 or 256 as in the
// bf16 instance.  S = Q K^T has the head dim as its k index on both sides.
// The online softmax stays in the accumulator registers (row max and sum
// over each row's quad), with p unrounded.  O += P V takes p as its A
// operand with no shuffle or staging: the m16n8 accumulator holds keys 2t
// and 2t+1 of a row where the A fragment wants k slots t and t+4, so the
// product relabels its k index (slot t is key 2t, slot t+4 key 2t+1) and
// its B fragment reads value rows 2t and 2t+1 to match.  The tensor cores'
// sums keep no guard bits, so S takes a fresh fragment a 128 dims and each
// output n-tile one a 32 keys, each added in f32.  Bound on the H100: three
// TF32 products per f32 product at the dense TF32 peak; what holds it back
// is the instruction stream around the MMAs (the splits, the shared loads
// of each fragment, the softmax), at 4.2-7.0x that bound at T = 2048.
// fwd_plan's geometries (tools/bwd_plans.py --fwd on an NVIDIA H100 80GB
// HBM3 at a 700 W power limit: the fastest candidate at the main path's
// shapes, none spilling; ptxas registers a thread):
//   T > 32: 4 warps, 64 queries, 32-key tiles at D = 64 (one stage, 4
//     blocks an SM, 128 registers), 80 (one stage, 3 blocks, 159) and 96
//     (two stages, 3 blocks, 168); 8 warps, two a row tile splitting the
//     head dim, at D = 128 (64-key tiles, 202) and 256 (32-key tiles,
//     207), one block an SM.
//   T <= 32 (a short prompt; at most two 16-query tiles): 16 queries a
//     block and the head dim over 4 (D = 64, 96, 128), 5 (80) or 8 (256)
//     warps, each a short chain of dependent products: 32-key tiles, 16 at
//     D = 128 and 256 (89-95 registers).  At T = 16, D = 256 it runs 6.5
//     us where the long geometry took 13.5 (chip_smoke.py --fwd-f32).
// Tried and dropped: two m16 tiles a warp sharing each key and value
// fragment (255 registers, spilling from D = 80; at D = 64 4% faster at B =
// 4 and 7% slower at B = 1); q, k
// and v split once into big and small planes of shared memory (1.2-2.0x
// slower: twice the shared loads); float2 loads of the score operands by
// relabelling the head dim within a k-step (1.5-16% slower); the rounded
// split of K7/K8 (1.10-1.21x slower, across two sweeps).

#include "common.cuh"

namespace {

constexpr int kMaxD = 256;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps
constexpr int kMmaBQ = 64;        // query rows per block, 16 per warp

// Rows [row0, row0 + n) of one head's [rows, D] bf16 matrix into sm[n][DS];
// rows past ``rows`` read as zeros.  ``vec``: D % 8 == 0 and 16-byte aligned
// rows, copied by cp.async; otherwise element by element (synchronous).
template <int DS>
__device__ __forceinline__ void load_tile_bf16(uint16_t* sm, const uint16_t* g,
                                               int row0, int n, int rows,
                                               int D, bool vec) {
  if (vec) {
    const int cpr = D / 8;
    for (int idx = threadIdx.x; idx < n * cpr; idx += kMmaThreads) {
      const int r = idx / cpr, c = (idx % cpr) * 8;
      const int row = row0 + r;
      const bool ok = row < rows;
      cp_async16(sm + r * DS + c, g + static_cast<size_t>(ok ? row : row0) * D + c,
                 ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < n * D; idx += kMmaThreads) {
      const int r = idx / D, c = idx % D;
      const int row = row0 + r;
      sm[r * DS + c] = row < rows ? g[static_cast<size_t>(row) * D + c] : 0;
    }
  }
}

template <int DPAD, int BS>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_bf16_kernel(const uint16_t* __restrict__ q,  // [B, H, T, D]
                      const uint16_t* __restrict__ k,  // [B, H, S, D]
                      const uint16_t* __restrict__ v,  // [B, H, S, D]
                      uint16_t* __restrict__ out,      // [B, H, T, D]
                      float* __restrict__ lse,         // [B, H, T]
                      const float* __restrict__ slopes,  // [H] or null
                      int H, int T, int S, int D, int n_past, float scale,
                      int vec) {
  constexpr int DS = DPAD + 8;        // shared row: 16 bytes of padding
  constexpr int KSTEPS = DPAD / 16;   // k-steps of Q K^T
  constexpr int NT_S = BS / 8;        // 8-key n-tiles of a score tile
  constexpr int NT_O = DPAD / 8;      // 8-column n-tiles of the output
  constexpr bool Q_REGS = DPAD <= 128;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* qs = smem;               // [kMmaBQ][DS]
  uint16_t* ks = qs + kMmaBQ * DS;   // [2][BS][DS]
  uint16_t* vs = ks + 2 * BS * DS;   // [2][BS][DS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, qid = lane % 4;  // mma row group, lane in quad
  const int bh = blockIdx.y, h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kMmaBQ;  // longest first
  const uint16_t* qg = q + static_cast<size_t>(bh) * T * D;
  const uint16_t* kg = k + static_cast<size_t>(bh) * S * D;
  const uint16_t* vg = v + static_cast<size_t>(bh) * S * D;
  const float slope = slopes ? slopes[h] : 0.f;

  if (DPAD != D) {  // zero pad columns of every row; loads never touch them
    const int np = DPAD - D;
    for (int idx = tid; idx < (kMmaBQ + 4 * BS) * np; idx += kMmaThreads)
      smem[(idx / np) * DS + D + idx % np] = 0;
  }
  const int last_t = min(q0 + kMmaBQ, T) - 1;
  const int n_keys = min(S, n_past + last_t + 1);
  const int n_tiles = n_keys > 0 ? (n_keys + BS - 1) / BS : 0;
  load_tile_bf16<DS>(qs, qg, q0, kMmaBQ, T, D, vec);
  if (n_tiles > 0) {
    load_tile_bf16<DS>(ks, kg, 0, BS, S, D, vec);
    load_tile_bf16<DS>(vs, vg, 0, BS, S, D, vec);
  }
  cp_async_commit();

  const int t_lo = q0 + warp * 16 + gid, t_hi = t_lo + 8;
  const int warp_horizon = n_past + q0 + warp * 16 + 15;  // last key it sees
  float o[NT_O][4];
#pragma unroll
  for (int i = 0; i < NT_O; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_lo = VSIM_NEG_INF, m_hi = VSIM_NEG_INF, l_lo = 0.f, l_hi = 0.f;
  uint32_t qf[Q_REGS ? KSTEPS : 1][4];
  // ldmatrix addresses of this lane within a 16x16 A tile and a B tile pair
  const int a_row = warp * 16 + (lane % 16), a_col = (lane / 16) * 8;
  const int kb_row = (lane % 8) + (lane / 16) * 8, kb_col = ((lane / 8) % 2) * 8;
  const int vb_row = (lane % 8) + ((lane / 8) % 2) * 8, vb_col = (lane / 16) * 8;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles) {  // prefetch the next tile into the other stage
      load_tile_bf16<DS>(ks + (st ^ 1) * BS * DS, kg, (it + 1) * BS, BS, S, D, vec);
      load_tile_bf16<DS>(vs + (st ^ 1) * BS * DS, vg, (it + 1) * BS, BS, S, D, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (Q_REGS && it == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        ldmatrix_x4(qf[Q_REGS ? kk : 0], qs + a_row * DS + kk * 16 + a_col);
    }
    const int s0 = it * BS;
    if (s0 <= warp_horizon) {  // else every key of the tile is masked here
      const uint16_t* kt = ks + st * BS * DS;
      const uint16_t* vt = vs + st * BS * DS;
      float sacc[NT_S][4];
#pragma unroll
      for (int i = 0; i < NT_S; ++i)
        sacc[i][0] = sacc[i][1] = sacc[i][2] = sacc[i][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t a[4];
        if (Q_REGS) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = qf[Q_REGS ? kk : 0][i];
        } else {
          ldmatrix_x4(a, qs + a_row * DS + kk * 16 + a_col);
        }
#pragma unroll
        for (int np = 0; np < NT_S / 2; ++np) {
          uint32_t b[4];
          ldmatrix_x4(b, kt + (np * 16 + kb_row) * DS + kk * 16 + kb_col);
          mma_bf16(sacc[2 * np], a, b[0], b[1]);
          mma_bf16(sacc[2 * np + 1], a, b[2], b[3]);
        }
      }
      // scale, ALiBi, mask; this thread holds rows t_lo (e 0, 1) and t_hi
      // (e 2, 3), keys s0 + 8 nt + 2 qid + (e & 1)
      float mx_lo = VSIM_NEG_INF, mx_hi = VSIM_NEG_INF;
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = s0 + nt * 8 + 2 * qid + (e & 1);
          const int t = e < 2 ? t_lo : t_hi;
          float sv = sacc[nt][e] * scale + slope * static_cast<float>(s);
          if (s >= S || s > n_past + t) sv = VSIM_NEG_INF;
          sacc[nt][e] = sv;
          if (e < 2) mx_lo = fmaxf(mx_lo, sv);
          else mx_hi = fmaxf(mx_hi, sv);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
      const float al_lo = m_lo == VSIM_NEG_INF ? 0.f : __expf(m_lo - mn_lo);
      const float al_hi = m_hi == VSIM_NEG_INF ? 0.f : __expf(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float sv = sacc[nt][e];
          const float mn = e < 2 ? mn_lo : mn_hi;
          const float p = sv == VSIM_NEG_INF ? 0.f : __expf(sv - mn);
          sacc[nt][e] = p;
          if (e < 2) sum_lo += p;
          else sum_hi += p;
        }
      }
      l_lo = al_lo * l_lo + sum_lo;  // this lane's share; quads sum at the end
      l_hi = al_hi * l_hi + sum_hi;
#pragma unroll
      for (int i = 0; i < NT_O; ++i) {
        o[i][0] *= al_lo;
        o[i][1] *= al_lo;
        o[i][2] *= al_hi;
        o[i][3] *= al_hi;
      }
      // O += P V: two score n-tiles form one 16-key A fragment
#pragma unroll
      for (int kk = 0; kk < BS / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]),
                               pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
                               pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
                               pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < NT_O / 2; ++dp) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vt + (kk * 16 + vb_row) * DS + dp * 16 + vb_col);
          mma_bf16(o[2 * dp], a, b[0], b[1]);
          mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this stage is refilled by the next prefetch
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = half ? t_hi : t_lo;
    if (t >= T) continue;
    const float l = half ? l_hi : l_lo, m = half ? m_hi : m_lo;
    uint16_t* orow = out + (static_cast<size_t>(bh) * T + t) * D;
#pragma unroll
    for (int nt = 0; nt < NT_O; ++nt) {
      const int col = nt * 8 + 2 * qid;
      if (col >= D) continue;
      const float x0 = l > 0.f ? o[nt][2 * half] / l : 0.f;
      const float x1 = l > 0.f ? o[nt][2 * half + 1] / l : 0.f;
      const uint32_t pr = pack_bf16(x0, x1);
      if (col + 1 < D && (D % 2) == 0) {
        *reinterpret_cast<uint32_t*>(orow + col) = pr;
      } else {
        orow[col] = static_cast<uint16_t>(pr & 0xFFFFu);
        if (col + 1 < D) orow[col + 1] = static_cast<uint16_t>(pr >> 16);
      }
    }
    if (qid == 0)
      lse[static_cast<size_t>(bh) * T + t] = l > 0.f ? m + logf(l) : VSIM_NEG_INF;
  }
}

template <int DPAD, int BS>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, const float* slopes, int B, int H, int T, int S,
                int D, int n_past, float scale, int vec, cudaStream_t st) {
  auto kern = flash_fwd_bf16_kernel<DPAD, BS>;
  const size_t smem = sizeof(uint16_t) * (kMmaBQ + 4 * BS) * (DPAD + 8);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kMmaBQ - 1) / kMmaBQ, B * H);
  kern<<<grid, kMmaThreads, smem, st>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(out), lse, slopes,
      H, T, S, D, n_past, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: tensor cores, three TF32 products per f32 product ("mma_3xtf32")
// ---------------------------------------------------------------------------

// Each padded head dim's geometry, one for T > kFewRows and one (``few``)
// for the few query rows of a short prompt, where a block's chain of
// dependent products, not the card's rate, sets the time: rt row tiles of
// 16 query rows a block; cs warps a row tile, which split the head dim for
// the scores (each its slice of q.k over every key of the tile, the slices
// added in slice order through shared memory, so that every warp of the
// row tile holds the same scores) and the columns of the output; keys a
// tile; stages of the key/value ring (1 or 2); and the blocks an SM the
// register budget is set for (__launch_bounds__).  Picked by measurement
// (tools/bwd_plans.py --fwd; see the header).
constexpr int kFewRows = 32;
struct FwdPlan {
  int rt, cs, tile, stages, min_blocks;
};
__host__ __device__ constexpr FwdPlan fwd_plan(int dpad, bool few) {
  return few ? (dpad <= 64    ? FwdPlan{1, 4, 32, 1, 2}
                : dpad <= 80  ? FwdPlan{1, 5, 32, 1, 1}
                : dpad <= 96  ? FwdPlan{1, 4, 32, 1, 2}
                : dpad <= 128 ? FwdPlan{1, 4, 16, 1, 2}
                              : FwdPlan{1, 8, 16, 1, 1})
             : (dpad <= 64    ? FwdPlan{4, 1, 32, 1, 4}
                : dpad <= 80  ? FwdPlan{4, 1, 32, 1, 3}
                : dpad <= 96  ? FwdPlan{4, 1, 32, 2, 3}
                : dpad <= 128 ? FwdPlan{4, 2, 64, 2, 1}
                              : FwdPlan{4, 2, 32, 2, 1});
}
__host__ __device__ constexpr int fwd_threads(int dpad, bool few) {
  return 32 * fwd_plan(dpad, few).rt * fwd_plan(dpad, few).cs;
}
// q rows and the key and value ring (rows padded to dpad + 4 floats), and
// with cs > 1 the score slices [cs][16 rt][tile + 8]
__host__ __device__ constexpr size_t fwd_smem_bytes(int dpad, bool few) {
  const FwdPlan P = fwd_plan(dpad, few);
  const int rows = 16 * P.rt;
  return sizeof(float) *
         ((rows + 2 * P.stages * P.tile) * static_cast<size_t>(dpad + 4) +
          (P.cs > 1 ? P.cs * rows * static_cast<size_t>(P.tile + 8) : 0));
}

// Rows [row0, row0 + n) of one head's [rows, D] f32 matrix into sm[n][DP],
// columns [0, D); rows past ``rows`` read as zeros.  ``vec``: D % 4 == 0 and
// 16-byte aligned rows, copied by cp.async; otherwise element by element
// (synchronous).
template <int DP, int NTHR>
__device__ __forceinline__ void fwd_load_rows(float* sm, const float* g,
                                              int row0, int n, int rows,
                                              int D, bool vec) {
  if (vec) {
    const int c4 = D / 4;
    for (int idx = threadIdx.x; idx < n * c4; idx += NTHR) {
      const int r = idx / c4, c = (idx % c4) * 4;
      const int row = row0 + r;
      const bool ok = row < rows;
      cp_async16(sm + r * DP + c, g + static_cast<size_t>(ok ? row : 0) * D + c,
                 ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < n * D; idx += NTHR) {
      const int r = idx / D, c = idx % D;
      const int row = row0 + r;
      sm[r * DP + c] = row < rows ? g[static_cast<size_t>(row) * D + c] : 0.f;
    }
  }
}

// One warp's scores over KS k-steps of the head dim: sa = Q K^T for its 16
// query rows (qr at row g, column t of the first k-step) and the NS * 8
// keys of the tile (kr at key g, column t).  A fresh fragment a 128 dims,
// added in f32, so that the tensor cores' own sums span at most 16 k-steps.
template <int KS, int NS, int DP>
__device__ __forceinline__ void fwd_scores(float (&sa)[NS][4], const float* qr,
                                           const float* kr) {
  constexpr int KC = KS < 16 ? KS : 16;
  static_assert(KS % KC == 0, "whole 128-dim parts");
#pragma unroll
  for (int c = 0; c < KS; c += KC) {
    float f[NS][4];
#pragma unroll
    for (int i = 0; i < NS; ++i) f[i][0] = f[i][1] = f[i][2] = f[i][3] = 0.f;
#pragma unroll
    for (int kk = c; kk < c + KC; ++kk) {
      const float* p = qr + kk * 8;
      FragA3 qa;
      qa.set_trunc(p[0], p[8 * DP], p[4], p[8 * DP + 4]);
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
        const float* b = kr + nt * 8 * DP + kk * 8;
        FragB3 kb;
        kb.set_trunc(b[0], b[4]);
        mma_3xtf32(f[nt], qa, kb);
      }
    }
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sa[i][e] = c == 0 ? f[i][e] : sa[i][e] + f[i][e];
  }
}

// One block per (b, h, 16 rt queries), warps by fwd_plan.  Walks the key
// tiles up to the block's causal horizon, longest walks first.
template <int DPAD, bool FEW>
__global__ void __launch_bounds__(fwd_threads(DPAD, FEW),
                                  fwd_plan(DPAD, FEW).min_blocks)
flash_fwd_3xtf32_kernel(const float* __restrict__ q,   // [B, H, T, D]
                        const float* __restrict__ k,   // [B, H, S, D]
                        const float* __restrict__ v,   // [B, H, S, D]
                        float* __restrict__ out,       // [B, H, T, D]
                        float* __restrict__ lse,       // [B, H, T]
                        const float* __restrict__ slopes,  // [H] or null
                        int H, int T, int S, int D, int n_past, float scale,
                        int vec) {
  constexpr FwdPlan P = fwd_plan(DPAD, FEW);
  constexpr int NTHR = fwd_threads(DPAD, FEW);
  constexpr int R = 16 * P.rt;      // query rows of the block
  constexpr int BS = P.tile;        // keys a tile
  constexpr int DP = DPAD + 4;      // shared row: 32 distinct banks
  constexpr int PS = BS + 8;        // a score slice's row
  constexpr int KS = DPAD / 8 / P.cs;  // k-steps of a warp's score slice
  constexpr int NS = BS / 8;        // 8-key n-tiles of a score tile
  constexpr int ND = DPAD / 8 / P.cs;  // a warp's 8-column output n-tiles
  constexpr int G = NS < 4 ? NS : 4;   // k-steps a P V fragment
  static_assert((DPAD / 8) % P.cs == 0 && NS % G == 0, "whole fragments");
  static_assert(P.stages == 1 || P.stages == 2, "one or two stages");
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                        // [R][DP]
  float* ks = qs + R * DP;               // [stages][BS][DP]
  float* vs = ks + P.stages * BS * DP;   // [stages][BS][DP]
  float* part = vs + P.stages * BS * DP;  // cs > 1: [cs][R][PS]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;  // mma row group, lane in quad
  const int r0 = (warp % P.rt) * 16;      // this warp's rows of the block
  const int cw = warp / P.rt;             // its slice of the head dim
  const int bh = blockIdx.y, h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * R;  // longest first
  const float* qg = q + static_cast<size_t>(bh) * T * D;
  const float* kg = k + static_cast<size_t>(bh) * S * D;
  const float* vg = v + static_cast<size_t>(bh) * S * D;
  const float slope = slopes ? slopes[h] : 0.f;

  if (DPAD != D) {  // zero pad columns of every row; loads never touch them
    const int np = DPAD - D;
    for (int idx = threadIdx.x; idx < (R + 2 * P.stages * BS) * np;
         idx += NTHR)
      sm[(idx / np) * DP + D + idx % np] = 0.f;
  }
  const int last_t = min(q0 + R, T) - 1;
  const int n_keys = min(S, n_past + last_t + 1);
  const int n_tiles = n_keys > 0 ? (n_keys + BS - 1) / BS : 0;
  auto load_tile = [&](int st, int it) {
    fwd_load_rows<DP, NTHR>(ks + st * BS * DP, kg, it * BS, BS, S, D, vec);
    fwd_load_rows<DP, NTHR>(vs + st * BS * DP, vg, it * BS, BS, S, D, vec);
  };
  fwd_load_rows<DP, NTHR>(qs, qg, q0, R, T, D, vec);
  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();

  // this thread's rows: t_lo (accumulator elements 0, 1) and t_lo + 8 (2, 3)
  const int t_lo = q0 + r0 + g;
  const bool warp_live = q0 + r0 < T;
  const int horizon = n_past + min(q0 + r0 + 15, T - 1);  // last key seen
  const int col0 = cw * ND * 8;  // this warp's output columns
  float o[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {VSIM_NEG_INF, VSIM_NEG_INF};  // row max
  float l[2] = {0.f, 0.f};  // this lane's share of the row sum

  for (int it = 0; it < n_tiles; ++it) {
    const int st = P.stages == 2 ? (it & 1) : 0;
    if (P.stages == 2) {
      if (it + 1 < n_tiles) load_tile(st ^ 1, it + 1);  // prefetch
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      if (it > 0) load_tile(0, it);  // the last tile was consumed
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = ks + st * BS * DP;
    const float* vt = vs + st * BS * DP;
    const int s0 = it * BS;
    const bool live = warp_live && s0 <= horizon;  // the same a row tile
    float sa[NS][4];
    if (live) {
      const int k0 = cw * KS * 8;
      fwd_scores<KS, NS, DP>(sa, qs + (r0 + g) * DP + t4 + k0,
                             kt + g * DP + t4 + k0);
      if (P.cs > 1) {
#pragma unroll
        for (int nt = 0; nt < NS; ++nt)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            *reinterpret_cast<float2*>(
                part + (cw * R + r0 + g + 8 * half) * PS + nt * 8 + 2 * t4) =
                make_float2(sa[nt][2 * half], sa[nt][2 * half + 1]);
      }
    }
    if (P.cs > 1) {
      __syncthreads();  // every slice is in
      if (live) {  // the slices added in slice order, the same in each warp
#pragma unroll
        for (int nt = 0; nt < NS; ++nt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float2 x = make_float2(0.f, 0.f);
#pragma unroll
            for (int c = 0; c < P.cs; ++c) {
              const float2 y = *reinterpret_cast<const float2*>(
                  part + (c * R + r0 + g + 8 * half) * PS + nt * 8 + 2 * t4);
              x = c == 0 ? y : make_float2(x.x + y.x, x.y + y.y);
            }
            sa[nt][2 * half] = x.x;
            sa[nt][2 * half + 1] = x.y;
          }
      }
    }
    if (live) {
      // scale, ALiBi, mask; keys s0 + 8 nt + 2 t4 + (e & 1).  The mask is
      // tested only where a row of the warp misses a key of the tile
      const bool full = s0 + BS - 1 <= n_past + q0 + r0 && s0 + BS <= S;
      float mx[2] = {VSIM_NEG_INF, VSIM_NEG_INF};
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = s0 + nt * 8 + 2 * t4 + (e & 1);
          const int t = t_lo + 8 * (e >> 1);
          float sv = sa[nt][e] * scale + slope * static_cast<float>(s);
          if (!full && (s >= S || s > n_past + t)) sv = VSIM_NEG_INF;
          sa[nt][e] = sv;
          mx[e >> 1] = fmaxf(mx[e >> 1], sv);
        }
      }
      float al[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1)
          mx[half] =
              fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], off));
        const float mn = fmaxf(m[half], mx[half]);
        al[half] = m[half] == VSIM_NEG_INF ? 0.f : expf(m[half] - mn);
        m[half] = mn;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float sv = sa[nt][e];
          const float p = sv == VSIM_NEG_INF ? 0.f : expf(sv - m[e >> 1]);
          sa[nt][e] = p;
          sum[e >> 1] += p;
        }
      }
      l[0] = al[0] * l[0] + sum[0];  // quads sum at the end
      l[1] = al[1] * l[1] + sum[1];
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        o[i][0] *= al[0];
        o[i][1] *= al[0];
        o[i][2] *= al[1];
        o[i][3] *= al[1];
      }
      // O += P V over 8 keys a k-step: k slot t is key 2 t and slot t + 4
      // key 2 t + 1, so the score accumulator is the A fragment as it
      // stands, and the B fragment reads value rows 2 t and 2 t + 1.  Each
      // n-tile's products over G k-steps go into a fresh fragment, added to
      // o in f32
      const float* vr = vt + 2 * t4 * DP + col0 + g;
#pragma unroll
      for (int j0 = 0; j0 < NS; j0 += G) {
        FragA3 pa[G];
#pragma unroll
        for (int j = 0; j < G; ++j)
          pa[j].set_trunc(sa[j0 + j][0], sa[j0 + j][2], sa[j0 + j][1],
                          sa[j0 + j][3]);
#pragma unroll
        for (int dn = 0; dn < ND; ++dn) {
          float f[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int j = 0; j < G; ++j) {
            const float* b = vr + (j0 + j) * 8 * DP + dn * 8;
            FragB3 vb;
            vb.set_trunc(b[0], b[DP]);
            mma_3xtf32(f, pa[j], vb);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) o[dn][e] += f[e];
        }
      }
    }
    __syncthreads();  // this stage and the slices are refilled next
  }
  cp_async_wait<0>();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float lr = l[half];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      lr += __shfl_xor_sync(0xffffffffu, lr, off);
    const int t = t_lo + 8 * half;
    if (t >= T) continue;
    float* orow = out + (static_cast<size_t>(bh) * T + t) * D;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn) {
      const int col = col0 + dn * 8 + 2 * t4;
      if (col >= D) continue;  // the head dim's padding is never stored
      const float x0 = lr > 0.f ? o[dn][2 * half] / lr : 0.f;
      const float x1 = lr > 0.f ? o[dn][2 * half + 1] / lr : 0.f;
      if ((D & 1) == 0) {
        *reinterpret_cast<float2*>(orow + col) = make_float2(x0, x1);
      } else {
        orow[col] = x0;
        if (col + 1 < D) orow[col + 1] = x1;
      }
    }
    if (cw == 0 && t4 == 0)
      lse[static_cast<size_t>(bh) * T + t] =
          lr > 0.f ? m[half] + logf(lr) : VSIM_NEG_INF;
  }
}

template <int DPAD, bool FEW>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               float* lse, const float* slopes, int B, int H, int T, int S,
               int D, int n_past, float scale, int vec, cudaStream_t st) {
  auto kern = flash_fwd_3xtf32_kernel<DPAD, FEW>;
  constexpr size_t smem = fwd_smem_bytes(DPAD, FEW);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int R = 16 * fwd_plan(DPAD, FEW).rt;
  const dim3 grid((T + R - 1) / R, B * H);
  kern<<<grid, fwd_threads(DPAD, FEW), smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, slopes, H,
      T, S, D, n_past, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int DPAD>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               float* lse, const float* slopes, int B, int H, int T, int S,
               int D, int n_past, float scale, int vec, cudaStream_t st) {
  return T <= kFewRows
             ? launch_f32<DPAD, true>(q, k, v, out, lse, slopes, B, H, T, S,
                                      D, n_past, scale, vec, st)
             : launch_f32<DPAD, false>(q, k, v, out, lse, slopes, B, H, T, S,
                                       D, n_past, scale, vec, st);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      const void* slopes, int is_bf16, int B,
                                      int H, int T, int S, int D, int n_past,
                                      float scale, void* stream) {
  if (D <= 0 || D > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto lp = static_cast<float*>(lse);
  auto sl = static_cast<const float*>(slopes);
  const bool al = aligned16(q) && aligned16(k) && aligned16(v);
  if (is_bf16) {
    const int vec = al && D % 8 == 0;
    if (D <= 64) return launch_bf16<64, 64>(q, k, v, out, lp, sl, B, H, T, S, D, n_past, scale, vec, st);
    if (D <= 80) return launch_bf16<80, 64>(q, k, v, out, lp, sl, B, H, T, S, D, n_past, scale, vec, st);
    if (D <= 96) return launch_bf16<96, 64>(q, k, v, out, lp, sl, B, H, T, S, D, n_past, scale, vec, st);
    if (D <= 128) return launch_bf16<128, 64>(q, k, v, out, lp, sl, B, H, T, S, D, n_past, scale, vec, st);
    return launch_bf16<256, 32>(q, k, v, out, lp, sl, B, H, T, S, D, n_past, scale, vec, st);
  }
  const int vec = al && D % 4 == 0;
  if (D <= 64) return launch_f32<64>(q, k, v, out, lp, sl, B, H, T, S, D, n_past, scale, vec, st);
  if (D <= 80) return launch_f32<80>(q, k, v, out, lp, sl, B, H, T, S, D, n_past, scale, vec, st);
  if (D <= 96) return launch_f32<96>(q, k, v, out, lp, sl, B, H, T, S, D, n_past, scale, vec, st);
  if (D <= 128) return launch_f32<128>(q, k, v, out, lp, sl, B, H, T, S, D, n_past, scale, vec, st);
  return launch_f32<256>(q, k, v, out, lp, sl, B, H, T, S, D, n_past, scale, vec, st);
}
