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
// f32, on the FMA units (the tensor cores have no exact f32 product, and
// TF32 would break the f32 contract): the geometry of K7/K8
// (flash_attention_bwd.cu).  256 threads, 32-row query tiles and 32-key
// tiles, rows padded to D + 4 floats and read as float4; in the score pass a
// warp takes 4 query rows and a lane one key, in the p.v pass a thread owns
// one query row and D/8 of its columns.

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
// f32: FMA units, K7/K8's geometry
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;  // 8 warps
constexpr int kF32BQ = 32;        // query rows per tile, 4 per warp
constexpr int kF32BS = 32;        // keys per tile, one per lane
constexpr int kRowsPerWarp = kF32BQ / (kF32Threads / 32);
constexpr int kPS = kF32BS + 1;   // padded row of the p tile

// Rows [row0, row0 + n) of one head's [rows, D] f32 matrix into sm[n][DP],
// columns up to D4 (D rounded up to 4) with zeros past D and past ``rows``.
__device__ __forceinline__ void load_tile_f32(float* sm, const float* g,
                                              int row0, int n, int rows,
                                              int D, int D4, int DP, bool vec) {
  if (vec) {  // D % 4 == 0, 16-byte aligned rows
    const int d4 = D / 4;
    for (int idx = threadIdx.x; idx < n * d4; idx += kF32Threads) {
      const int r = idx / d4, d = (idx % d4) * 4;
      const int row = row0 + r;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < rows)
        val = *reinterpret_cast<const float4*>(g + static_cast<size_t>(row) * D + d);
      *reinterpret_cast<float4*>(sm + r * DP + d) = val;
    }
  } else {
    for (int idx = threadIdx.x; idx < n * D4; idx += kF32Threads) {
      const int r = idx / D4, d = idx % D4;
      const int row = row0 + r;
      sm[r * DP + d] = row < rows && d < D ? g[static_cast<size_t>(row) * D + d] : 0.f;
    }
  }
}

// One block per (b, h, 32-query tile); NG = D4 / 32 rounded up (2, 4, 8).
template <int NG>
__global__ void __launch_bounds__(kF32Threads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, const float* __restrict__ slopes,
                     int H, int T, int S, int D, int n_past, float scale,
                     int vec) {
  extern __shared__ __align__(16) float sm[];
  const int D4 = (D + 3) / 4 * 4, DP = D4 + 4;
  float* qs = sm;                    // [kF32BQ][DP]
  float* ks = qs + kF32BQ * DP;      // [kF32BS][DP]
  float* vs = ks + kF32BS * DP;      // [kF32BS][DP]
  float* ps = vs + kF32BS * DP;      // [kF32BQ][kPS]
  float* a_s = ps + kF32BQ * kPS;    // [kF32BQ] rescale of the tile
  float* m_s = a_s + kF32BQ;         // [kF32BQ]
  float* l_s = m_s + kF32BQ;         // [kF32BQ]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y, h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kF32BQ;  // longest first
  const float* qg = q + static_cast<size_t>(bh) * T * D;
  const float* kg = k + static_cast<size_t>(bh) * S * D;
  const float* vg = v + static_cast<size_t>(bh) * S * D;
  const float slope = slopes ? slopes[h] : 0.f;

  load_tile_f32(qs, qg, q0, kF32BQ, T, D, D4, DP, vec);
  const int last_t = min(q0 + kF32BQ, T) - 1;
  const int n_keys = min(S, n_past + last_t + 1);

  const int r0 = warp * kRowsPerWarp;
  float m[kRowsPerWarp], l[kRowsPerWarp];  // the same in every lane
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = VSIM_NEG_INF;
    l[i] = 0.f;
  }
  const int row = tid / 8, c = tid % 8;
  float acc[4 * NG];
#pragma unroll
  for (int j = 0; j < 4 * NG; ++j) acc[j] = 0.f;

  for (int s0 = 0; s0 < n_keys; s0 += kF32BS) {
    __syncthreads();  // q staged / previous tile consumed
    load_tile_f32(ks, kg, s0, kF32BS, S, D, D4, DP, vec);
    load_tile_f32(vs, vg, s0, kF32BS, S, D, D4, DP, vec);
    __syncthreads();
    float sd[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) sd[i] = 0.f;
    const float* kr = ks + lane * DP;
    for (int d = 0; d < D4; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qq = *reinterpret_cast<const float4*>(qs + (r0 + i) * DP + d);
        sd[i] = fmaf(qq.x, kk.x, sd[i]);
        sd[i] = fmaf(qq.y, kk.y, sd[i]);
        sd[i] = fmaf(qq.z, kk.z, sd[i]);
        sd[i] = fmaf(qq.w, kk.w, sd[i]);
      }
    }
    const int s = s0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int t = n_past + q0 + r0 + i;
      float sc = sd[i] * scale + slope * static_cast<float>(s);
      if (s >= S || s > t) sc = VSIM_NEG_INF;
      const float m_new = fmaxf(m[i], warp_max(sc));
      const float p = sc == VSIM_NEG_INF ? 0.f : expf(sc - m_new);
      const float alpha = m[i] == VSIM_NEG_INF ? 0.f : expf(m[i] - m_new);
      l[i] = alpha * l[i] + warp_sum(p);
      m[i] = m_new;
      ps[(r0 + i) * kPS + lane] = p;
      if (lane == 0) a_s[r0 + i] = alpha;
    }
    __syncthreads();
    const float alpha = a_s[row];
#pragma unroll
    for (int j = 0; j < 4 * NG; ++j) acc[j] *= alpha;
    for (int j = 0; j < kF32BS; ++j) {
      const float p = ps[row * kPS + j];
      const float* vr = vs + j * DP;
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) {
        const int col = gi * 32 + c * 4;
        if (col < D4) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + col);
          acc[4 * gi + 0] = fmaf(p, vv.x, acc[4 * gi + 0]);
          acc[4 * gi + 1] = fmaf(p, vv.y, acc[4 * gi + 1]);
          acc[4 * gi + 2] = fmaf(p, vv.z, acc[4 * gi + 2]);
          acc[4 * gi + 3] = fmaf(p, vv.w, acc[4 * gi + 3]);
        }
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      m_s[r0 + i] = m[i];
      l_s[r0 + i] = l[i];
    }
  }
  __syncthreads();

  const int t = q0 + row;
  if (t >= T) return;
  const float lr = l_s[row], mr = m_s[row];
  float* orow = out + (static_cast<size_t>(bh) * T + t) * D;
#pragma unroll
  for (int gi = 0; gi < NG; ++gi) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = gi * 32 + c * 4 + e;
      if (col < D) orow[col] = lr > 0.f ? acc[4 * gi + e] / lr : 0.f;
    }
  }
  if (c == 0)
    lse[static_cast<size_t>(bh) * T + t] = lr > 0.f ? mr + logf(lr) : VSIM_NEG_INF;
}

template <int NG>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               float* lse, const float* slopes, int B, int H, int T, int S,
               int D, int n_past, float scale, int vec, cudaStream_t st) {
  auto kern = flash_fwd_f32_kernel<NG>;
  const size_t dp = (D + 3) / 4 * 4 + 4;
  const size_t smem = sizeof(float) * ((kF32BQ + 2 * kF32BS) * dp +
                                       kF32BQ * kPS + 3 * kF32BQ);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kF32BQ - 1) / kF32BQ, B * H);
  kern<<<grid, kF32Threads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, slopes, H,
      T, S, D, n_past, scale, vec);
  return static_cast<int>(cudaGetLastError());
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
  if (D <= 64) return launch_f32<2>(q, k, v, out, lp, sl, B, H, T, S, D, n_past, scale, vec, st);
  if (D <= 128) return launch_f32<4>(q, k, v, out, lp, sl, B, H, T, S, D, n_past, scale, vec, st);
  return launch_f32<8>(q, k, v, out, lp, sl, B, H, T, S, D, n_past, scale, vec, st);
}
