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
// The products of bf16(p vs) and int8 values are exact in f32, so FMAs
// compute the value sums; one query row a head leaves the tensor cores
// nothing to do.  vpu3d is the function of K3's int8 mode
// (csrc/decode_attention.cu).  The TPU kernel's unused ALiBi input is
// dropped.
//
// Bound on the H100: bytes, the cache rows up to n_past (2 (D + 2) bytes a
// key a head; 0.229 ms a 36-layer Pythia-12B pass at B = 1, S = 2048).
// mxu's f64 score products are 2 D FLOP a key a head, 0.76 GFLOP over that
// pass: ~22 us at the H100's 34 TFLOP/s f64 rate, well under the bytes.
//
// Design: one launch a layer.  Each (b, h) is a thread-block cluster of C
// blocks (ops/attn_lab.py:attn_plan picks C from the shapes and the card,
// never from n_past); rank r owns a run of consecutive key tiles.  mxu
// rounds p vs at the running max of the tiles so far, so the split keeps
// the in-order walk's maxima exactly:
//  (a) each block computes its live tiles' scores (kept in shared memory)
//      and each tile's maximum;
//  (b) after a cluster barrier each block reads the earlier ranks' maxima
//      through distributed shared memory; their maximum, then the block's
//      own tile maxima in order, give each tile's m_j: exactly the running
//      max the walk holds after tile j;
//  (c) each tile's p = exp(s - m_j), p vs (rounded for mxu) and its sum
//      l_j; the value pass keeps a thread's partial acc, scaled by
//      alpha_j = exp(m_{j-1} - m_j) (0 after no live tile) as each tile
//      starts, as the walk scales its acc;
//  (d) the block's partials (acc summed over its threads in a fixed order,
//      its l folded as l = alpha_j l + l_j) meet after a second cluster
//      barrier: rank r outputs a slice of D, folding the ranks in order,
//      each earlier total times that rank's alpha_j one by one (the walk's
//      f32 factors), plus the rank's partial.
// So every p and every bf16(p vs) is the walk's bit for bit; only the order
// of the f32 sums over keys differs, as it already did from the plain
// version's.  Bytes: a key row is read 16 bytes a lane (D % 16 == 0, else
// 4 bytes a word into a row padded to 16), and the block's K tiles, then
// its V tiles, stream through a ring of cp.async stages of half a tile
// each, so the next halves' bytes (the V tiles' already during the score
// pass and the cluster barrier) are in flight while one computes.  A block
// is 4 or 8 warps (the plan's pick): four 4-warp blocks fit an SM, so
// many small heads run in one wave (GPT-J B=32 x 128: 512 blocks), and
// 8-warp blocks keep more warps an SM where heads are few and long.  A tile past n_past is not
// read; rows past n_past in the last live tile are not read either (their
// score is masked and their p vs is 0).  A block with no live tile still
// takes the cluster barriers and adds nothing.  Deterministic: no atomics,
// a fixed order of every sum.

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

// the bodies, in the order of vsim_tpu_torch/ops/attn_lab.py:ATTN_VARIANTS
enum AttnMath { kVpu3d, kMxu };

constexpr int kTile = 128;      // the body's block_s
constexpr int kHalf = kTile / 2;  // key rows a ring stage holds
constexpr int kMaxTiles = 32;   // key tiles a block may own
constexpr int kMaxCluster = 8;  // blocks a cluster (the portable limit)

// A head's row of D int8 values as 16-byte chunks: CH = ceil(D / 16) of
// them, LPK >= CH (a power of two) lanes a key.
__host__ __device__ constexpr int lanes_of(int d) {
  return d <= 16 ? 1 : d <= 32 ? 2 : d <= 64 ? 4 : d <= 128 ? 8 : 16;
}
// Ring stages of half a tile, by LPK and the block's threads (NTH): a
// 4-warp block keeps three in flight while one computes up to D = 128
// (32 KB a block), two at D = 256 (48 KB), so four blocks fit an SM; an
// 8-warp block (two an SM) five and four.
__host__ __device__ constexpr int stages_of(int lpk, int nth) {
  return (lpk <= 8 ? 4 : 3) + (nth == 256 ? 2 : 0);
}

// Dynamic shared memory, in bytes from its start (16-byte aligned pieces).
struct Layout {
  int dp, row;           // D padded to 16; a staged row's bytes (dp: a
                         // quarter warp reads 128 contiguous bytes)
  int ns, tpr;           // ring stages; tiles a rank owns
  size_t ring, sc, ks, vs, q, mt, al, lt, part, gath, total;
  __host__ __device__ Layout(int D, int tiles_per_rank, int nth) {
    const int lpk = lanes_of(D);
    dp = (D + 15) / 16 * 16;
    row = dp;
    ns = stages_of(lpk, nth);
    tpr = tiles_per_rank;
    const size_t stage = static_cast<size_t>(kHalf) * row;
    const size_t red = static_cast<size_t>(nth / lpk) * dp * 4;
    size_t at = 0;
    ring = at;  at += (ns * stage > red ? ns * stage : red);
    sc = at;    at += static_cast<size_t>(tpr) * kTile * 4;   // scores, then p vs
    ks = at;    at += (static_cast<size_t>(tpr) * kTile * 2 + 15) / 16 * 16;
    vs = at;    at += (static_cast<size_t>(tpr) * kTile * 2 + 15) / 16 * 16;
    q = at;     at += static_cast<size_t>(dp) * 4;
    mt = at;    at += (static_cast<size_t>(tpr) * 4 + 15) / 16 * 16;  // tile maxima
    al = at;    at += (static_cast<size_t>(tpr) * 4 + 15) / 16 * 16;  // alpha_j
    lt = at;    at += (static_cast<size_t>(tpr) * 4 + 15) / 16 * 16;  // l_j
    part = at;  at += static_cast<size_t>(dp) * 4 + 16;  // acc [dp], l, max, n
    gath = at;  // the cluster's alpha_j [C][tpr], l [C], tile counts [C]
    at += (static_cast<size_t>(kMaxCluster) * (tpr + 2) * 4 + 15) / 16 * 16;
    total = at;
  }
};

template <class T>
__device__ __forceinline__ T* smem_at(uint8_t* base, size_t off) {
  return reinterpret_cast<T*>(base + off);
}

// byte e of u (an unsigned byte: the int8 value + 128) as the float
// int8 value: 2^23 + u under exponent 0x4B, minus 2^23 + 128 (exact)
template <int E>
__device__ __forceinline__ float i8_f(uint32_t u) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + E)) - 8388736.f;
}

// the same as a double: 2^52 + u, minus 2^52 + 128 (exact)
template <int E>
__device__ __forceinline__ double i8_d(uint32_t u) {
  return __hiloint2double(0x43300000, static_cast<int>(__byte_perm(u, 0u, 0x4440 + E))) -
         4503599627370624.0;
}

template <int MATH, int LPK, int NTH>
__global__ void __launch_bounds__(NTH, NTH == 128 ? 4 : 2)
attn_lab_kernel(const uint16_t* __restrict__ q,    // [B, H, D] bf16
                const int8_t* __restrict__ kq,     // [L, B, H, S, D]
                const uint16_t* __restrict__ ks,   // [L, B, H, S] bf16
                const int8_t* __restrict__ vq,
                const uint16_t* __restrict__ vs,
                const int* __restrict__ il_ptr,    // the layer, one int32
                const int* __restrict__ n_past,    // [B]
                float* __restrict__ out,           // [B, H, D]
                int L, int B, int H, int S, int D, float scale, int tpr,
                int vec16) {
  constexpr int kThreads = NTH, kWarps = NTH / 32;
  constexpr int NS = stages_of(LPK, NTH);
  constexpr int KPW = 32 / LPK;            // keys a warp takes at once
  constexpr int R = kThreads / LPK;        // row groups of the value pass
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const Layout lay(D, tpr, NTH);
  uint8_t* ring = smem + lay.ring;
  float* sc = smem_at<float>(smem, lay.sc);
  uint16_t* ks_s = smem_at<uint16_t>(smem, lay.ks);
  uint16_t* vs_s = smem_at<uint16_t>(smem, lay.vs);
  float* q_s = smem_at<float>(smem, lay.q);
  float* mt = smem_at<float>(smem, lay.mt);
  float* al = smem_at<float>(smem, lay.al);
  float* lt = smem_at<float>(smem, lay.lt);
  float* part = smem_at<float>(smem, lay.part);  // [dp] acc, then l, max, count
  float* part_l = part + lay.dp;
  float* part_max = part_l + 1;
  int* part_n = reinterpret_cast<int*>(part_max + 1);
  float* g_al = smem_at<float>(smem, lay.gath);
  float* g_l = g_al + kMaxCluster * tpr;
  int* g_n = reinterpret_cast<int*>(g_l + kMaxCluster);

  const int h = blockIdx.x / C, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int dp = lay.dp, row = lay.row, CH = dp / 16;
  const int il = min(max(*il_ptr, 0), L - 1);
  const size_t bh = (static_cast<size_t>(il) * B + b) * H + h;
  const int8_t* kbase = kq + bh * S * D;
  const int8_t* vbase = vq + bh * S * D;
  const uint16_t* ksb = ks + bh * S;
  const uint16_t* vsb = vs + bh * S;
  const int np = n_past[b];
  const int ts = min(kTile, S);
  const int nt = (S + ts - 1) / ts;
  // keys a tile may read: s <= n_past and s < S
  const int s_end = min(S, max(np + 1, 0));
  const int live_all = min(nt, (s_end + ts - 1) / ts);
  const int t0 = rank * tpr;                        // the rank's first tile
  const int T = max(0, min(live_all - t0, tpr));    // its live tiles

  // item k < 2T: the K rows of half k % 2 of tile t0 + k / 2; 2T <= k < 4T:
  // the V rows of half (k - 2T) % 2 of tile t0 + (k - 2T) / 2
  auto load_item = [&](int k) {
    const bool is_v = k >= 2 * T;
    const int kk = is_v ? k - 2 * T : k, j = kk >> 1, hf = kk & 1;
    const int s0 = (t0 + j) * ts + hf * kHalf;
    const int8_t* src = (is_v ? vbase : kbase) + static_cast<size_t>(s0) * D;
    uint8_t* dst = ring + (k % NS) * (static_cast<size_t>(kHalf) * row);
    const int nrows = min(min(ts - hf * kHalf, kHalf), s_end - s0);
    if (vec16) {
      for (int idx = tid; idx < kHalf * LPK; idx += kThreads) {
        const int r = idx / LPK, c = idx % LPK;
        if (c < CH)
          cp_async16(dst + r * row + c * 16,
                     r < nrows ? src + static_cast<size_t>(r) * D + c * 16 : src,
                     r < nrows);
      }
    } else {
      const int dw = D / 4;
      for (int idx = tid; idx < kHalf * 4 * LPK; idx += kThreads) {
        const int r = idx / (4 * LPK), w = idx % (4 * LPK);
        const bool ok = r < nrows && w < dw;
        if (w < dp / 4)
          cp_async4(dst + r * row + w * 4,
                    ok ? src + static_cast<size_t>(r) * D + w * 4 : src, ok);
      }
    }
  };

  // the ring: one commit group an item (empty past the last), so a wait's
  // count always names the same item
  const int items = 4 * T;
#pragma unroll
  for (int p = 0; p < NS - 1; ++p) {
    if (p < items) load_item(p);
    cp_async_commit();
  }

  // the rank's scales and q, by plain loads while the ring fills
  for (int i = tid; i < T * kTile; i += kThreads) {
    const int s = (t0 + i / kTile) * ts + i % kTile;
    const bool ok = i % kTile < ts && s < s_end;
    ks_s[i] = ok ? ksb[s] : 0;
    vs_s[i] = ok ? vsb[s] : 0;
  }
  for (int d = tid; d < dp; d += kThreads)
    q_s[d] = d < D ? bf16_to_float(q[(static_cast<size_t>(b) * H + h) * D + d]) : 0.f;

  __syncthreads();  // q_s
  const int kl = lane % LPK;  // this lane's 16-byte chunk of a row
  // q's 16 values of the chunk, widened once (mxu: to f64)
  std::conditional_t<MATH == kMxu, double, float> qv[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) qv[e] = kl < CH ? q_s[kl * 16 + e] : 0.f;
  float acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.f;
  const int vrg = tid / LPK;  // the value pass's row group

  // (a) the scores of half hf of tile j, masked past n_past and S, into sc[j]
  auto score_half = [&](const uint8_t* st, int j, int hf) {
    const int s0 = (t0 + j) * ts;
#pragma unroll
    for (int it = 0; it < (kHalf + kWarps * KPW - 1) / (kWarps * KPW); ++it) {
      const int kh = it * kWarps * KPW + warp * KPW + lane / LPK;
      const int key = hf * kHalf + kh;
      if (kh < kHalf) {
        const uint4 w = kl < CH ? *reinterpret_cast<const uint4*>(st + kh * row + kl * 16)
                                : make_uint4(0x80808080u, 0x80808080u, 0x80808080u,
                                             0x80808080u);
        const uint32_t u[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u,
                               w.z ^ 0x80808080u, w.w ^ 0x80808080u};
        float dot;
        if constexpr (MATH == kMxu) {
          // the exact dot rounded once: its terms are exact, and so are
          // their f64 sums, so no order of the sums changes a score
          double d = 0.0;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            d = fma(qv[4 * i + 0], i8_d<0>(u[i]), d);
            d = fma(qv[4 * i + 1], i8_d<1>(u[i]), d);
            d = fma(qv[4 * i + 2], i8_d<2>(u[i]), d);
            d = fma(qv[4 * i + 3], i8_d<3>(u[i]), d);
          }
#pragma unroll
          for (int o = LPK / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
          dot = static_cast<float>(d);
        } else {
          dot = 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dot = fmaf(qv[4 * i + 0], i8_f<0>(u[i]), dot);
            dot = fmaf(qv[4 * i + 1], i8_f<1>(u[i]), dot);
            dot = fmaf(qv[4 * i + 2], i8_f<2>(u[i]), dot);
            dot = fmaf(qv[4 * i + 3], i8_f<3>(u[i]), dot);
          }
#pragma unroll
          for (int o = LPK / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        }
        if (kl == 0) {
          const int s = s0 + key;
          sc[j * kTile + key] = key < ts && s < s_end
              ? dot * bf16_to_float(ks_s[j * kTile + key]) * scale : VSIM_NEG_INF;
        }
      }
    }
  };

  // (b) after the score pass: tile maxima, the cluster's prefix max, m_j,
  // alpha_j; (c) p, p vs (in place of the scores) and l_j
  auto boundary = [&]() {
    __syncthreads();  // every score is in sc
    for (int j = warp; j < T; j += kWarps) {
      float mx = VSIM_NEG_INF;
#pragma unroll
      for (int i = 0; i < kTile / 32; ++i) mx = fmaxf(mx, sc[j * kTile + lane + 32 * i]);
      mx = warp_max(mx);
      if (lane == 0) mt[j] = mx;
    }
    __syncthreads();
    if (tid == 0) {
      float mx = VSIM_NEG_INF;
      for (int j = 0; j < T; ++j) mx = fmaxf(mx, mt[j]);
      *part_max = mx;
      *part_n = T;
    }
    cluster.sync();
    if (warp == 0) {
      // the walk's running max before tile t0: the earlier ranks' maxima,
      // read together
      float m = lane < rank ? *cluster.map_shared_rank(part_max, lane) : VSIM_NEG_INF;
      m = warp_max(m);
      if (lane == 0) {
        for (int j = 0; j < T; ++j) {
          const float m_new = fmaxf(m, mt[j]);
          al[j] = m == VSIM_NEG_INF ? 0.f : expf(m - m_new);
          mt[j] = m_new;
          m = m_new;
        }
      }
    }
    __syncthreads();
    for (int j = warp; j < T; j += kWarps) {
      const float m = mt[j];
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < kTile / 32; ++i) {
        const int t = lane + 32 * i;
        const float s = sc[j * kTile + t];
        const float p = s == VSIM_NEG_INF ? 0.f : expf(s - m);
        psum += p;
        const float w = __fmul_rn(p, bf16_to_float(vs_s[j * kTile + t]));
        sc[j * kTile + t] = MATH == kMxu ? round_bf16(w) : w;
      }
      psum = warp_sum(psum);
      if (lane == 0) lt[j] = psum;
    }
    __syncthreads();
    if (tid == 0) {
      float l = 0.f;
      for (int j = 0; j < T; ++j) l = al[j] * l + lt[j];
      *part_l = l;
    }
  };

  // (c) the value pass of half hf of tile j: this thread's chunk of every
  // R-th row; acc takes the tile's alpha_j as the tile starts
  auto value_half = [&](const uint8_t* st, int j, int hf) {
    if (hf == 0) {
      const float a = al[j];
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] *= a;
    }
    if (kl < CH) {
#pragma unroll
      for (int i = 0; i < (kHalf + R - 1) / R; ++i) {
        const int kh = vrg + R * i;
        if (kh >= kHalf) break;
        const uint4 w = *reinterpret_cast<const uint4*>(st + kh * row + kl * 16);
        const float pw = sc[j * kTile + hf * kHalf + kh];
        const uint32_t u[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u,
                               w.z ^ 0x80808080u, w.w ^ 0x80808080u};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[4 * c + 0] = fmaf(pw, i8_f<0>(u[c]), acc[4 * c + 0]);
          acc[4 * c + 1] = fmaf(pw, i8_f<1>(u[c]), acc[4 * c + 1]);
          acc[4 * c + 2] = fmaf(pw, i8_f<2>(u[c]), acc[4 * c + 2]);
          acc[4 * c + 3] = fmaf(pw, i8_f<3>(u[c]), acc[4 * c + 3]);
        }
      }
    }
  };

  if (T == 0) boundary();
  for (int k = 0; k < items; ++k) {
    cp_async_wait<NS - 2>();  // item k landed
    __syncthreads();          // for every thread; item k - 1's stage is free
    if (k + NS - 1 < items) load_item(k + NS - 1);
    cp_async_commit();
    const uint8_t* st = ring + (k % NS) * (static_cast<size_t>(kHalf) * row);
    if (k < 2 * T) {
      score_half(st, k >> 1, k & 1);
      if (k == 2 * T - 1) boundary();
    } else {
      value_half(st, (k - 2 * T) >> 1, (k - 2 * T) & 1);
    }
  }
  cp_async_wait<0>();

  // (d) the block's acc summed over its row groups in order (over the ring)
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);  // [R][dp]
  if (kl < CH) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(red + vrg * dp + kl * 16 + 4 * c) =
          make_float4(acc[4 * c], acc[4 * c + 1], acc[4 * c + 2], acc[4 * c + 3]);
  }
  __syncthreads();
  for (int d = tid; d < dp; d += kThreads) {
    float s = 0.f;
    for (int r = 0; r < R; ++r) s += red[r * dp + d];
    part[d] = s;
  }
  cluster.sync();
  // the cluster's alpha_j, l and tile counts, and this thread's dim of every
  // rank's partial, in one round of reads through distributed shared memory
  for (int i = tid; i < C * tpr; i += kThreads)
    g_al[i] = cluster.map_shared_rank(al, i / tpr)[i % tpr];
  if (tid < C) {
    g_l[tid] = *cluster.map_shared_rank(part_l, tid);
    g_n[tid] = *cluster.map_shared_rank(part_n, tid);
  }
  // rank r outputs d = r, r + C, ... (two a thread at most: D <= 256)
  static_assert(2 * NTH >= 256, "two dims a thread cover D");
  float pd[2][kMaxCluster];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int d = rank + C * (tid + i * kThreads);
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      pd[i][r] = r < C && d < D ? cluster.map_shared_rank(part, r)[d] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int d = rank + C * (tid + i * kThreads);
    if (d >= D) continue;
    // the ranks folded in order, each earlier total scaled by the rank's
    // alpha_j one by one
    float acc_d = 0.f, l = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < C) {
        for (int j = 0; j < g_n[r]; ++j) {
          const float a = g_al[r * tpr + j];
          acc_d *= a;
          l *= a;
        }
        acc_d += pd[i][r];
        l += g_l[r];
      }
    }
    const float inv = l > 0.f ? 1.f / l : 0.f;
    out[(static_cast<size_t>(b) * H + h) * D + d] = acc_d * inv;
  }
  cluster.sync();  // no block leaves while another reads its partials
}

// A launch of B x H clusters of C blocks: grid (H C, B), clusters along x.
struct Launch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  Launch(int H, int B, int C, int nth, size_t smem, cudaStream_t stream) {
    cfg.gridDim = dim3(H * C, B);
    cfg.blockDim = dim3(nth);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

struct Args {
  const void *q, *kq, *ks, *vq, *vs, *il, *n_past;
  void* out;
  int L, B, H, S, D;
  float scale;
  int C, tpr, vec16;
  cudaStream_t stream;
};

template <int MATH, int LPK, int NTH>
cudaError_t prepare(size_t smem) {
  return cudaFuncSetAttribute(attn_lab_kernel<MATH, LPK, NTH>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int MATH, int LPK, int NTH>
cudaError_t launch_t(const Args& a) {
  const size_t smem = Layout(a.D, a.tpr, NTH).total;
  const cudaError_t err = prepare<MATH, LPK, NTH>(smem);
  if (err != cudaSuccess) return err;
  Launch l(a.H, a.B, a.C, NTH, smem, a.stream);
  return cudaLaunchKernelEx(
      &l.cfg, attn_lab_kernel<MATH, LPK, NTH>, static_cast<const uint16_t*>(a.q),
      static_cast<const int8_t*>(a.kq), static_cast<const uint16_t*>(a.ks),
      static_cast<const int8_t*>(a.vq), static_cast<const uint16_t*>(a.vs),
      static_cast<const int*>(a.il), static_cast<const int*>(a.n_past),
      static_cast<float*>(a.out), a.L, a.B, a.H, a.S, a.D, a.scale, a.tpr,
      a.vec16);
}

template <int MATH, int LPK, int NTH>
int max_clusters_t(int D, int tpr, int C) {
  const size_t smem = Layout(D, tpr, NTH).total;
  if (prepare<MATH, LPK, NTH>(smem) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  Launch l(C, 1, C, NTH, smem, nullptr);
  int count = 0;
  if (cudaOccupancyMaxActiveClusters(&count, attn_lab_kernel<MATH, LPK, NTH>, &l.cfg) !=
      cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return count;
}

template <int MATH, int NTH, class Op>
auto with_lanes(int lpk, const Op& op) {
  switch (lpk) {
    case 1: return op.template run<MATH, 1, NTH>();
    case 2: return op.template run<MATH, 2, NTH>();
    case 4: return op.template run<MATH, 4, NTH>();
    case 8: return op.template run<MATH, 8, NTH>();
    default: return op.template run<MATH, 16, NTH>();
  }
}

// The instance of (math, D, threads); each was checked.
template <class Op>
auto with_instance(int math, int D, int nth, const Op& op) {
  const int lpk = lanes_of(D);
  if (math == kMxu)
    return nth == 256 ? with_lanes<kMxu, 256>(lpk, op) : with_lanes<kMxu, 128>(lpk, op);
  return nth == 256 ? with_lanes<kVpu3d, 256>(lpk, op) : with_lanes<kVpu3d, 128>(lpk, op);
}

struct RunLaunch {
  const Args& a;
  template <int MATH, int LPK, int NTH>
  cudaError_t run() const { return launch_t<MATH, LPK, NTH>(a); }
};

struct RunMax {
  int D, tpr, C;
  template <int MATH, int LPK, int NTH>
  int run() const { return max_clusters_t<MATH, LPK, NTH>(D, tpr, C); }
};

bool valid_shape(int S, int D, int math, int threads, int C) {
  const int nt = (S + kTile - 1) / kTile;
  return S >= 1 && D >= 4 && D % 4 == 0 && D <= 256 && math >= kVpu3d &&
         math <= kMxu && (threads == 128 || threads == 256) && C >= 1 &&
         C <= kMaxCluster && (nt + C - 1) / C <= kMaxTiles;
}

}  // namespace

// math: the index in ATTN_VARIANTS; threads: a block's, 128 or 256;
// cluster: blocks a (b, h), each owning ceil(tiles / cluster) consecutive
// key tiles (at most kMaxTiles);
// D % 4 == 0, 4 <= D <= 256, the caches 4-byte aligned (16-byte aligned
// with D % 16 == 0 for 16-byte reads); il one int32 on the device, n_past
// [B] int32.
extern "C" int attn_lab_launch(const void* q, const void* kq, const void* ks,
                               const void* vq, const void* vs, const void* il,
                               const void* n_past, void* out, int L, int B,
                               int H, int S, int D, float scale, int math,
                               int threads, int cluster, void* stream) {
  if (L < 1 || B < 1 || H < 1 || !valid_shape(S, D, math, threads, cluster) ||
      il == nullptr || n_past == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nt = (S + kTile - 1) / kTile;
  const int tpr = (nt + cluster - 1) / cluster;
  const bool vec16 = D % 16 == 0 && reinterpret_cast<uintptr_t>(kq) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(vq) % 16 == 0;
  const Args a{q, kq, ks, vq, vs, il, n_past, out, L, B, H, S, D, scale,
               cluster, tpr, vec16 ? 1 : 0, static_cast<cudaStream_t>(stream)};
  const cudaError_t err = with_instance(math, D, threads, RunLaunch{a});
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of `cluster` blocks of `threads` the card holds at once for (S,
// D, math), 0 for a shape the kernel does not take (ops/attn_lab.py:
// attn_plan).
extern "C" int attn_lab_max_clusters(int S, int D, int math, int threads,
                                     int cluster) {
  if (!valid_shape(S, D, math, threads, cluster)) return 0;
  const int nt = (S + kTile - 1) / kTile;
  return with_instance(math, D, threads,
                       RunMax{D, (nt + cluster - 1) / cluster, cluster});
}
