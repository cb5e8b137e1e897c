// K15 q4_batch_lab: the batch lab's plane-split Q4 matmul on the tensor
// cores, y[n, O] = x[n, K] . W for 1 <= n <= 128 rows of bf16 x.
//
// Replaces tools/batch_lab.py:run_2d (:174; _k2d_f32x :65, _k2d_bsub :93,
// _k2d_bnos :117) and run_band (:251; _kband :191 under f32x, bsub, bnos).
// The weight is the plane-split repack: packed row c holds element c (low
// nibble, scale row c / 32) and element K/2 + c (high nibble, scale row
// K/64 + c / 32).  The plane fed to the tensor cores is, by MATH:
//   f32x  bf16((2^23 + v - (2^23 + 8)) s), s widened to f32
//   bsub  bf16(v - 8) x bf16 s, rounded once (bit-identical to f32x: the
//         product is exact in f32; a separate instruction sequence, which
//         is what the lab measures)
//   bnos  bf16(v s), the output initialised from corr [n, O] f32, which the
//         caller computes outside the kernel (-8 xs . s, xs the f32 block
//         sums of x), as XLA computes it outside the Pallas call
// and bf16 x times a bf16 plane is exact in f32, so mma.sync m16n8k16
// bf16 -> f32 computes the function; only the order of the f32 sums
// differs from the Pallas kernels'.
//
// Bound on the H100: the weight bytes up to about n = 80, the bf16
// operations beyond (GPT-J fc at n = 64: 37.7 MB, 11.3 us; 8.6 GFLOP, 8.7
// us; at n = 128 17.4 us of operations).  Design: K2's tensor-core instance
// (csrc/q4_matmul_ps.cu) with the dequant step templated on MATH and the
// walk on the geometry.  A block of 8 warps owns all n rows (padded to 16,
// 32, 64 or 128; rows past n are zero-filled and never stored) and a tile of
// 128 output columns; each step of 64 K-values (a group: 32 packed rows and
// their two scale rows) is loaded with 16-byte cp.async into a ring of 3-6
// stages with the x tile, dequantized one step ahead into shared memory as
// bf16, and fed by ldmatrix / ldmatrix.trans into mma.sync, one barrier a
// step.  The geometries (BAND):
//   2d    a block owns an O tile and walks all of K (the TPU's wide-O grid
//         with the k axis in the block); bnos starts its accumulators from
//         corr, as the body initialises its output;
//   band  a block owns a band of K across all of O, walking the O tiles in
//         order, each a run of its band's steps (the H100 reading of the
//         TPU's whole-O row bands: the band's rows are read across all of O
//         by one block), and writes each tile's f32 partials to a scratch
//         [bands, n, O]; a second launch sums them in band order after corr
//         (bnos) or 0, so results are the same from run to run.  The
//         wrapper picks the band count from the shapes: each band more adds
//         n O 8 bytes of partials and takes work off the busiest SM.
// The two geometries compute the same function and differ only in the
// order of the f32 sums.

#include "common.cuh"

namespace {

// the maths, in the order of vsim_tpu_torch/ops/q4_batch_lab.py:BATCH_MATHS
enum BatchMath { kF32x, kBsub, kBnos, kNumMaths };

constexpr int kThreads = 256;      // 8 warps
constexpr int kBN = 128;           // output columns per tile
constexpr int kKS = 64;            // K values per step: 32 lo + 32 hi
constexpr int kWS = kBN + 8;       // bf16 row stride of the weight tile
constexpr int kXS = kKS + 8;       // bf16 row stride of the x tile
constexpr int kRawBytes = 32 * kBN + 2 * kBN * 2;  // packed rows + 2 scale rows

// Ring depth by row tile, as K2's: the fewer rows, the less a step computes,
// so the more steps are kept in flight (two blocks an SM at every depth).
template <int BM>
struct Ring {
  static constexpr int kStages = BM <= 32 ? 6 : (BM == 64 ? 4 : 3);
  static constexpr size_t kSmem =
      kStages * kRawBytes + 2 * (2 * kKS * kWS + kStages * BM * kXS);
};

// The packed bytes and both scale rows of group g at columns [o0, o0 + 128)
// and the x tile of its 64 K-values into ring stage ``raw`` / ``xt``, by
// cp.async (O % 16 == 0 and 16-byte aligned operands: the wrapper checks);
// columns past O and rows past n are zero-filled.
template <int BM>
__device__ __forceinline__ void load_step(uint8_t* raw, uint16_t* xt,
                                          const uint16_t* x,
                                          const uint8_t* packed,
                                          const uint16_t* scales, int g, int G,
                                          int o0, int n, int K, int O) {
  const int tid = threadIdx.x;
  uint16_t* rsc = reinterpret_cast<uint16_t*>(raw + 32 * kBN);  // [2][kBN]
  {  // packed: 32 rows x 8 chunks of 16 bytes, one a thread
    const int r = tid / 8, c = (tid % 8) * 16;
    const bool ok = o0 + c < O;
    cp_async16(raw + r * kBN + c,
               ok ? packed + static_cast<size_t>(g * 32 + r) * O + o0 + c : packed,
               ok);
  }
  if (tid < 32) {  // scale rows g and G + g: 2 x 16 chunks of 8
    const int which = tid / 16, c = (tid % 16) * 8;
    const bool ok = o0 + c < O;
    cp_async16(rsc + which * kBN + c,
               ok ? scales + static_cast<size_t>(which ? G + g : g) * O + o0 + c
                  : scales,
               ok);
  }
  const int half_k = K / 2;
  for (int idx = tid; idx < BM * 8; idx += kThreads) {  // 4 chunks a plane
    const int m = idx / 8, cc = idx % 8;
    const int k = (cc < 4 ? 0 : half_k) + g * 32 + (cc % 4) * 8;
    const bool ok = m < n;
    cp_async16(xt + m * kXS + cc * 8, ok ? x + static_cast<size_t>(m) * K + k : x,
               ok);
  }
}

// Four nibbles (bytes of ``nib``, each < 16) and their four bf16 scales (two
// pairs) -> the weights of the 4 columns as two bf16 pairs, under MATH.
template <int MATH>
__device__ __forceinline__ void dequant4(uint32_t nib, uint2 s2, uint32_t& p01,
                                         uint32_t& p23) {
  if constexpr (MATH == kF32x) {
    // 0x4B000000 | v (2^23 + v), minus 2^23 + 8, times s in f32, rounded
    float s0, s1, s2f, s3;
    unpack_bf16x2(s2.x, s0, s1);
    unpack_bf16x2(s2.y, s2f, s3);
    p01 = pack_bf16(nib_f<0>(nib) * s0, nib_f<1>(nib) * s1);
    p23 = pack_bf16(nib_f<2>(nib) * s2f, nib_f<3>(nib) * s3);
  } else {
    // int (v - 8) (bsub) or v (bnos), converted to bf16 (exact), times the
    // bf16 scale pair with one rounding (fma with -0)
    constexpr int off = MATH == kBsub ? 8 : 0;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = static_cast<float>(static_cast<int>((nib >> (8 * j)) & 0xFu) - off);
    p01 = fma_bf16x2(pack_bf16(v[0], v[1]), s2.x, 0x80008000u);
    p23 = fma_bf16x2(pack_bf16(v[2], v[3]), s2.y, 0x80008000u);
  }
}

template <int BM, int MATH, bool BAND>
__global__ void __launch_bounds__(kThreads)
batch_mma_kernel(const uint16_t* __restrict__ x,       // [n, K] bf16
                 const uint8_t* __restrict__ packed,   // [K/2, O] plane-split
                 const uint16_t* __restrict__ scales,  // [K/32, O] bf16
                 const float* __restrict__ corr,       // bnos, 2d: [n, O]
                 float* __restrict__ dst,  // 2d: [n, O]; band: [bands, n, O]
                 int n, int K, int O) {
  constexpr int WARPS_M = BM >= 32 ? 2 : 1;
  constexpr int WARPS_N = 8 / WARPS_M;
  constexpr int MI = BM / WARPS_M / 16;    // 16-row m-tiles of a warp
  constexpr int NI = kBN / WARPS_N / 8;    // 8-column n-tiles of a warp
  static_assert(NI % 2 == 0, "n-tiles come in ldmatrix.x4.trans pairs");
  constexpr int S = Ring<BM>::kStages;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* raw = smem;  // [S][kRawBytes]
  uint16_t* ws = reinterpret_cast<uint16_t*>(smem + S * kRawBytes);  // [2][kKS][kWS]
  uint16_t* xs = ws + 2 * kKS * kWS;  // [S][BM][kXS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int gid = lane / 4, qid = lane % 4;
  const int G = K / 64;
  // the block's walk: 2d, one tile over all G groups; band, every tile over
  // the band's groups [g_begin, g_begin + ng)
  const int tiles = BAND ? (O + kBN - 1) / kBN : 1;
  const int band = blockIdx.x, bands = gridDim.x;
  const int g_begin = BAND ? static_cast<int>(static_cast<long long>(G) * band / bands) : 0;
  const int ng = BAND ? static_cast<int>(static_cast<long long>(G) * (band + 1) / bands) - g_begin
                      : G;
  const int steps = tiles * ng;
  auto tile_o0 = [&](int it) { return (BAND ? it / ng : static_cast<int>(blockIdx.x)) * kBN; };
  auto group = [&](int it) { return g_begin + it % ng; };
  // ldmatrix addresses of this lane in an A tile and a pair of B tiles
  const int a_row = wm * (BM / WARPS_M) + (lane % 16), a_col = (lane / 16) * 8;
  const int b_row = (lane % 8) + ((lane / 8) % 2) * 8, b_col = (lane / 16) * 8;

  // this thread's accumulator element (mi, ni, e) is row m, column o of the
  // tile at o0
  auto elem_row = [&](int mi, int e) {
    return wm * (BM / WARPS_M) + mi * 16 + gid + (e >= 2 ? 8 : 0);
  };
  auto elem_col = [&](int o0, int ni, int e) {
    return o0 + wn * (kBN / WARPS_N) + ni * 8 + 2 * qid + (e & 1);
  };

  float acc[MI][NI][4];
  auto init_acc = [&](int o0) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = elem_row(mi, e), o = elem_col(o0, ni, e);
          acc[mi][ni][e] = (!BAND && MATH == kBnos && m < n && o < O)
                               ? corr[static_cast<size_t>(m) * O + o] : 0.f;
        }
  };
  auto store_acc = [&](int o0) {
    float* d = dst + (BAND ? static_cast<size_t>(band) * n * O : 0);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = elem_row(mi, e), o = elem_col(o0, ni, e);
          if (m < n && o < O) d[static_cast<size_t>(m) * O + o] = acc[mi][ni][e];
        }
  };

  // 16 packed bytes a thread of step ``it`` -> 16 lo and 16 hi bf16 weights
  // in weight buffer it % 2
  auto dequant = [&](int it) {
    const uint8_t* rs = raw + (it % S) * kRawBytes;
    const uint16_t* rsc = reinterpret_cast<const uint16_t*>(rs + 32 * kBN);
    const int r = tid / 8, c = (tid % 8) * 16;
    const uint4 bytes = *reinterpret_cast<const uint4*>(rs + r * kBN + c);
    const uint32_t bw[4] = {bytes.x, bytes.y, bytes.z, bytes.w};
    uint32_t lo[8], hi[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // bytes 4q .. 4q + 3: columns c + 4q ..
      const uint32_t l = bw[q] & 0x0F0F0F0Fu, h = (bw[q] >> 4) & 0x0F0F0F0Fu;
      const uint2 s2l = *reinterpret_cast<const uint2*>(rsc + c + 4 * q);
      const uint2 s2h = *reinterpret_cast<const uint2*>(rsc + kBN + c + 4 * q);
      dequant4<MATH>(l, s2l, lo[2 * q], lo[2 * q + 1]);
      dequant4<MATH>(h, s2h, hi[2 * q], hi[2 * q + 1]);
    }
    uint16_t* wt = ws + (it % 2) * kKS * kWS;
    uint4* wl = reinterpret_cast<uint4*>(wt + r * kWS + c);
    uint4* wh = reinterpret_cast<uint4*>(wt + (32 + r) * kWS + c);
    wl[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    wl[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
    wh[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    wh[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
  };

  init_acc(tile_o0(0));
  // one commit group a step (empty past the last), so a wait's count always
  // names the same step; the weights of step it + 1 are dequantized while
  // step it runs on the tensor cores, with one barrier a step
#pragma unroll
  for (int p = 0; p < S - 1; ++p) {
    if (p < steps)
      load_step<BM>(raw + p * kRawBytes, xs + p * BM * kXS, x, packed, scales,
                    group(p), G, tile_o0(p), n, K, O);
    cp_async_commit();
  }
  cp_async_wait<S - 2>();  // step 0 landed
  __syncthreads();
  dequant(0);
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<S - 3>();  // step it + 1 landed
    // ws[it % 2] is complete, and every warp is done with step it - 1
    __syncthreads();
    if (it + S - 1 < steps) {  // into the stage step it - 1 used
      const int ps = (it + S - 1) % S;
      load_step<BM>(raw + ps * kRawBytes, xs + ps * BM * kXS, x, packed, scales,
                    group(it + S - 1), G, tile_o0(it + S - 1), n, K, O);
    }
    cp_async_commit();
    if (it + 1 < steps) dequant(it + 1);
    const uint16_t* xt = xs + (it % S) * BM * kXS;
    const uint16_t* wt = ws + (it % 2) * kKS * kWS;
#pragma unroll
    for (int kk = 0; kk < kKS / 16; ++kk) {
      uint32_t a[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldmatrix_x4(a[mi], xt + (a_row + mi * 16) * kXS + kk * 16 + a_col);
#pragma unroll
      for (int np = 0; np < NI / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, wt + (kk * 16 + b_row) * kWS
                                 + wn * (kBN / WARPS_N) + np * 16 + b_col);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          mma_bf16(acc[mi][2 * np], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
        }
      }
    }
    if (it % ng == ng - 1) {  // the tile's last group: its sums are done
      store_acc(tile_o0(it));
      if (BAND && it + 1 < steps) init_acc(tile_o0(it + 1));
    }
  }
  cp_async_wait<0>();
}

// Band's second pass: out = corr (bnos) or 0, plus the partials in band order.
__global__ void band_reduce_kernel(const float* __restrict__ partial,
                                   const float* __restrict__ corr,
                                   float* __restrict__ out, int total,
                                   int bands) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float s = corr ? corr[idx] : 0.f;
  for (int b = 0; b < bands; ++b) s += partial[static_cast<size_t>(b) * total + idx];
  out[idx] = s;
}

template <int BM, int MATH, bool BAND>
cudaError_t launch_t(const uint16_t* x, const uint8_t* packed,
                     const uint16_t* scales, const float* corr, float* dst,
                     int n, int K, int O, int blocks, cudaStream_t s) {
  auto kern = batch_mma_kernel<BM, MATH, BAND>;
  constexpr size_t smem = Ring<BM>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<blocks, kThreads, smem, s>>>(x, packed, scales, corr, dst, n, K, O);
  return cudaGetLastError();
}

template <int MATH, bool BAND>
cudaError_t launch_rows(const uint16_t* x, const uint8_t* packed,
                        const uint16_t* scales, const float* corr, float* dst,
                        int n, int K, int O, int blocks, cudaStream_t s) {
  if (n <= 16) return launch_t<16, MATH, BAND>(x, packed, scales, corr, dst, n, K, O, blocks, s);
  if (n <= 32) return launch_t<32, MATH, BAND>(x, packed, scales, corr, dst, n, K, O, blocks, s);
  if (n <= 64) return launch_t<64, MATH, BAND>(x, packed, scales, corr, dst, n, K, O, blocks, s);
  return launch_t<128, MATH, BAND>(x, packed, scales, corr, dst, n, K, O, blocks, s);
}

template <bool BAND>
cudaError_t launch_math(int math, const uint16_t* x, const uint8_t* packed,
                        const uint16_t* scales, const float* corr, float* dst,
                        int n, int K, int O, int blocks, cudaStream_t s) {
  switch (math) {
    case kF32x: return launch_rows<kF32x, BAND>(x, packed, scales, corr, dst, n, K, O, blocks, s);
    case kBsub: return launch_rows<kBsub, BAND>(x, packed, scales, corr, dst, n, K, O, blocks, s);
    default: return launch_rows<kBnos, BAND>(x, packed, scales, corr, dst, n, K, O, blocks, s);
  }
}

}  // namespace

// y [n, O] f32 for 1 <= n <= 128, K % 64 == 0, O % 16 == 0 and 16-byte
// aligned x, packed and scales.  math: the index in BATCH_MATHS; corr [n, O]
// f32 for bnos only.  band = 0: one block an O tile; band = 1: ``bands``
// blocks (1 <= bands <= K/64) write ``partial`` [bands, n, O], then a
// second launch sums it into ``out``.
extern "C" int q4_batch_lab_launch(const void* x, const void* packed,
                                   const void* scales, const void* corr,
                                   void* partial, void* out, int n, int K,
                                   int O, int math, int band, int bands,
                                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (n < 1 || n > 128 || K < 64 || K % 64 || O < 16 || O % 16 || math < 0 ||
      math >= kNumMaths || (math == kBnos) != (corr != nullptr) ||
      !aligned(x) || !aligned(packed) || !aligned(scales) ||
      (band && (bands < 1 || bands > K / 64 || partial == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto xp = static_cast<const uint16_t*>(x);
  auto pp = static_cast<const uint8_t*>(packed);
  auto sp = static_cast<const uint16_t*>(scales);
  auto cp = static_cast<const float*>(corr);
  auto op = static_cast<float*>(out);
  if (!band)
    return static_cast<int>(launch_math<false>(math, xp, pp, sp, cp, op, n, K, O,
                                               (O + kBN - 1) / kBN, s));
  auto part = static_cast<float*>(partial);
  cudaError_t err = launch_math<true>(math, xp, pp, sp, cp, part, n, K, O, bands, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = n * O;
  band_reduce_kernel<<<(total + 255) / 256, 256, 0, s>>>(part, cp, op, total, bands);
  return static_cast<int>(cudaGetLastError());
}
