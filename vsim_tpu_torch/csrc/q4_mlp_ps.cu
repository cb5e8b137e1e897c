// K11 q4_mlp_ps: out[n, E] = act(x[n, E] . Wfc^T + bfc) . Wproj^T + bproj for
// plane-split Q4_0 fc ([E/2, F] packed) and proj ([F/2, E] packed) weights,
// n <= 8 rows (the decode MLP under a non-gi dequant math).
//
// Replaces vsim_tpu/ops/pallas_q4.py:_kernel_mlp_ps (:679): x in f32, both
// weights' planes (v - 8) * s in f32 (the f32xf math, whatever the math
// setting), h = x Wfc + bfc and act(h) in f32 and never rounded, then
// out = bproj + act(h) Wproj in f32.  act is gelu_tanh, relu, or exact GELU
// through the Abramowitz-Stegun 7.1.26 erf polynomial the TPU kernel uses
// (_erf_poly).
//
// Bound on the H100: the weight bytes (both weights, 0.5625 B per
// parameter; at n <= 8 each byte feeds at most 32 multiply-adds).  Design:
// block t owns the paired F ranges [t*64, t*64 + 64) and [F/2 + t*64, ...),
// which are exactly the lo/hi planes of proj's packed rows [t*64, t*64 + 64),
// so the [n, F] intermediate never leaves the chip.  Phase A: the 8 warps
// split fc's E/2 packed rows (16-row chunks, x staged in shared memory slab
// by slab); in each warp, lanes 0-15 read 4 lo-range columns and lanes 16-31
// 4 hi-range columns of a packed row (two 64-byte runs); the 8 warps'
// partial sums of the block's 128 h columns meet in shared memory, where
// they are summed in warp order, biased and activated.  Phase B: the block
// multiplies its 64 proj rows (a thread owns 4 neighbouring output columns,
// a warp reads 128 contiguous bytes of a row) into an f32 [n, E] partial;
// a second pass sums the F/128 partials in block order with bproj.  No
// atomics: outputs are identical from run to run.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBFh = 64;       // F columns per plane per block
constexpr int kSlab = 128;     // fc packed rows staged per slab
constexpr int kChunk = 16;     // fc packed rows per warp step

enum { kGeluTanh = 0, kRelu = 1, kGeluExact = 2 };

__device__ __forceinline__ float erf_poly(float x) {
  const float ax = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * ax);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float y = 1.0f - poly * expf(-ax * ax);
  return x < 0.f ? -y : y;
}

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if (ACT == kGeluTanh)
    return 0.5f * v *
           (1.0f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
  if (ACT == kRelu) return fmaxf(v, 0.f);
  return 0.5f * v * (1.0f + erf_poly(v * 0.7071067811865476f));
}

__device__ __forceinline__ void scales4(const uint16_t* p, float s[4]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  s[0] = bf16_to_float(w.x & 0xFFFFu);
  s[1] = bf16_to_float(w.x >> 16);
  s[2] = bf16_to_float(w.y & 0xFFFFu);
  s[3] = bf16_to_float(w.y >> 16);
}

__device__ __forceinline__ void planes4(uint32_t w, const float sl[4],
                                        const float sh[4], float wl[4],
                                        float wh[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wl[j] = static_cast<float>(static_cast<int>((w >> (8 * j)) & 0xFu) - 8) * sl[j];
    wh[j] = static_cast<float>(static_cast<int>((w >> (8 * j + 4)) & 0xFu) - 8) * sh[j];
  }
}

template <int N, int ACT>
__global__ void __launch_bounds__(kThreads)
mlp_ps_kernel(const void* __restrict__ xv, int x_is_bf16,  // [N, E]
              const uint8_t* __restrict__ pfc,     // [E/2, F]
              const uint16_t* __restrict__ sfc,    // [E/32, F] bf16
              const float* __restrict__ bfc,       // [F] or null
              const uint8_t* __restrict__ pproj,   // [F/2, E]
              const uint16_t* __restrict__ sproj,  // [F/32, E] bf16
              float* __restrict__ partial,         // [F/128, N, E]
              int E, int F) {
  __shared__ float xs[N][2][kSlab];                // x planes of the slab
  __shared__ __align__(16) float red[kWarps][N][2 * kBFh];
  __shared__ float hs[N][2 * kBFh];                // act(h): lo | hi columns
  const int t = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int half_e = E / 2, half_f = F / 2;

  // ---- phase A: h = x Wfc for the block's 2 x 64 columns ----
  const int lc = lane < 16 ? 4 * lane : kBFh + 4 * (lane - 16);  // local col
  const int fcol = lane < 16 ? t * kBFh + 4 * lane
                             : half_f + t * kBFh + 4 * (lane - 16);
  float acc[N][4];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < half_e; c0 += kSlab) {
    const int rows = min(kSlab, half_e - c0);  // a multiple of 32
    __syncthreads();
    for (int idx = tid; idx < N * 2 * rows; idx += kThreads) {
      const int i = idx / (2 * rows);
      const int rem = idx - i * 2 * rows;
      const int p = rem / rows;
      const int r = rem - p * rows;
      const size_t off = static_cast<size_t>(i) * E + p * half_e + c0 + r;
      xs[i][p][r] = x_is_bf16
                        ? bf16_to_float(static_cast<const uint16_t*>(xv)[off])
                        : static_cast<const float*>(xv)[off];
    }
    __syncthreads();
    for (int ch = warp; ch * kChunk < rows; ch += kWarps) {
      const int c = c0 + ch * kChunk;  // 16 rows inside one 32-row group
      float sl[4], sh[4];
      scales4(sfc + static_cast<size_t>(c / 32) * F + fcol, sl);
      scales4(sfc + static_cast<size_t>(half_e / 32 + c / 32) * F + fcol, sh);
      const uint8_t* prow = pfc + static_cast<size_t>(c) * F + fcol;
#pragma unroll 4
      for (int r = 0; r < kChunk; ++r) {
        const uint32_t w =
            *reinterpret_cast<const uint32_t*>(prow + static_cast<size_t>(r) * F);
        float wl[4], wh[4];
        planes4(w, sl, sh, wl, wh);
        const int rr = ch * kChunk + r;
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float xl = xs[i][0][rr], xh = xs[i][1][rr];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(xh, wh[j], fmaf(xl, wl[j], acc[i][j]));
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    *reinterpret_cast<float4*>(&red[warp][i][lc]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();
  for (int idx = tid; idx < N * 2 * kBFh; idx += kThreads) {
    const int i = idx / (2 * kBFh), c = idx % (2 * kBFh);
    float h = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) h += red[w][i][c];
    if (bfc) h += bfc[c < kBFh ? t * kBFh + c : half_f + t * kBFh + c - kBFh];
    hs[i][c] = activate<ACT>(h);
  }
  __syncthreads();

  // ---- phase B: partial[t] = act(h) . proj rows [t*64, t*64 + 64) ----
  const int g_lo = t * kBFh / 32;      // first lo scale row of the block
  const int g_hi = half_f / 32 + g_lo;  // first hi scale row
  for (int col = 4 * tid; col < E; col += 4 * kThreads) {
    float o[N][4];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
#pragma unroll
    for (int half = 0; half < kBFh / 32; ++half) {
      float sl[4], sh[4];
      scales4(sproj + static_cast<size_t>(g_lo + half) * E + col, sl);
      scales4(sproj + static_cast<size_t>(g_hi + half) * E + col, sh);
      const uint8_t* prow =
          pproj + static_cast<size_t>(t * kBFh + half * 32) * E + col;
#pragma unroll 4
      for (int r = 0; r < 32; ++r) {
        const uint32_t w =
            *reinterpret_cast<const uint32_t*>(prow + static_cast<size_t>(r) * E);
        float wl[4], wh[4];
        planes4(w, sl, sh, wl, wh);
        const int rr = half * 32 + r;
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float hl = hs[i][rr], hh = hs[i][kBFh + rr];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            o[i][j] = fmaf(hh, wh[j], fmaf(hl, wl[j], o[i][j]));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i)
      *reinterpret_cast<float4*>(
          partial + (static_cast<size_t>(t) * N + i) * E + col) =
          make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
  }
}

// Second pass: out = bproj + sum over blocks of the partials, in block order.
__global__ void mlp_reduce_kernel(const float* __restrict__ partial,
                                  const float* __restrict__ bproj,
                                  float* __restrict__ out, int n, int E,
                                  int blocks) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * E) return;
  float s = bproj ? bproj[idx % E] : 0.f;
  for (int b = 0; b < blocks; ++b)
    s += partial[static_cast<size_t>(b) * n * E + idx];
  out[idx] = s;
}

template <int N>
void launch_n(int act, const void* x, int x_is_bf16, const uint8_t* pfc,
              const uint16_t* sfc, const float* bfc, const uint8_t* pproj,
              const uint16_t* sproj, float* partial, int E, int F,
              cudaStream_t s) {
  const int blocks = F / (2 * kBFh);
  if (act == kGeluTanh)
    mlp_ps_kernel<N, kGeluTanh><<<blocks, kThreads, 0, s>>>(
        x, x_is_bf16, pfc, sfc, bfc, pproj, sproj, partial, E, F);
  else if (act == kRelu)
    mlp_ps_kernel<N, kRelu><<<blocks, kThreads, 0, s>>>(
        x, x_is_bf16, pfc, sfc, bfc, pproj, sproj, partial, E, F);
  else
    mlp_ps_kernel<N, kGeluExact><<<blocks, kThreads, 0, s>>>(
        x, x_is_bf16, pfc, sfc, bfc, pproj, sproj, partial, E, F);
}

}  // namespace

extern "C" int q4_mlp_ps_launch(const void* x, int x_is_bf16,
                                const void* fc_packed, const void* fc_scales,
                                const void* fc_bias, const void* proj_packed,
                                const void* proj_scales,
                                const void* proj_bias, void* partial,
                                void* out, int n, int E, int F, int act,
                                void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto pfc = static_cast<const uint8_t*>(fc_packed);
  auto sfc = static_cast<const uint16_t*>(fc_scales);
  auto bfc = static_cast<const float*>(fc_bias);
  auto pp = static_cast<const uint8_t*>(proj_packed);
  auto sp = static_cast<const uint16_t*>(proj_scales);
  auto part = static_cast<float*>(partial);
  if (E % 64 || E % 4 || F % (2 * kBFh) || act < 0 || act > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (n) {
    case 1: launch_n<1>(act, x, x_is_bf16, pfc, sfc, bfc, pp, sp, part, E, F, s); break;
    case 2: launch_n<2>(act, x, x_is_bf16, pfc, sfc, bfc, pp, sp, part, E, F, s); break;
    case 3: launch_n<3>(act, x, x_is_bf16, pfc, sfc, bfc, pp, sp, part, E, F, s); break;
    case 4: launch_n<4>(act, x, x_is_bf16, pfc, sfc, bfc, pp, sp, part, E, F, s); break;
    case 5: launch_n<5>(act, x, x_is_bf16, pfc, sfc, bfc, pp, sp, part, E, F, s); break;
    case 6: launch_n<6>(act, x, x_is_bf16, pfc, sfc, bfc, pp, sp, part, E, F, s); break;
    case 7: launch_n<7>(act, x, x_is_bf16, pfc, sfc, bfc, pp, sp, part, E, F, s); break;
    case 8: launch_n<8>(act, x, x_is_bf16, pfc, sfc, bfc, pp, sp, part, E, F, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = n * E;
  mlp_reduce_kernel<<<(total + 255) / 256, 256, 0, s>>>(
      part, static_cast<const float*>(proj_bias), static_cast<float*>(out), n,
      E, F / (2 * kBFh));
  return static_cast<int>(cudaGetLastError());
}
