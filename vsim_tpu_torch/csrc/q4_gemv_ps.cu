// K1 q4_gemv_ps: y[n, O] = x[n, K] . W^T (+ bias) for a plane-split Q4_0
// weight, n <= 8 rows of bf16 activations (the decode matmuls).
//
// Replaces vsim_tpu/ops/pallas_q4.py:_kernel_ps_giw (:339, the qkv/wo/fc/
// proj decode matmuls) and _kernel_ps_gi / _kernel_ps_gi_bias (:293, :315,
// the lm head), with the same grouped-integer ("gi") math: nibbles enter as
// exact integers v in 0..15, and per 32-row group g
//   y += s_lo[g] (sum x_lo v_lo - 8 sum x_lo) + s_hi[g] (sum x_hi v_hi - 8 sum x_hi)
// where packed row c holds element c (low nibble, scale row c/32) and element
// K/2 + c (high nibble, scale row K/64 + c/32).  x is bf16 on entry, so the
// kernel sees the bf16-rounded x that _gi_rescale sees.
//
// Bound on the H100: bytes.  At n <= 8 every weight byte is used for at most
// 16 multiply-adds, under the ~9 per byte at which f32 FMA throughput and
// HBM bandwidth cross, so the weight stream (0.5625 B per parameter) sets the
// time.  Design: a thread owns 4 neighbouring output columns and reads one
// 4-byte word of a packed row per step, so a warp reads 128 contiguous bytes
// of the K-major row.  x for a slab of 8 groups per plane sits in shared
// memory (16 KB at n = 8, which also bounds K: proj's 256 KB of bf16 x never
// has to fit).  Too few column tiles for 132 SMs at O = 4096 is met by
// splitting the groups of K across blockIdx.y; the splits write f32
// partials that a second pass sums with the bias (deterministic, no atomics).
// Group ranges are whole 32-row groups: the wrapper rejects K % 64 != 0.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;                       // output columns per thread
constexpr int kTileO = kThreads * kCols;       // 1024 columns per block
constexpr int kSlabG = 8;                      // groups per plane in smem

template <int N>
__global__ void __launch_bounds__(kThreads)
gemv_ps_kernel(const uint16_t* __restrict__ x,       // [N, K] bf16
               const uint8_t* __restrict__ packed,   // [K/2, O]
               const uint16_t* __restrict__ scales,  // [K/32, O] bf16
               const float* __restrict__ bias,       // [O] or null
               float* __restrict__ dst,  // [N, O] (splits == 1) or [splits, N, O]
               int K, int O, int splits) {
  __shared__ float xs[N][2][kSlabG * 32];
  const int half_k = K / 2;
  const int G = half_k / 32;  // groups per plane
  const int split = blockIdx.y;
  const int g_begin = static_cast<int>(static_cast<long long>(G) * split / splits);
  const int g_end = static_cast<int>(static_cast<long long>(G) * (split + 1) / splits);
  const int col = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  const bool active = col < O;  // O % 4 == 0, so a thread is all in or all out

  float acc[N][kCols];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  for (int g0 = g_begin; g0 < g_end; g0 += kSlabG) {
    const int ng = min(kSlabG, g_end - g0);
    const int rows = ng * 32;
    __syncthreads();  // the previous slab is consumed
    for (int idx = threadIdx.x; idx < N * 2 * rows; idx += kThreads) {
      const int i = idx / (2 * rows);
      const int rem = idx - i * 2 * rows;
      const int p = rem / rows;
      const int r = rem - p * rows;
      xs[i][p][r] = bf16_to_float(
          x[static_cast<size_t>(i) * K + p * half_k + g0 * 32 + r]);
    }
    __syncthreads();
    if (!active) continue;
    for (int gg = 0; gg < ng; ++gg) {
      const int g = g0 + gg;
      float plo[N][kCols], phi[N][kCols], xsl[N], xsh[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        xsl[i] = 0.f;
        xsh[i] = 0.f;
#pragma unroll
        for (int j = 0; j < kCols; ++j) plo[i][j] = phi[i][j] = 0.f;
      }
      const uint8_t* prow = packed + static_cast<size_t>(g) * 32 * O + col;
#pragma unroll 8
      for (int r = 0; r < 32; ++r) {
        const uint32_t w =
            *reinterpret_cast<const uint32_t*>(prow + static_cast<size_t>(r) * O);
        float vlo[kCols], vhi[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          vlo[j] = static_cast<float>((w >> (8 * j)) & 0xFu);
          vhi[j] = static_cast<float>((w >> (8 * j + 4)) & 0xFu);
        }
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float xl = xs[i][0][gg * 32 + r];
          const float xh = xs[i][1][gg * 32 + r];
          xsl[i] += xl;
          xsh[i] += xh;
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            plo[i][j] = fmaf(xl, vlo[j], plo[i][j]);
            phi[i][j] = fmaf(xh, vhi[j], phi[i][j]);
          }
        }
      }
      const uint2 sl = *reinterpret_cast<const uint2*>(
          scales + static_cast<size_t>(g) * O + col);
      const uint2 sh = *reinterpret_cast<const uint2*>(
          scales + static_cast<size_t>(G + g) * O + col);
      const float s_lo[kCols] = {
          bf16_to_float(sl.x & 0xFFFFu), bf16_to_float(sl.x >> 16),
          bf16_to_float(sl.y & 0xFFFFu), bf16_to_float(sl.y >> 16)};
      const float s_hi[kCols] = {
          bf16_to_float(sh.x & 0xFFFFu), bf16_to_float(sh.x >> 16),
          bf16_to_float(sh.y & 0xFFFFu), bf16_to_float(sh.y >> 16)};
#pragma unroll
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          acc[i][j] += s_lo[j] * (plo[i][j] - 8.f * xsl[i]) +
                       s_hi[j] * (phi[i][j] - 8.f * xsh[i]);
    }
  }
  if (!active) return;
  if (splits == 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float4 o;
      o.x = acc[i][0] + (bias ? bias[col + 0] : 0.f);
      o.y = acc[i][1] + (bias ? bias[col + 1] : 0.f);
      o.z = acc[i][2] + (bias ? bias[col + 2] : 0.f);
      o.w = acc[i][3] + (bias ? bias[col + 3] : 0.f);
      *reinterpret_cast<float4*>(dst + static_cast<size_t>(i) * O + col) = o;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float4 o = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(
          dst + (static_cast<size_t>(split) * N + i) * O + col) = o;
    }
  }
}

// Second pass: out = bias + sum over splits of the partials.
__global__ void split_reduce_kernel(const float* __restrict__ partial,
                                    const float* __restrict__ bias,
                                    float* __restrict__ out, int n, int O,
                                    int splits) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * O) return;
  float s = bias ? bias[idx % O] : 0.f;
  for (int k = 0; k < splits; ++k)
    s += partial[static_cast<size_t>(k) * n * O + idx];
  out[idx] = s;
}

template <int N>
void launch_n(const uint16_t* x, const uint8_t* packed, const uint16_t* scales,
              const float* bias, float* partial, float* out, int K, int O,
              int splits, cudaStream_t stream) {
  const dim3 grid((O + kTileO - 1) / kTileO, splits);
  gemv_ps_kernel<N><<<grid, kThreads, 0, stream>>>(
      x, packed, scales, bias, splits == 1 ? out : partial, K, O, splits);
}

}  // namespace

extern "C" int q4_gemv_ps_launch(const void* x, const void* packed,
                                 const void* scales, const void* bias,
                                 void* partial, void* out, int n, int K, int O,
                                 int splits, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const uint16_t*>(x);
  auto pp = static_cast<const uint8_t*>(packed);
  auto sp = static_cast<const uint16_t*>(scales);
  auto bp = static_cast<const float*>(bias);
  auto part = static_cast<float*>(partial);
  auto op = static_cast<float*>(out);
  switch (n) {
    case 1: launch_n<1>(xp, pp, sp, bp, part, op, K, O, splits, s); break;
    case 2: launch_n<2>(xp, pp, sp, bp, part, op, K, O, splits, s); break;
    case 3: launch_n<3>(xp, pp, sp, bp, part, op, K, O, splits, s); break;
    case 4: launch_n<4>(xp, pp, sp, bp, part, op, K, O, splits, s); break;
    case 5: launch_n<5>(xp, pp, sp, bp, part, op, K, O, splits, s); break;
    case 6: launch_n<6>(xp, pp, sp, bp, part, op, K, O, splits, s); break;
    case 7: launch_n<7>(xp, pp, sp, bp, part, op, K, O, splits, s); break;
    case 8: launch_n<8>(xp, pp, sp, bp, part, op, K, O, splits, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int total = n * O;
  split_reduce_kernel<<<(total + 255) / 256, 256, 0, s>>>(part, bp, op, n, O,
                                                          splits);
  return static_cast<int>(cudaGetLastError());
}
