// K9 q4_matmul_i and K10 q4_matmul_stacked: y[n, O] = x[n, K] . W^T (+ bias)
// for an interleaved ("i" layout) Q4_0 weight, n <= 128 rows of bf16 or f32
// activations.  K10 takes a stacked [L, K/2, O] weight and reads the layer
// index il from an int32 on the device, so a decode step neither slices a
// layer nor syncs with the host.
//
// Replaces vsim_tpu/ops/pallas_q4.py:_kernel (:110, pallas_q4_matmul: the lm
// head and any per-layer "i" weight) and _kernel_stacked (:953,
// pallas_q4_matmul_stacked: qkv, wo, fc and proj of the stacked-layer
// engine, il by scalar prefetch), with _dequant_planes (:84): packed byte c
// holds elements 2c (low nibble) and 2c+1 (high nibble), both scaled by
// scale row c/16, each dequantized to (v - 8) * s.  With ROUND (K10 under
// the i32/f32x maths: acc_dtype bf16) the planes and x are rounded to bf16,
// as the Pallas kernel casts them; otherwise both stay f32 (K9 always:
// q4_matmul calls pallas_q4_matmul with acc_dtype f32).  Sums in f32.
//
// Bound on the H100: the weight bytes (0.5625 B per parameter) at decode
// (n <= 8); at n = 128 the f32 multiply-adds.  Design, K1's: a thread owns 4
// neighbouring output columns and reads one 4-byte word of a packed row per
// step (a warp reads 128 contiguous bytes of the K-major row) for up to 8
// rows of x, which sit in shared memory as (even, odd) float pairs, one
// 8-byte read per row of x and packed row.  More rows of x take more row
// tiles (blockIdx.y), each streaming the weight again.  Too few column
// tiles for 132 SMs at decode (5 at O = 5120) is met by splitting K across
// blockIdx.z in whole 16-row slices (one scale row each); the splits write
// f32 partials that a second pass sums with the bias (deterministic, no
// atomics).  The wrapper checks O % 4 == 0 and the alignment of the weight.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;                  // output columns per thread
constexpr int kTileO = kThreads * kCols;  // 1024 columns per block
constexpr int kMaxRows = 8;               // rows of x per block
constexpr int kSlabG = 16;                // scale rows (16 packed rows each) in smem

template <int NR, bool ROUND>
__global__ void __launch_bounds__(kThreads)
matmul_i_kernel(const void* __restrict__ xv,        // [n, K] bf16 or f32
                int x_is_bf16,
                const uint8_t* __restrict__ packed,  // [(L,) K/2, O]
                const uint16_t* __restrict__ scales,  // [(L,) K/32, O] bf16
                const int* __restrict__ il_ptr,       // layer index or null
                int n_layers,
                const float* __restrict__ bias,       // [O] or null
                float* __restrict__ dst,  // [n, O] (splits == 1) or [splits, n, O]
                int n, int K, int O, int splits) {
  __shared__ __align__(16) float xs[NR][kSlabG * 32];  // (even, odd) pairs
  const int half_k = K / 2;
  const int G = K / 32;  // scale rows
  if (il_ptr != nullptr) {  // K10: select the layer on the device
    const int il = min(max(*il_ptr, 0), n_layers - 1);
    packed += static_cast<size_t>(il) * half_k * O;
    scales += static_cast<size_t>(il) * G * O;
  }
  const int split = blockIdx.z;
  const int g_begin = static_cast<int>(static_cast<long long>(G) * split / splits);
  const int g_end = static_cast<int>(static_cast<long long>(G) * (split + 1) / splits);
  const int m0 = blockIdx.y * NR;
  const int col = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  const bool active = col < O;  // O % 4 == 0: a thread is all in or all out

  float acc[NR][kCols];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  for (int g0 = g_begin; g0 < g_end; g0 += kSlabG) {
    const int ng = min(kSlabG, g_end - g0);
    const int kvals = ng * 32;  // x values of the slab: 2 per packed row
    __syncthreads();  // the previous slab is consumed
    for (int idx = threadIdx.x; idx < NR * kvals; idx += kThreads) {
      const int i = idx / kvals;
      const int k = idx - i * kvals;
      float v = 0.f;
      if (m0 + i < n) {
        const size_t off = static_cast<size_t>(m0 + i) * K + g0 * 32 + k;
        v = x_is_bf16 ? bf16_to_float(static_cast<const uint16_t*>(xv)[off])
                      : static_cast<const float*>(xv)[off];
        if (ROUND) v = round_bf16(v);
      }
      xs[i][k] = v;
    }
    __syncthreads();
    if (!active) continue;
    for (int gg = 0; gg < ng; ++gg) {
      const int g = g0 + gg;
      const uint2 sw = *reinterpret_cast<const uint2*>(
          scales + static_cast<size_t>(g) * O + col);
      const float s[kCols] = {
          bf16_to_float(sw.x & 0xFFFFu), bf16_to_float(sw.x >> 16),
          bf16_to_float(sw.y & 0xFFFFu), bf16_to_float(sw.y >> 16)};
      const uint8_t* prow = packed + static_cast<size_t>(g) * 16 * O + col;
#pragma unroll 4
      for (int r = 0; r < 16; ++r) {
        const uint32_t w =
            *reinterpret_cast<const uint32_t*>(prow + static_cast<size_t>(r) * O);
        float wl[kCols], wh[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          wl[j] = static_cast<float>(static_cast<int>((w >> (8 * j)) & 0xFu) - 8) * s[j];
          wh[j] = static_cast<float>(static_cast<int>((w >> (8 * j + 4)) & 0xFu) - 8) * s[j];
          if (ROUND) {
            wl[j] = round_bf16(wl[j]);
            wh[j] = round_bf16(wh[j]);
          }
        }
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          const float2 xp =
              *reinterpret_cast<const float2*>(&xs[i][(gg * 16 + r) * 2]);
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            acc[i][j] = fmaf(xp.y, wh[j], fmaf(xp.x, wl[j], acc[i][j]));
        }
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int m = m0 + i;
    if (m >= n) break;
    float4 o = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    if (splits == 1) {
      if (bias) {
        o.x += bias[col];
        o.y += bias[col + 1];
        o.z += bias[col + 2];
        o.w += bias[col + 3];
      }
      *reinterpret_cast<float4*>(dst + static_cast<size_t>(m) * O + col) = o;
    } else {
      *reinterpret_cast<float4*>(
          dst + (static_cast<size_t>(split) * n + m) * O + col) = o;
    }
  }
}

// Second pass: out = bias + sum over splits of the partials, in split order.
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

template <int NR, bool ROUND>
void launch_t(const void* x, int x_is_bf16, const uint8_t* packed,
              const uint16_t* scales, const int* il, int n_layers,
              const float* bias, float* partial, float* out, int n, int K,
              int O, int splits, cudaStream_t s) {
  const dim3 grid((O + kTileO - 1) / kTileO, (n + NR - 1) / NR, splits);
  matmul_i_kernel<NR, ROUND><<<grid, kThreads, 0, s>>>(
      x, x_is_bf16, packed, scales, il, n_layers, bias,
      splits == 1 ? out : partial, n, K, O, splits);
}

template <bool ROUND>
void launch_rows(const void* x, int x_is_bf16, const uint8_t* packed,
                 const uint16_t* scales, const int* il, int n_layers,
                 const float* bias, float* partial, float* out, int n, int K,
                 int O, int splits, cudaStream_t s) {
  if (n == 1)
    launch_t<1, ROUND>(x, x_is_bf16, packed, scales, il, n_layers, bias,
                       partial, out, n, K, O, splits, s);
  else if (n == 2)
    launch_t<2, ROUND>(x, x_is_bf16, packed, scales, il, n_layers, bias,
                       partial, out, n, K, O, splits, s);
  else if (n <= 4)
    launch_t<4, ROUND>(x, x_is_bf16, packed, scales, il, n_layers, bias,
                       partial, out, n, K, O, splits, s);
  else
    launch_t<kMaxRows, ROUND>(x, x_is_bf16, packed, scales, il, n_layers,
                              bias, partial, out, n, K, O, splits, s);
}

int launch(const void* x, int x_is_bf16, const void* packed,
           const void* scales, const void* il, int n_layers, const void* bias,
           void* partial, void* out, int n, int K, int O, int splits,
           int round_planes, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto pp = static_cast<const uint8_t*>(packed);
  auto sp = static_cast<const uint16_t*>(scales);
  auto ip = static_cast<const int*>(il);
  auto bp = static_cast<const float*>(bias);
  auto part = static_cast<float*>(partial);
  auto op = static_cast<float*>(out);
  if (n < 1 || n > 128 || K % 32 || O % 4 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (round_planes)
    launch_rows<true>(x, x_is_bf16, pp, sp, ip, n_layers, bp, part, op, n, K,
                      O, splits, s);
  else
    launch_rows<false>(x, x_is_bf16, pp, sp, ip, n_layers, bp, part, op, n,
                       K, O, splits, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int total = n * O;
  split_reduce_kernel<<<(total + 255) / 256, 256, 0, s>>>(part, bp, op, n, O,
                                                          splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K9: one interleaved [K/2, O] weight, f32 planes.
extern "C" int q4_matmul_i_launch(const void* x, int x_is_bf16,
                                  const void* packed, const void* scales,
                                  const void* bias, void* partial, void* out,
                                  int n, int K, int O, int splits,
                                  void* stream) {
  return launch(x, x_is_bf16, packed, scales, nullptr, 1, bias, partial, out,
                n, K, O, splits, 0, stream);
}

// K10: layer *il (clamped to [0, n_layers)) of a stacked [L, K/2, O] weight.
extern "C" int q4_matmul_stacked_launch(const void* x, int x_is_bf16,
                                        const void* packed, const void* scales,
                                        const void* il, int n_layers,
                                        const void* bias, void* partial,
                                        void* out, int n, int K, int O,
                                        int splits, int round_planes,
                                        void* stream) {
  if (il == nullptr || n_layers < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(x, x_is_bf16, packed, scales, il, n_layers, bias, partial,
                out, n, K, O, splits, round_planes, stream);
}
