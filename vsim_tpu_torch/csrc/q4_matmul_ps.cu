// K2 q4_matmul_ps: y[n, O] = x[n, K] . W^T (+ bias) for a plane-split Q4_0
// weight, n <= 128 rows of bf16 or f32 activations (prefill chunks, and any
// f32-activation call).
//
// Replaces vsim_tpu/ops/pallas_q4.py:_kernel_ps and _kernel_ps_bias (:482,
// :223) with _dequant_planes_ps (:187): each weight element dequantizes to
// (v - 8) * s; with ROUND (the i32/f32x maths, and gi for bf16 x at n > 8:
// ops/q4_cuda.py:ps_round_planes) the planes and x are rounded to bf16, as
// the Pallas kernel's acc_dtype bf16 casts them, else both stay f32 (the
// "f32xf" math); the product accumulates in f32.
// Packed row c holds element c (low nibble, scale row c/32) and element
// K/2 + c (high nibble, scale row K/64 + c/32).
//
// Bound on the H100: at n = 128 and the GPT-J widths, operations (2 n K O
// multiply-adds on f32 FMA units) rather than the weight bytes; at n = 16
// the weight bytes.  Design, simple and right first: a block owns a 32 x 64
// output tile; per step it stages one 32-row group of each plane (64 values
// of K) of x and of the dequantized weight tile in shared memory, and each
// thread runs a 2 x 4 register tile of f32 FMAs.  Tensor cores (mma.sync or
// wgmma on the bf16 planes) are later work.

#include "common.cuh"

namespace {

constexpr int kBM = 32;       // rows of x per block
constexpr int kBN = 64;       // output columns per block
constexpr int kKS = 64;       // K values per step: 32 lo + 32 hi
constexpr int kThreads = 256; // 16 x 16 threads, 2 x 4 outputs each

template <bool XBF16, bool ROUND>
__global__ void __launch_bounds__(kThreads)
matmul_ps_kernel(const void* __restrict__ xv,            // [n, K] bf16 or f32
                 const uint8_t* __restrict__ packed,     // [K/2, O]
                 const uint16_t* __restrict__ scales,    // [K/32, O] bf16
                 const float* __restrict__ bias,         // [O] or null
                 float* __restrict__ out,                // [n, O]
                 int n, int K, int O) {
  __shared__ float xs[kBM][kKS + 1];
  __shared__ __align__(16) float ws[kKS][kBN];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * kBM, o0 = blockIdx.x * kBN;
  const int half_k = K / 2;
  const int G = half_k / 32;

  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  for (int g = 0; g < G; ++g) {
    for (int idx = tid; idx < kBM * kKS; idx += kThreads) {
      const int m = idx / kKS, kk = idx % kKS;
      const int k = (kk < 32 ? 0 : half_k) + g * 32 + (kk & 31);
      float v = 0.f;
      if (m0 + m < n) {
        const size_t off = static_cast<size_t>(m0 + m) * K + k;
        v = XBF16 ? bf16_to_float(static_cast<const uint16_t*>(xv)[off])
                  : static_cast<const float*>(xv)[off];
        if (ROUND && !XBF16) v = round_bf16(v);
      }
      xs[m][kk] = v;
    }
    for (int idx = tid; idx < 32 * kBN; idx += kThreads) {
      const int r = idx / kBN, c = idx % kBN;
      const int o = o0 + c;
      float wl = 0.f, wh = 0.f;
      if (o < O) {
        const uint32_t b = packed[static_cast<size_t>(g * 32 + r) * O + o];
        const float sl = bf16_to_float(scales[static_cast<size_t>(g) * O + o]);
        const float sh =
            bf16_to_float(scales[static_cast<size_t>(G + g) * O + o]);
        wl = static_cast<float>(static_cast<int>(b & 0xFu) - 8) * sl;
        wh = static_cast<float>(static_cast<int>(b >> 4) - 8) * sh;
        if (ROUND) {
          wl = round_bf16(wl);
          wh = round_bf16(wh);
        }
      }
      ws[r][c] = wl;
      ws[32 + r][c] = wh;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kKS; ++kk) {
      const float a0 = xs[ty * 2][kk];
      const float a1 = xs[ty * 2 + 1][kk];
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      acc[0][0] = fmaf(a0, b.x, acc[0][0]);
      acc[0][1] = fmaf(a0, b.y, acc[0][1]);
      acc[0][2] = fmaf(a0, b.z, acc[0][2]);
      acc[0][3] = fmaf(a0, b.w, acc[0][3]);
      acc[1][0] = fmaf(a1, b.x, acc[1][0]);
      acc[1][1] = fmaf(a1, b.y, acc[1][1]);
      acc[1][2] = fmaf(a1, b.z, acc[1][2]);
      acc[1][3] = fmaf(a1, b.w, acc[1][3]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + ty * 2 + i;
    if (m >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + tx * 4 + j;
      if (o < O)
        out[static_cast<size_t>(m) * O + o] = acc[i][j] + (bias ? bias[o] : 0.f);
    }
  }
}

template <bool XBF16, bool ROUND>
void launch_t(const void* x, const uint8_t* packed, const uint16_t* scales,
              const float* bias, float* out, int n, int K, int O,
              cudaStream_t s) {
  const dim3 grid((O + kBN - 1) / kBN, (n + kBM - 1) / kBM);
  matmul_ps_kernel<XBF16, ROUND><<<grid, kThreads, 0, s>>>(x, packed, scales,
                                                           bias, out, n, K, O);
}

}  // namespace

extern "C" int q4_matmul_ps_launch(const void* x, int x_is_bf16,
                                   int round_planes,
                                   const void* packed, const void* scales,
                                   const void* bias, void* out, int n, int K,
                                   int O, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto pp = static_cast<const uint8_t*>(packed);
  auto sp = static_cast<const uint16_t*>(scales);
  auto bp = static_cast<const float*>(bias);
  auto op = static_cast<float*>(out);
  if (x_is_bf16 && round_planes)
    launch_t<true, true>(x, pp, sp, bp, op, n, K, O, s);
  else if (x_is_bf16)
    launch_t<true, false>(x, pp, sp, bp, op, n, K, O, s);
  else if (round_planes)
    launch_t<false, true>(x, pp, sp, bp, op, n, K, O, s);
  else
    launch_t<false, false>(x, pp, sp, bp, op, n, K, O, s);
  return static_cast<int>(cudaGetLastError());
}
