// Shared helpers of the port's kernels.  Each csrc/*.cu builds into its own
// shared library with a plain C interface (vsim_tpu_torch/ops/_build.py), so
// bf16 travels as raw uint16 bits and is widened by hand: no PyTorch or
// cuda_bf16 headers are needed.
#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

// JAX's _NEG_INF (finfo(float32).min): the mask value of the reference.
#define VSIM_NEG_INF (-FLT_MAX)

extern "C" const char* vsim_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

__device__ __forceinline__ float bf16_to_float(uint16_t bits) {
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

// f32 -> bf16 -> f32, round to nearest even (finite inputs).
__device__ __forceinline__ float round_bf16(float f) {
  uint32_t u = __float_as_uint(f);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xFFFF0000u);
}

__device__ __forceinline__ uint16_t float_to_bf16_bits(float f) {
  return static_cast<uint16_t>(__float_as_uint(round_bf16(f)) >> 16);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
