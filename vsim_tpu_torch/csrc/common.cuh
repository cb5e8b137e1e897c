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

// ---------------------------------------------------------------------------
// Tensor-core building blocks (K4 bf16, K2 at 9-128 rows): cp.async into
// shared memory, ldmatrix fragments and mma.sync m16n8k16 bf16 -> f32.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros where !full.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a . b on a 16x8x16 tile, bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 4 bytes global -> shared, asynchronously; zero where !full.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0));
}

// ---------------------------------------------------------------------------
// 3xTF32 (K7/K8 f32): an f32 product from three TF32 tensor-core products.
// x = big + small with both TF32 (10-bit mantissa), each rounded to nearest
// with ties away from zero (cvt.rna's rounding); x - big is exact in f32, so
// big + small is x to 2^-22 relative.  a.b ~ a_small.b_big + a_big.b_small +
// a_big.b_big, the small terms first into the same f32 accumulator; the
// dropped a_small.b_small is below 2^-22 of |a| |b|.
// ---------------------------------------------------------------------------

// cvt.rna.tf32.f32's result for finite x (and +-inf) as an integer add and
// mask: half an ulp of the 10-bit mantissa added to the magnitude's bits,
// then the 13 low bits cleared.  On sm_90a ptxas expands cvt.rna.tf32 with a
// finite test and a select besides, which these finite operands do not need.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// A fragment of m16n8k8 (a0 row g col t, a1 row g+8 col t, a2 row g col
// t+4, a3 row g+8 col t+4), split
struct FragA3 {
  uint32_t big[4], small[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2, float a3) {
    split_tf32(a0, big[0], small[0]);
    split_tf32(a1, big[1], small[1]);
    split_tf32(a2, big[2], small[2]);
    split_tf32(a3, big[3], small[3]);
  }
};

// B fragment of m16n8k8 (b0 k t, b1 k t+4; column g), split
struct FragB3 {
  uint32_t big[2], small[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split_tf32(b0, big[0], small[0]);
    split_tf32(b1, big[1], small[1]);
  }
};

// d += a . b on a 16x8x8 tile, TF32 operands, f32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b as three TF32 products, small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const FragA3& a,
                                           const FragB3& b) {
  mma_tf32(d, a.small, b.big[0], b.big[1]);
  mma_tf32(d, a.big, b.small[0], b.small[1]);
  mma_tf32(d, a.big, b.big[0], b.big[1]);
}

// Two floats -> bf16x2 (lo in the low half), round to nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// ---------------------------------------------------------------------------
// Q4 dequant steps (K2, K12)
// ---------------------------------------------------------------------------

// nibble v of byte j of w (0 <= v < 16) as the float v - 8, exactly
template <int J>
__device__ __forceinline__ float nib_f(uint32_t w) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 + J)) - 8388616.f;
}

// f32 -> bf16 -> f32 for two values (cvt.rn: round to nearest even)
__device__ __forceinline__ void round2_bf16(float& a, float& b) {
  const uint32_t r = pack_bf16(a, b);
  a = __uint_as_float(r << 16);
  b = __uint_as_float(r & 0xFFFF0000u);
}

__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// a * b rounded once to bf16, for each half (two bf16 pairs)
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// The contract's round((v - 8) s) for the nibbles of bytes J, J + 1 of
// ``nib`` (each v < 16) and their scale pair s2, as a bf16 pair, two weights
// an instruction: bf16 128 + v is the byte under exponent 0x43; minus 136
// is v - 8 exactly; times s is exact before its one rounding (fma with -0).
template <int J>
__device__ __forceinline__ uint32_t dequant_bf16x2(uint32_t nib, uint32_t s2) {
  const uint32_t u = __byte_perm(nib, 0x43u, J == 0 ? 0x4140 : 0x4342);
  return fma_bf16x2(fma_bf16x2(u, 0x3F803F80u, 0xC308C308u), s2, 0x80008000u);
}

// bf16 pair -> its two floats
__device__ __forceinline__ void unpack_bf16x2(uint32_t p, float& a, float& b) {
  a = __uint_as_float(p << 16);
  b = __uint_as_float(p & 0xFFFF0000u);
}
