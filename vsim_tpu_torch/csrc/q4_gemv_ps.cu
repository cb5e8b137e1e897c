// K1 q4_gemv_ps: y[n, O] = x[n, K] . W^T (+ bias) for a plane-split Q4_0
// weight, n <= 8 rows of bf16 activations (the decode matmuls).
//
// Replaces vsim_tpu/ops/pallas_q4.py:_kernel_ps_giw (:339, the qkv/wo/fc/
// proj decode matmuls) and _kernel_ps_gi / _kernel_ps_gi_bias (:293, :315,
// the lm head), with the grouped-integer ("gi") math: per 32-row group g
// and plane, the sum of x (v - 8) over exact products, times the group's
// scale, where _gi_rescale (pallas_q4.py:280) writes
//   s_lo[g] (sum x_lo v_lo - 8 sum x_lo) + s_hi[g] (sum x_hi v_hi - 8 sum x_hi);
// only the order of the f32 sums differs.  x is bf16 on entry, so the kernel
// sees the bf16-rounded x that _gi_rescale sees.
//
// Bound on the H100: the weight bytes.  The design is the Q4 core of
// q4_core.cuh: mma.sync on nibbles made bf16 without a conversion
// instruction, 128 bytes a thread a group with the next group's loads in
// flight, and K split over the warps of a block and the blocks of a
// cluster, the partial sums meeting in distributed shared memory: one
// launch, no partials in HBM.

#include "q4_core.cuh"

extern "C" int q4_gemv_ps_launch(const void* x, const void* packed,
                                 const void* scales, const void* bias,
                                 void* out, int n, int K, int O, int wc,
                                 int cluster, void* stream) {
  if (!q4core::valid(n, K, O, wc, cluster))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = q4core::launch<false, q4core::kActNone>(
      x, static_cast<const uint8_t*>(packed),
      static_cast<const uint16_t*>(scales), static_cast<const float*>(bias),
      static_cast<float*>(out), n, K, O, wc, cluster,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of ``cluster`` blocks the card holds at once (ops/q4_cuda.py's
// plan keeps a launch to one wave).
extern "C" int q4_gemv_ps_max_clusters(int cluster) {
  return q4core::max_clusters<false, q4core::kActNone>(cluster);
}
