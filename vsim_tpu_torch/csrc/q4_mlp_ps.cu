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
// Bound on the H100: the weight bytes (both weights, 0.5625 B a
// parameter).  Design: two launches of the Q4 core of q4_core.cuh.  The
// first runs fc (K = E, O = F) and writes act(h + bfc) in f32 [n, F]; the
// second runs proj (K = F, O = E) on that h and adds bproj.  f32 x and h
// enter the tensor cores as three bf16 pieces each, every product exact,
// so h is never rounded; bf16 x is one piece.  h's round trip is n F 8
// bytes (0.6% of Pythia-12B's 118 MB of fc + proj at n = 8).  A single
// launch would still need a second pass: proj's output sums over all of F,
// which no cluster holds.  No atomics: the same bits from run to run.

#include "q4_core.cuh"

namespace {

template <bool XF32>
cudaError_t fc_launch(int act, const void* x, const uint8_t* p,
                      const uint16_t* s, const float* b, float* h, int n,
                      int E, int F, int wc, int C, cudaStream_t st) {
  using namespace q4core;
  if (act == kGeluTanh)
    return launch<XF32, kGeluTanh>(x, p, s, b, h, n, E, F, wc, C, st);
  if (act == kRelu)
    return launch<XF32, kRelu>(x, p, s, b, h, n, E, F, wc, C, st);
  return launch<XF32, kGeluExact>(x, p, s, b, h, n, E, F, wc, C, st);
}

}  // namespace

extern "C" int q4_mlp_ps_launch(const void* x, int x_is_bf16,
                                const void* fc_packed, const void* fc_scales,
                                const void* fc_bias, const void* proj_packed,
                                const void* proj_scales,
                                const void* proj_bias, void* h, void* out,
                                int n, int E, int F, int act, int fc_wc,
                                int fc_cluster, int proj_wc, int proj_cluster,
                                void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (!q4core::valid(n, E, F, fc_wc, fc_cluster) ||
      !q4core::valid(n, F, E, proj_wc, proj_cluster) || act < 0 || act > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  auto pfc = static_cast<const uint8_t*>(fc_packed);
  auto sfc = static_cast<const uint16_t*>(fc_scales);
  auto bfc = static_cast<const float*>(fc_bias);
  auto hp = static_cast<float*>(h);
  cudaError_t err =
      x_is_bf16 ? fc_launch<false>(act, x, pfc, sfc, bfc, hp, n, E, F, fc_wc,
                                   fc_cluster, st)
                : fc_launch<true>(act, x, pfc, sfc, bfc, hp, n, E, F, fc_wc,
                                  fc_cluster, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = q4core::launch<true, q4core::kActNone>(
      hp, static_cast<const uint8_t*>(proj_packed),
      static_cast<const uint16_t*>(proj_scales),
      static_cast<const float*>(proj_bias), static_cast<float*>(out), n, F, E,
      proj_wc, proj_cluster, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of ``cluster`` blocks the card holds at once, for the f32-x
// instance (the most registers; bf16 x holds at least as many).
extern "C" int q4_mlp_ps_max_clusters(int cluster) {
  return q4core::max_clusters<true, q4core::kActNone>(cluster);
}
