// K6 scatter_rows: write one quantized KV row per (layer, batch row) into the
// stacked cache, in place, at slot n_past[b].
//
// Replaces vsim_tpu/ops/decode_attention.py:_writer_kernel (:370), the
// aliased writer that follows the ragged serving step's layer loop (the
// attention of that step, K5, merged each row from beside the cache).
//   kq[l, b, h, n_past[b], :] = kq_rows[l, b, h, :]   (and ks, vq, vs)
// for every l, h; a row with n_past[b] outside [0, S) writes nothing, so
// n_past = S is the write-nothing sentinel of an inactive serving slot.
//
// Bound on the H100: bytes, 2 L B H (Dp + 2) read and the same written
// (~1.9 MB at GPT-J-6B int8, B = 8: about 1 us), so the launch costs more
// than the copy.  Design: one block per (b, l) copies its H rows of k and v,
// 16 bytes a thread when Dp allows, and the 2 H bf16 scales.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename V>  // copy unit: uint4 (16 bytes) or uint8_t
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(const uint8_t* __restrict__ kq_rows,   // [L, B, H, Dp]
                    const uint16_t* __restrict__ ks_rows,  // [L, B, H] bf16
                    const uint8_t* __restrict__ vq_rows,
                    const uint16_t* __restrict__ vs_rows,
                    const int* __restrict__ n_past,        // [B]
                    uint8_t* __restrict__ kq,              // [L, B, H, S, Dp]
                    uint16_t* __restrict__ ks,             // [L, B, H, S]
                    uint8_t* __restrict__ vq,
                    uint16_t* __restrict__ vs,
                    int B, int H, int S, int Dp) {
  const int b = blockIdx.x, l = blockIdx.y;
  const int p = n_past[b];
  if (p < 0 || p >= S) return;
  const size_t lbh = (static_cast<size_t>(l) * B + b) * H;  // row (l, b, 0)
  const int nv = Dp / static_cast<int>(sizeof(V));           // units per row
  const V* ksrc = reinterpret_cast<const V*>(kq_rows);
  const V* vsrc = reinterpret_cast<const V*>(vq_rows);
  V* kdst = reinterpret_cast<V*>(kq);
  V* vdst = reinterpret_cast<V*>(vq);
  for (int i = threadIdx.x; i < H * nv; i += kThreads) {
    const int h = i / nv, c = i % nv;
    const size_t src = (lbh + h) * nv + c;
    const size_t dst = ((lbh + h) * S + p) * nv + c;
    kdst[dst] = ksrc[src];
    vdst[dst] = vsrc[src];
  }
  for (int h = threadIdx.x; h < H; h += kThreads) {
    const size_t r = lbh + h;
    ks[r * S + p] = ks_rows[r];
    vs[r * S + p] = vs_rows[r];
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" int scatter_rows_launch(const void* kq_rows, const void* ks_rows,
                                   const void* vq_rows, const void* vs_rows,
                                   const void* n_past, void* kq, void* ks,
                                   void* vq, void* vs, int L, int B, int H,
                                   int S, int Dp, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B, L);
  auto u8 = [](const void* p) { return static_cast<const uint8_t*>(p); };
  auto u16 = [](const void* p) { return static_cast<const uint16_t*>(p); };
  auto np = static_cast<const int*>(n_past);
  auto kqd = static_cast<uint8_t*>(kq);
  auto vqd = static_cast<uint8_t*>(vq);
  auto ksd = static_cast<uint16_t*>(ks);
  auto vsd = static_cast<uint16_t*>(vs);
  if (Dp % 16 == 0 && aligned16(kq_rows) && aligned16(vq_rows) &&
      aligned16(kq) && aligned16(vq))
    scatter_rows_kernel<uint4><<<grid, kThreads, 0, st>>>(
        u8(kq_rows), u16(ks_rows), u8(vq_rows), u16(vs_rows), np, kqd, ksd,
        vqd, vsd, B, H, S, Dp);
  else
    scatter_rows_kernel<uint8_t><<<grid, kThreads, 0, st>>>(
        u8(kq_rows), u16(ks_rows), u8(vq_rows), u16(vs_rows), np, kqd, ksd,
        vqd, vsd, B, H, S, Dp);
  return static_cast<int>(cudaGetLastError());
}
