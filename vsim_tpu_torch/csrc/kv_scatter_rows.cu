// K6 scatter_rows: write one quantized KV row per (layer, batch row) into the
// stacked cache, in place, at slot n_past[b].
//
// Replaces vsim_tpu/ops/decode_attention.py:_writer_kernel (:370), the
// aliased writer that follows the ragged serving step's layer loop (the
// attention of that step, K5, merged each row from beside the cache).
//   kq[l, b, h, n_past[b], :] = kq_rows[l, b, h, :]   (and ks, vq, vs)
// for every l, h; a row with n_past[b] outside [0, S) writes nothing, so
// n_past = S is the write-nothing sentinel of an inactive serving slot.
// Two instances of the one function, by the wrapper's pointers: every layer
// of the cache after the serving step's layer loop (L layers), and one
// layer (L = 1, the cache pointers at layer il) inside the graphed one-token
// step of InferenceEngine, which writes its row before K3 reads the layer.
//
// Bound on the H100: bytes, 2 L B H (Dp + 2) read and the same written
// (~1.9 MB at GPT-J-6B int8, B = 8, all layers: about 1 us; 16 KB a layer
// at B = 1), so the launch costs more than the copy.  Design: the grid is
// sized to the rows' 16-byte units (bytes when Dp or an address does not
// allow 16), one unit of k and the same unit of v a thread, a (layer, b)
// row's units along x and b, l as the grid's y and z (no division finds
// them), so a one-layer call at B = 1 (GPT-J: 16 heads x 256 bytes) is one
// full block of 256 threads.  Every thread issues its loads (n_past[b],
// its unit, its head's scales) before it tests n_past[b]: only the stores
// wait on it.  A (layer, b) row's scales are H bf16 values at stride S in
// the cache, H separate sectors, so no store can be made wider; the thread
// of each head's first unit stores that head's two.  Storing a row's H
// scales from one thread instead (loaded 16 bytes at a time) was slower at
// every chip_smoke.py phase-2 shape on the H100 (PERF.md), so it is not
// kept.

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
  const int b = blockIdx.y, r = blockIdx.z * B + b;  // row r = l B + b
  const int p = n_past[b];  // every load first: n_past, the unit, scales
  const int nv = Dp / static_cast<int>(sizeof(V));  // units a head
  const int rem = blockIdx.x * kThreads + threadIdx.x;
  if (rem >= H * nv) return;
  const int h = rem / nv, c = rem - h * nv;
  const size_t i = static_cast<size_t>(r) * H * nv + rem;
  const V kv = reinterpret_cast<const V*>(kq_rows)[i];
  const V vv = reinterpret_cast<const V*>(vq_rows)[i];
  const size_t head = static_cast<size_t>(r) * H + h;  // (l, b, h)
  uint16_t ksh = 0, vsh = 0;
  if (c == 0) {
    ksh = ks_rows[head];
    vsh = vs_rows[head];
  }
  if (p < 0 || p >= S) return;
  const size_t dst = (head * S + p) * nv + c;
  reinterpret_cast<V*>(kq)[dst] = kv;
  reinterpret_cast<V*>(vq)[dst] = vv;
  if (c == 0) {
    ks[head * S + p] = ksh;
    vs[head * S + p] = vsh;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// L layers of rows [L, B, H, Dp] into a cache whose pointers start at the
// first of those layers: the wrapper passes layer il's for the one-layer
// instance (L = 1).
extern "C" int scatter_rows_launch(const void* kq_rows, const void* ks_rows,
                                   const void* vq_rows, const void* vs_rows,
                                   const void* n_past, void* kq, void* ks,
                                   void* vq, void* vs, int L, int B, int H,
                                   int S, int Dp, void* stream) {
  if (L < 1 || L > 65535 || B < 1 || B > 65535 || H < 1 || S < 1 ||
      Dp < 1 || static_cast<long long>(H) * Dp >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto u8 = [](const void* p) { return static_cast<const uint8_t*>(p); };
  auto u16 = [](const void* p) { return static_cast<const uint16_t*>(p); };
  auto np = static_cast<const int*>(n_past);
  auto kqd = static_cast<uint8_t*>(kq);
  auto vqd = static_cast<uint8_t*>(vq);
  auto ksd = static_cast<uint16_t*>(ks);
  auto vsd = static_cast<uint16_t*>(vs);
  const bool vec = Dp % 16 == 0 && aligned16(kq_rows) && aligned16(vq_rows) &&
                   aligned16(kq) && aligned16(vq);
  const int units = H * (vec ? Dp / 16 : Dp);  // a (layer, b) row's
  const dim3 grid((units + kThreads - 1) / kThreads, B, L);
  if (vec)
    scatter_rows_kernel<uint4><<<grid, kThreads, 0, st>>>(
        u8(kq_rows), u16(ks_rows), u8(vq_rows), u16(vs_rows), np, kqd, ksd,
        vqd, vsd, B, H, S, Dp);
  else
    scatter_rows_kernel<uint8_t><<<grid, kThreads, 0, st>>>(
        u8(kq_rows), u16(ks_rows), u8(vq_rows), u16(vs_rows), np, kqd, ksd,
        vqd, vsd, B, H, S, Dp);
  return static_cast<int>(cudaGetLastError());
}
