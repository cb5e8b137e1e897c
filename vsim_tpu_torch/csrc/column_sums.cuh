// The per-column checksum of a Q4 weight, shared by K13 (q4_lab.cu) and the
// read designs it is held against (read_designs.cu): per column, the int32
// sum of the packed bytes [K/2, O] and of the raw bf16 scale bits [K/32, O],
// exact in any order, added to a zeroed checksum [2, O].
#pragma once

#include "common.cuh"

// The sums of rows [r0, r1) of tile ``tile`` of a row-major matrix ``width``
// bytes wide, added to ``crow``: packed bytes (SCALE false, column = byte)
// or bf16 bit patterns (SCALE true, column = byte / 2).  A tile row is TWC
// 16-byte words, contiguous; the THREADS / TWC row phases of a block take
// every (THREADS / TWC)-th row, 8 rows in flight a thread.  Bytes are summed
// two at a time in 16-bit lanes, so r1 - r0 <= 256 * THREADS / TWC.  The
// phases are reduced through ``red`` (THREADS * 16 ints) and added with one
// integer atomic a column.
template <int THREADS, int TWC, bool SCALE>
__device__ __forceinline__ void column_sums(const uint8_t* __restrict__ base,
                                            int width, int tile, int r0, int r1,
                                            int* __restrict__ crow, int O,
                                            int* __restrict__ red) {
  constexpr int kPhases = THREADS / TWC;
  constexpr int kTileB = TWC * 16;  // bytes of a tile row
  const int ch = threadIdx.x % TWC, ph = threadIdx.x / TWC;
  const int col = tile * kTileB + ch * 16;
  uint32_t acc[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
  auto add = [&](const uint4 v) {
    const uint32_t q[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (SCALE) {  // the two bf16 bit patterns of a word
        acc[2 * k] += q[k] & 0xFFFFu;
        acc[2 * k + 1] += q[k] >> 16;
      } else {  // bytes 0 and 2 (acc[2k]) and 1 and 3 (acc[2k + 1])
        acc[2 * k] += q[k] & 0x00FF00FFu;
        acc[2 * k + 1] += (q[k] >> 8) & 0x00FF00FFu;
      }
    }
  };
  if (col < width) {
    const uint8_t* p = base + col;
    int r = r0 + ph;
    for (; r + 7 * kPhases < r1; r += 8 * kPhases) {
      uint4 v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        v[k] = __ldg(reinterpret_cast<const uint4*>(
            p + static_cast<size_t>(r + k * kPhases) * width));
#pragma unroll
      for (int k = 0; k < 8; ++k) add(v[k]);
    }
    for (; r < r1; r += kPhases)
      add(__ldg(reinterpret_cast<const uint4*>(p + static_cast<size_t>(r) * width)));
  }
  __syncthreads();  // the previous segment's sums are read
  int4* mine = reinterpret_cast<int4*>(red + ph * kTileB);
  if (SCALE) {
    mine[ch * 2] = make_int4(acc[0], acc[1], acc[2], acc[3]);
    mine[ch * 2 + 1] = make_int4(acc[4], acc[5], acc[6], acc[7]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      mine[ch * 4 + k] = make_int4(acc[2 * k] & 0xFFFFu, acc[2 * k + 1] & 0xFFFFu,
                                   acc[2 * k] >> 16, acc[2 * k + 1] >> 16);
  }
  __syncthreads();
  const int cols = SCALE ? kTileB / 2 : kTileB;
  const int c0 = tile * cols;
  for (int e = threadIdx.x; e < cols; e += THREADS) {
    if (c0 + e >= O) continue;
    int v = 0;
#pragma unroll
    for (int w = 0; w < kPhases; ++w) v += red[w * kTileB + e];
    atomicAdd(crow + c0 + e, v);
  }
}

// Share b of nb of the units (one tile row: packed tiles first, then scale
// tiles, each tile's rows in order), so every block reads the same bytes
// whatever the shape and the scale rows are read beside the packed ones.
template <int THREADS, int TWC>
__device__ __forceinline__ void checksum_share(const uint8_t* __restrict__ packed,
                                               const uint16_t* __restrict__ scales,
                                               int* __restrict__ checksum, int K, int O,
                                               int b, int nb, int* __restrict__ red) {
  constexpr int kTileB = TWC * 16;
  const int KH = K / 2, G = K / 32;
  const long long ptiles = (O + kTileB - 1) / kTileB;
  const long long stiles = (2LL * O + kTileB - 1) / kTileB;
  const long long pu = ptiles * KH, units = pu + stiles * G;
  const long long u_end = units * (b + 1) / nb;
  for (long long u = units * b / nb; u < u_end;) {
    const bool sc = u >= pu;
    const long long v = sc ? u - pu : u;
    const int rows = sc ? G : KH;
    const int t = static_cast<int>(v / rows);
    const int r0 = static_cast<int>(v - static_cast<long long>(t) * rows);
    const int r1 = static_cast<int>(min(
        static_cast<long long>(min(rows, r0 + 256 * (THREADS / TWC))), r0 + (u_end - u)));
    if (sc)
      column_sums<THREADS, TWC, true>(reinterpret_cast<const uint8_t*>(scales), 2 * O, t,
                                      r0, r1, checksum + O, O, red);
    else
      column_sums<THREADS, TWC, false>(packed, O, t, r0, r1, checksum, O, red);
    u += r1 - r0;
  }
}
