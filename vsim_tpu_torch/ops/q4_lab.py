"""Q4 dequant-lab kernels (counterpart of the Pallas probes in tools/).

K12 ``q4_lab_gemv`` (csrc/q4_lab.cu): y [n, O] f32 = x [n, K] · W for
n <= 32 rows of bf16 x and an interleaved ("i" layout) Q4 weight, under one
of ten dequant maths (``LAB_MATHS``), one tensor-core kernel for all of
them (K9/K10's "i"-layout core, the math's own sequence building the
``mma.sync`` weight operand: bf16 for seven maths, TF32 for the f32 ones;
K split over a cluster as ``lab_plan`` says):
kernel_lab.py's ``_k_i32``, ``_k_u16``, ``_k_f32x``, ``_k_f32f``,
``_k_f32xf`` and ``_k_i32f`` (:76-:202), pair_lab.py's ``_k_f32b`` and
``_pair_kernel`` (pairA, pairB; :53, :77), pair_sweep.py's ``_k_pairA`` and
``_k_pairC`` (:41, :58) and pair_probe.py's ``k_pairA`` (:38, pairA with
unit scales: ``unit_scales``).
K12 ``q4_lab_gemv_layout`` (the same kernel, csrc/q4_lab.cu): f32x over
the operand layouts of ``GEMV_LAYOUTS``: kernel_lab.py's ``_k_res`` (:225,
"i", K never split), ``_k_w32`` (:281, [K/8, O] int32 words of 4 packed
rows, ``pack_w32``) and ``_k_ps`` (:384, the plane-split repack with raw
x), and decode_lab.py's ``_k_v2`` (:55, a stacked "i" weight [L, K/2, O]
and an int32 layer index on the device).
K13 ``q4_lab_dma`` (csrc/q4_lab.cu): a read of every byte.  kernel_lab.py's
``_k_dma`` (:58, "i" layout), gi_sweep.py's ``_k_giw_dma`` (:24, "ps"
layout, both scale planes) and batch_lab.py's ``_k2d_dma`` (:141, "2d")
and ``_kband``'s dma math (:207, "band"), both on the "ps" repack: the
Pallas bodies' exact touch output, which depends on ``block_kh``, and a
checksum that reads every byte.
K14 ``pair_bitcast`` (csrc/q4_lab.cu): pair_probe.py's ``k_bitcast`` (:31),
[KH, O] u8 → [2·KH, O] f32 of 128 + v, the low nibble on the even row.

The maths (w: the weight of element k from nibble v and scale s; "bf16"
means rounded once to bf16; the products accumulate in f32):

  i32, u16, f32x, pairA   bf16((v − 8)·s): one function, four instruction
                          sequences ((v − 8)·s is exact in f32 for a bf16 s)
  f32xf, i32f             f32 (v − 8)·s, x widened to f32
  f32f                    f32 fma(2^23 + v, s, f32(−(2^23 + 8)·s)): one
                          rounding, as XLA contracts the body's
                          ``lo * sexp + bexp`` on the CPU; lossy by design
  f32b                    bf16 of f32f's weight
  pairB                   pairA with the nibbles swapped (element 2c takes
                          the high nibble): a probe of the half order
  pairC                   w = bf16(bf16(128 + v)·s); y = x·w − 136·(xs·s)
                          with the caller's bf16 block sums xs [n, K/32]

A CPU tensor goes through the plain PyTorch version beside each kernel; a
CUDA tensor launches the kernel or raises.  The kernels have no backward.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Tuple

import torch

from vsim_tpu_torch.ops import _build
from vsim_tpu_torch.ops.q4_cuda import (CORE_WARPS, _aligned, core_plan,
                                        i_tile_o, stacked_layer)
from vsim_tpu_torch.quant.q4 import QK

LAB_MATHS = ("i32", "u16", "f32x", "f32f", "f32xf", "i32f", "f32b", "pairA",
             "pairB", "pairC")
# maths whose planes (and x) stay f32; the others round the planes to bf16
F32_MATHS = ("f32f", "f32xf", "i32f")
# maths that compute the same function (bit-identical planes)
SAME_FUNCTION = (("i32", "u16", "f32x", "pairA"), ("f32xf", "i32f"))
LAB_MAX_ROWS = 32
# K12's operand layouts besides "i", each under f32x (csrc/q4_lab.cu)
GEMV_LAYOUTS = ("res", "w32", "ps", "v2")
# the kernel's layouts (csrc/q4_lab.cu LabLayout)
_KERNEL_LAYOUTS = ("i", "w32", "ps", "v2", "res")
# K13's touch outputs: "i" and "ps" up to 32 rows, batch_lab's "2d" and
# "band" (on the "ps" repack) from 8 to 128
DMA_LAYOUTS = ("i", "ps", "2d", "band")
BATCH_TOUCH_ROWS = (8, 128)
# max|kernel − plain| / max|plain| on the card: only the order of the f32
# sums differs, every product being exact (pairC's too: its two terms are
# ~30x its result, and it read at most 1.6e-5 at GPT-J-6B's shapes)
TOL_LAB = 1e-4

# K12's n-tiles of 8 rows of x (csrc/q4_lab.cu lab_cols_j: 128 columns a
# warp at one n-tile, 64 at two or four)
LAB_TILES = (1, 2, 4)
_DMA_TILE_B = 512  # bytes of a K13 tile row (csrc/q4_lab.cu kDmaTileB)
_MAGIC = 0x4B000000  # f32 bits of 2^23: | v gives 2^23 + v exactly
_OFF = 8388616.0  # 2^23 + 8
_P, _I = ctypes.c_void_p, ctypes.c_int
# x, xsum, packed, scales, il, n_layers, out; n, K, O, math, layout, nt,
# wc, cluster; stream
_GEMV_ARGS = (_P,) * 5 + (_I, _P) + (_I,) * 8 + (_P,)
_DMA_ARGS = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)
_BITCAST_ARGS = (_P, _P, _I, _I, _P)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def _magic(v: torch.Tensor) -> torch.Tensor:
    """f32 2^23 + v from the bits 0x4B000000 | v (v an int32 nibble)."""
    return (v | _MAGIC).view(torch.float32)


def _pair_word(packed: torch.Tensor, hi_first: bool = False) -> torch.Tensor:
    """The int32 pair word of each byte: 0x43004300 | lo | hi << 16 (bf16
    128 + lo in the low half, 128 + hi in the high), or with the halves
    swapped (pairB)."""
    p = packed.to(torch.int32)
    if hi_first:
        bits = ((p >> 4) & 0x0F) | ((p & 0x0F) << 16)
    else:
        bits = (p & 0x0F) | ((p & 0xF0) << 12)
    return bits | 0x43004300


def _pair_halves(packed: torch.Tensor, hi_first: bool = False):
    """The pair word's two bf16 halves, [K/2, O] each: (even row, odd row)."""
    t = _pair_word(packed, hi_first).view(torch.bfloat16)  # [K/2, 2·O]
    return t[:, 0::2], t[:, 1::2]


def lab_planes(packed: torch.Tensor, scales: torch.Tensor,
               math: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The weights of elements 2c and 2c + 1 (f32 [K/2, O] each) that
    ``math`` builds from packed row c, op by op in the order of the Pallas
    body; pairC's lack the −136·s that its correction dot subtracts."""
    if math not in LAB_MATHS:
        raise ValueError(f"unknown lab math {math!r}; known: {LAB_MATHS}")
    p = packed.to(torch.int32)
    lo, hi = p & 0x0F, p >> 4
    sb = scales.repeat_interleave(QK // 2, dim=0)  # bf16 [K/2, O]
    s = sb.to(torch.float32)
    if math in ("i32", "i32f"):
        we, wo = (lo - 8).to(torch.float32) * s, (hi - 8).to(torch.float32) * s
        return (_bf16(we), _bf16(wo)) if math == "i32" else (we, wo)
    if math == "u16":
        def u16(v):
            return (v | 0x4300).to(torch.int16).view(torch.bfloat16)
        return ((u16(lo) - 136.0) * sb).float(), ((u16(hi) - 136.0) * sb).float()
    if math in ("f32x", "f32xf"):
        we, wo = (_magic(lo) - _OFF) * s, (_magic(hi) - _OFF) * s
        return (_bf16(we), _bf16(wo)) if math == "f32x" else (we, wo)
    if math in ("f32f", "f32b"):
        bexp = s * torch.tensor(-_OFF, dtype=torch.float32)
        # one rounding: the f64 product and sum are exact, the cast rounds
        we, wo = ((_magic(v).double() * s.double() + bexp.double()).float()
                  for v in (lo, hi))
        return (we, wo) if math == "f32f" else (_bf16(we), _bf16(wo))
    te, to = _pair_halves(packed, hi_first=math == "pairB")
    if math == "pairC":
        return (te * sb).float(), (to * sb).float()
    return ((te - 136.0) * sb).float(), ((to - 136.0) * sb).float()


def block_sums(x: torch.Tensor) -> torch.Tensor:
    """pairC's xs: bf16 sums of x over each 32-value block (pair_sweep.py
    :block_sums), [n, K/32]."""
    n, K = x.shape  # noqa: N806
    return x.reshape(n, K // QK, QK).sum(-1).to(torch.bfloat16)


def unit_scales(packed: torch.Tensor) -> torch.Tensor:
    """bf16 ones [K/32, O]: pair_probe's k_pairA is pairA with no scale."""
    return torch.ones((packed.shape[0] * 2 // QK, packed.shape[1]),
                      dtype=torch.bfloat16, device=packed.device)


def q4_lab_gemv_plain(x: torch.Tensor, packed: torch.Tensor,
                      scales: torch.Tensor, math: str,
                      xs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x · W in f32 with W from ``lab_planes`` (x widened exactly from
    bf16); pairC subtracts 136·(xs · s)."""
    we, wo = lab_planes(packed, scales, math)
    w = torch.stack([we, wo], dim=1).reshape(-1, we.shape[1])  # [K, O]
    y = torch.matmul(x.to(torch.float32), w)
    if math == "pairC":
        corr = torch.matmul(xs.to(torch.float32), scales.to(torch.float32))
        y = y - 136.0 * corr
    return y


def pack_w32(packed: torch.Tensor) -> torch.Tensor:
    """[K/2, O] uint8 → [K/8, O] int32 (kernel_lab.py:pack_w32): byte j of
    word row r' holds packed row 4r' + j of the same column."""
    hk, O = packed.shape  # noqa: N806
    if hk % 4:
        raise ValueError(f"pack_w32 needs K/2 % 4 == 0, got {hk}")
    return (packed.reshape(hk // 4, 4, O).permute(0, 2, 1).contiguous()
            .view(torch.int32).reshape(hk // 4, O))


def unpack_w32(w32: torch.Tensor) -> torch.Tensor:
    """``pack_w32``'s inverse: [K/8, O] int32 → [K/2, O] uint8."""
    r, O = w32.shape  # noqa: N806
    return (w32.contiguous().view(torch.uint8).reshape(r, O, 4)
            .permute(0, 2, 1).reshape(4 * r, O))


def f32x_weight(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """f32x's weight of int32 nibbles v under f32 scales s, as f32:
    bf16((2^23 + v − (2^23 + 8))·s)."""
    return _bf16((_magic(v) - _OFF) * s)


def q4_lab_gemv_layout_plain(x: torch.Tensor, weight: torch.Tensor,
                             scales: torch.Tensor, layout: str,
                             il: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """y = x · W in f32 under f32x for a weight in ``layout``: "res" the
    "i" layout, "w32" its word repack, "ps" the plane-split repack (low
    nibble of byte c element c with scale row c // 32, high nibble element
    K/2 + c with scale row K/64 + c // 32), "v2" layer ``il`` (clamped to
    [0, L), as the kernel reads it) of a stacked "i" weight."""
    if layout == "v2":
        L = weight.shape[0]  # noqa: N806
        il = il.reshape(1).clamp(0, L - 1)
        weight, scales = stacked_layer(weight, il), stacked_layer(scales, il)
    if layout == "w32":
        weight = unpack_w32(weight)
    if layout != "ps":
        return q4_lab_gemv_plain(x, weight, scales, "f32x")
    K = x.shape[1]  # noqa: N806
    p = weight.to(torch.int32)
    s = scales.to(torch.float32)
    slo = s[:K // (2 * QK)].repeat_interleave(QK, dim=0)
    shi = s[K // (2 * QK):].repeat_interleave(QK, dim=0)
    w = torch.cat([f32x_weight(p & 0x0F, slo), f32x_weight(p >> 4, shi)])  # [K, O]
    return torch.matmul(x.to(torch.float32), w)


def _dma_touch_rows(layout: str, n: int, block_kh: int) -> Tuple[int, bool]:
    """(r, per_row): the Pallas body touches output rows [0, r) with
    r = min(8, n), and adds scale row i of the tile to output row i
    (per_row) or its one scale row to every row.  Raises where the TPU
    version cannot shape the sum (a tile of 1 < rows < r scale rows; for
    batch_lab's "2d" and "band", fewer than 8 rows of x, or for "band" a
    tile of fewer than 8 scale rows)."""
    if layout in ("2d", "band"):
        if n < 8 or (layout == "band" and block_kh // QK < 8):
            raise ValueError(
                f"the TPU body cannot add 8 touched rows of the tile to "
                f"{n} rows of x with block_kh={block_kh} ({layout!r})")
        return 8, True
    r = min(8, n)
    per_tile = block_kh // (QK // 2 if layout == "i" else QK)
    srows = min(8, per_tile) if layout == "i" else per_tile
    if srows < r and srows != 1:
        raise ValueError(
            f"block_kh={block_kh} gives {srows} scale rows a tile, which the "
            f"TPU body cannot add to {r} output rows ({layout!r} layout)")
    return r, srows >= r


def _check_dma(n, K, KH, layout, block_kh):  # noqa: N803
    if layout not in DMA_LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; known: {DMA_LAYOUTS}")
    unit = QK // 2 if layout == "i" else QK
    if layout != "i" and K % (2 * QK):
        raise ValueError(f"the {layout!r} touch needs K % 64 == 0, got K={K}")
    if layout == "2d" and K < 8 * QK:
        raise ValueError(f"the TPU body cannot add the first 8 scale rows of "
                         f"a [{K // QK}, O] scale array ('2d')")
    if block_kh < unit or block_kh % unit or KH % block_kh:
        raise ValueError(f"block_kh={block_kh} must be a multiple of {unit} "
                         f"that divides K/2={KH} ({layout!r} layout)")
    top = BATCH_TOUCH_ROWS[1] if layout in ("2d", "band") else LAB_MAX_ROWS
    if not 1 <= n <= top:
        raise ValueError(f"x must have 1..{top} rows, got {n}")
    return _dma_touch_rows(layout, n, block_kh)


def q4_lab_dma_plain(x: torch.Tensor, packed: torch.Tensor,
                     scales: torch.Tensor, layout: str, block_kh: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(touch [n, O] f32, checksum [2, O] int32).  The touch is the Pallas
    body's output: over the k tiles of ``block_kh`` packed rows in grid
    order, o[i] += p[tile row i] + s[tile scale row] (+ the hi plane's for
    "ps") + x[i, the tile's first column ("i": xe's; "ps": column 0)], for
    i < min(8, n), summed left to right in f32; the other rows are 0.
    batch_lab's touches take 8 rows: "2d" adds scale row i of the whole
    array and x[i, 0], "band" the tile's scale row i and x[i, k·block_kh].
    The checksum holds each column's int32 sums of the packed bytes and of
    the raw bf16 scale bits."""
    n, K = x.shape  # noqa: N806
    KH, O = packed.shape  # noqa: N806
    r, per_row = _check_dma(n, K, KH, layout, block_kh)
    touch = torch.zeros((n, O), dtype=torch.float32, device=x.device)
    xf, sf = x.to(torch.float32), scales.to(torch.float32)
    srow = slice(0, r) if per_row else slice(0, 1)
    for k in range(KH // block_kh):
        t = packed[k * block_kh:k * block_kh + r].to(torch.float32)
        if layout == "i":
            g0 = k * block_kh // (QK // 2)
            t = t + sf[g0:][srow]
            xv = xf[:r, 2 * k * block_kh:2 * k * block_kh + 1]
        elif layout == "ps":
            g0 = k * block_kh // QK
            t = t + sf[g0:][srow]
            t = t + sf[KH // QK + g0:][srow]
            xv = xf[:r, 0:1]
        elif layout == "2d":
            t = t + sf[:r]
            xv = xf[:r, 0:1]
        else:
            g0 = k * block_kh // QK
            t = t + sf[g0:g0 + r]
            xv = xf[:r, k * block_kh:k * block_kh + 1]
        touch[:r] = touch[:r] + (t + xv)
    bits = scales.view(torch.int16).to(torch.int32) & 0xFFFF
    checksum = torch.stack([packed.to(torch.int32).sum(0, dtype=torch.int32),
                            bits.sum(0, dtype=torch.int32)])
    return touch, checksum


def pair_bitcast_plain(packed: torch.Tensor) -> torch.Tensor:
    """[2·KH, O] f32: row 2c is 128 + lo of packed row c, row 2c + 1 is
    128 + hi, read from the pair word's bf16 halves."""
    te, to = _pair_halves(packed)
    return torch.stack([te, to], dim=1).reshape(-1, te.shape[1]).float()


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_cuda(what, x, tensors):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: x must be a CUDA tensor")
    for name, t in tensors:
        if t.requires_grad:
            raise ValueError(f"{what}: the kernel has no backward, and "
                             f"{name} needs a gradient")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous on "
                             f"{x.device}")


def _check_weight(what, x, packed, scales, cols=4, max_rows=LAB_MAX_ROWS):
    if x.dim() != 2 or x.dtype != torch.bfloat16:
        raise ValueError(f"{what}: x must be bf16 [n, K], got {x.dtype} "
                         f"{tuple(x.shape)}")
    n, K = x.shape  # noqa: N806
    if not 1 <= n <= max_rows:
        raise ValueError(f"{what}: x must have 1..{max_rows} rows, got {n}")
    if K % QK:
        raise ValueError(f"{what}: K={K} must be a multiple of {QK}")
    if (packed.dtype != torch.uint8 or packed.dim() != 2
            or packed.shape[0] != K // 2):
        raise ValueError(f"{what}: packed must be uint8 [K/2, O]")
    O = packed.shape[1]  # noqa: N806
    if scales.dtype != torch.bfloat16 or tuple(scales.shape) != (K // QK, O):
        raise ValueError(f"{what}: scales must be bf16 {(K // QK, O)}, got "
                         f"{scales.dtype} {tuple(scales.shape)}")
    if O % cols or packed.data_ptr() % cols or scales.data_ptr() % (2 * cols):
        raise ValueError(f"{what}: O must be a multiple of {cols} and the "
                         f"weight {cols}-byte (packed) / {2 * cols}-byte "
                         "(scales) aligned")
    return n, K, O


def lab_plan(n: int, K: int, O: int, layout: str, sm_count: int,  # noqa: N803
             max_clusters: Callable[[int, int], int]
             ) -> Tuple[int, int, int]:
    """(nt, wc, cluster) of K12 for n rows of x and a [K/2, O] weight, as
    K9's ``i_plan``: the fewest 8-row n-tiles of ``LAB_TILES`` that hold n,
    then ``core_plan`` on that instance's clusters (``max_clusters(nt,
    cluster)``): at n <= 8 a block's 4 warps take 1, 2 or 4 column tiles of
    ``lab_tile_o`` and split K the rest of the way, past 8 rows they take 4
    tiles and share the x staged in shared memory; a cluster splits K
    further.  "res" keeps its definition, K never split across the grid: a
    cluster of one block, so each block walks all of K for its columns (its
    warps may split it inside the block at n <= 8).  Depends on the shape, the layout
    and the card alone, so a shape sums in one order."""
    nt = next(t for t in LAB_TILES if 8 * t >= n)

    def fits(c):
        return max_clusters(nt, c) if layout != "res" or c == 1 else 0

    return (nt, *core_plan(K, O, sm_count, fits,
                           tile_o=lab_tile_o(nt, layout),
                           wcs=(1, 2, 4) if nt == 1 else (CORE_WARPS,)))


def lab_tile_o(nt: int, layout: str) -> int:
    """Output columns a warp of K12 takes at ``nt`` n-tiles (csrc/q4_lab.cu
    lab_cols_j): K9's (``i_tile_o``), but 64 for "res" at every nt, whose
    K is never split across the grid, so that its blocks fill the card."""
    return 64 if layout == "res" else i_tile_o(nt)


@functools.lru_cache(maxsize=None)
def _max_clusters(index: int, math: str, layout: str, nt: int,
                  cluster: int) -> int:
    with torch.cuda.device(index):
        return _build.function("q4_lab", "q4_lab_gemv_max_clusters",
                               (_I, _I, _I, _I))(
            LAB_MATHS.index(math), _KERNEL_LAYOUTS.index(layout), nt,
            cluster)


@functools.lru_cache(maxsize=None)
def _plan(index: int, math: str, layout: str, n: int, K: int,  # noqa: N803
          O: int) -> Tuple[int, int, int]:  # noqa: N803
    return lab_plan(n, K, O, layout, _sm_count(index),
                    functools.partial(_max_clusters, index, math, layout))


def q4_lab_gemv(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                math: str, xs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K12: y [n, O] f32 for n <= 32 rows of bf16 x under ``math``; pairC
    takes the bf16 block sums ``xs`` [n, K/32] (``block_sums``)."""
    what = "q4_lab_gemv"
    if math not in LAB_MATHS:
        raise ValueError(f"{what}: unknown math {math!r}; known: {LAB_MATHS}")
    if (xs is None) != (math != "pairC"):
        raise ValueError(f"{what}: xs is pairC's input, and only pairC's")
    n, K, O = _check_weight(what, x, packed, scales)  # noqa: N806
    if xs is not None and (xs.dtype != torch.bfloat16
                           or tuple(xs.shape) != (n, K // QK)):
        raise ValueError(f"{what}: xs must be bf16 {(n, K // QK)}")
    if x.device.type == "cpu":
        return q4_lab_gemv_plain(x, packed, scales, math, xs)
    return q4_lab_gemv_planned(x, packed, scales, math, "i", xs=xs)


def _check_layout_weight(what, x, weight, scales, layout, il):
    """(n, K, O, L) of a ``q4_lab_gemv_layout`` call; raises on what the
    kernel does not take."""
    if layout not in GEMV_LAYOUTS:
        raise ValueError(f"{what}: unknown layout {layout!r}; known: "
                         f"{GEMV_LAYOUTS}")
    if (il is None) != (layout != "v2"):
        raise ValueError(f"{what}: il is v2's input, and only v2's")
    if x.dim() != 2 or x.dtype != torch.bfloat16:
        raise ValueError(f"{what}: x must be bf16 [n, K]")
    n, K = x.shape  # noqa: N806
    if not 1 <= n <= LAB_MAX_ROWS:
        raise ValueError(f"{what}: x must have 1..{LAB_MAX_ROWS} rows, got "
                         f"{n}")
    if K % (2 * QK if layout == "ps" else QK):
        raise ValueError(f"{what}: K={K} must be a multiple of "
                         f"{2 * QK if layout == 'ps' else QK} ({layout!r})")
    L = weight.shape[0] if layout == "v2" else 1  # noqa: N806
    lead = (L,) if layout == "v2" else ()
    rows, dt = (K // 8, torch.int32) if layout == "w32" else (K // 2,
                                                              torch.uint8)
    if (weight.dtype != dt or weight.dim() != len(lead) + 2
            or tuple(weight.shape[:-1]) != lead + (rows,)):
        raise ValueError(f"{what}: the {layout!r} weight must be {dt} "
                         f"{lead + (rows, 'O')}, got {weight.dtype} "
                         f"{tuple(weight.shape)}")
    O = weight.shape[-1]  # noqa: N806
    if scales.dtype != torch.bfloat16 or tuple(scales.shape) != lead + (
            K // QK, O):
        raise ValueError(f"{what}: scales must be bf16 {lead + (K // QK, O)}")
    if il is not None and (not isinstance(il, torch.Tensor)
                           or il.dtype != torch.int32 or il.numel() != 1
                           or il.device != x.device):
        raise ValueError(f"{what}: il must be a one-element int32 tensor on "
                         f"{x.device}")
    return n, K, O, L


def q4_lab_gemv_layout(x: torch.Tensor, weight: torch.Tensor,
                       scales: torch.Tensor, layout: str,
                       il: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K12 under f32x for a weight in one of ``GEMV_LAYOUTS`` (as
    ``q4_lab_gemv_layout_plain`` says); "v2" takes the layer index ``il``
    (int32, one element, on x's device), which the kernel reads itself."""
    _check_layout_weight("q4_lab_gemv", x, weight, scales, layout, il)
    if x.device.type == "cpu":
        return q4_lab_gemv_layout_plain(x, weight, scales, layout, il)
    return q4_lab_gemv_planned(x, weight, scales, "f32x", layout, il=il)


def q4_lab_gemv_planned(x: torch.Tensor, weight: torch.Tensor,
                        scales: torch.Tensor, math: str, layout: str,
                        xs: Optional[torch.Tensor] = None,
                        il: Optional[torch.Tensor] = None,
                        plan: Optional[Tuple[int, int, int]] = None
                        ) -> torch.Tensor:
    """K12 on the card: ``math`` over a weight in ``layout`` ("i", or one
    of ``GEMV_LAYOUTS`` under f32x) under ``plan`` (nt, wc, cluster), or
    ``lab_plan``'s when None: the card tests run every kind of plan.  One
    launch."""
    what = "q4_lab_gemv"
    if math not in LAB_MATHS:
        raise ValueError(f"{what}: unknown math {math!r}; known: {LAB_MATHS}")
    if layout == "i":
        n, K, O = _check_weight(what, x, weight, scales)  # noqa: N806
        L = 1  # noqa: N806
    elif math != "f32x":
        raise ValueError(f"{what}: the {layout!r} layout takes f32x only")
    else:
        n, K, O, L = _check_layout_weight(what, x, weight,  # noqa: N806
                                          scales, layout, il)
    if (xs is None) != (math != "pairC"):
        raise ValueError(f"{what}: xs is pairC's input, and only pairC's")
    _check_cuda(what, x, [("x", x), ("weight", weight), ("scales", scales)]
                + ([("il", il)] if il is not None else [])
                + ([("xs", xs)] if xs is not None else []))
    walign = 16 if layout == "w32" else 4
    if O % 4 or weight.data_ptr() % walign or scales.data_ptr() % 8:
        raise ValueError(f"{what}: O must be a multiple of 4, the weight "
                         f"{walign}-byte and the scales 8-byte aligned")
    nt, wc, cluster = plan or _plan(x.device.index, math, layout, n, K, O)
    x = _aligned(x)
    out = torch.empty((n, O), dtype=torch.float32, device=x.device)
    _build.launch(what, "q4_lab_gemv_launch", _GEMV_ARGS,
                  _build.ptr(x), _build.ptr(xs), _build.ptr(weight),
                  _build.ptr(scales), _build.ptr(il), L, _build.ptr(out), n,
                  K, O, LAB_MATHS.index(math),
                  _KERNEL_LAYOUTS.index(layout), nt, wc, cluster,
                  _build.stream_ptr(x.device))
    return out


def dma_blocks(KH: int, O: int, sm_count: int) -> int:  # noqa: N803
    """K13's checksum grid: four blocks of 256 threads an SM, each an equal
    share of the 512-byte tile rows of the packed bytes and the scales,
    never more blocks than packed tile rows (the launch adds the touch
    output's blocks)."""
    return max(1, min(-(-O // _DMA_TILE_B) * KH, 4 * sm_count))


def q4_lab_dma(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
               layout: str, block_kh: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K13: (touch [n, O] f32, checksum [2, O] int32), as
    ``q4_lab_dma_plain`` says; ``block_kh`` is the Pallas tile's packed
    rows, part of the touch's function."""
    what = "q4_lab_dma"
    n, K, O = _check_weight(what, x, packed, scales, cols=16,  # noqa: N806
                            max_rows=BATCH_TOUCH_ROWS[1])
    KH = K // 2  # noqa: N806
    _check_dma(n, K, KH, layout, block_kh)
    if x.device.type == "cpu":
        return q4_lab_dma_plain(x, packed, scales, layout, block_kh)
    _check_cuda(what, x, [("x", x), ("packed", packed), ("scales", scales)])
    touch = torch.empty((n, O), dtype=torch.float32, device=x.device)
    checksum = torch.empty((2, O), dtype=torch.int32, device=x.device)
    _build.launch(what, "q4_lab_dma_launch", _DMA_ARGS,
                  _build.ptr(x), _build.ptr(packed), _build.ptr(scales),
                  _build.ptr(touch), _build.ptr(checksum),
                  DMA_LAYOUTS.index(layout), n, K, O, block_kh,
                  dma_blocks(KH, O, _sm_count(x.device.index)),
                  _build.stream_ptr(x.device))
    return touch, checksum


def pair_bitcast(packed: torch.Tensor) -> torch.Tensor:
    """K14: [2·KH, O] f32 of 128 + v, the low nibble of row c on row 2c."""
    what = "pair_bitcast"
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise ValueError(f"{what}: packed must be uint8 [KH, O]")
    if packed.device.type == "cpu":
        return pair_bitcast_plain(packed)
    KH, O = packed.shape  # noqa: N806
    if O % 4 or packed.data_ptr() % 4 or not packed.is_contiguous():
        raise ValueError(f"{what}: packed must be contiguous, O a multiple "
                         "of 4, 4-byte aligned")
    out = torch.empty((2 * KH, O), dtype=torch.float32, device=packed.device)
    _build.launch(what, "pair_bitcast_launch", _BITCAST_ARGS,
                  _build.ptr(packed), _build.ptr(out), KH, O,
                  _build.stream_ptr(packed.device))
    return out
