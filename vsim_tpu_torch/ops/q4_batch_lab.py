"""The batch lab's plane-split Q4 matmul (counterpart of tools/batch_lab.py).

K15 ``q4_batch_lab`` (csrc/q4_batch_lab.cu): y [n, O] f32 = x [n, K] · W
for 1 <= n <= 128 rows of bf16 x and a plane-split ("ps") Q4 weight, on the
tensor cores, under one of three dequant maths (``BATCH_MATHS``) and two
geometries (``GEOMETRIES``): batch_lab.py's ``run_2d`` (:174; ``_k2d_f32x``,
``_k2d_bsub``, ``_k2d_bnos``, :65-117) and ``run_band`` (:251; ``_kband``,
:191).  The plane fed to the matrix unit (v the nibble, s its bf16 scale;
"bf16" means rounded once to bf16):

  f32x   bf16((2^23 + v − (2^23 + 8))·s), s widened to f32
  bsub   bf16(v − 8) × bf16 s, rounded once: bit-identical to f32x, since
         (v − 8)·s is exact in f32 (another instruction sequence)
  bnos   bf16(v·s); the output starts from ``corr`` = −8·xs·s
         (``batch_corr``: xs the f32 sums of x over each 32-value block),
         which the caller computes outside the kernel, as XLA does outside
         the Pallas call.  Lossier than f32x by design: it rounds v·s (up to
         15·s), and its correction cancels terms ~8·Σ|x·s| wide.

"2d": a thread-block cluster owns a tile of O and its blocks split K,
their partials summed in rank order in distributed shared memory (one
launch); "band": a band of K across all of O, its tiles of O dealt to as
many blocks as fill a wave with the other bands', and a second launch sums
the bands' partials in order.  Same function, another order of
the f32 sums.  The kernel (csrc/q4_batch_lab.cu) makes each plane in the
``mma.sync`` operand registers from the packed bytes (no plane goes
through shared memory), stages x's rows in shared memory and runs each
weight fragment through every 8-row n-tile, so the weight is read once a
call.  ``batch_2d_plan`` and ``band_plan`` pick the plan from the shapes
and the card; ``q4_batch_lab_planned`` takes a forced one.

A CPU tensor goes through the plain PyTorch version; a CUDA tensor launches
the kernel or raises.  The kernel has no backward.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Optional, Tuple

import torch

from vsim_tpu_torch.ops import _build
from vsim_tpu_torch.ops.q4_cuda import core_plan
from vsim_tpu_torch.ops.q4_lab import f32x_weight
from vsim_tpu_torch.quant.q4 import QK

BATCH_MATHS = ("f32x", "bsub", "bnos")
GEOMETRIES = ("2d", "band")
BATCH_MAX_ROWS = 128
# max|kernel − plain| / max|plain| on the card: the order of the f32 sums
# only (bnos's terms are ~30x its result, as pairC's in ops/q4_lab.py)
TOL_BATCH = 1e-4

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_P,) * 6 + (_I,) * 8 + (_P,)
BATCH_TILES = (1, 2, 4, 8, 16)  # 8-row n-tiles of x an instance holds
BATCH_WARPS = 4  # warps a block, each on its own columns
BATCH_MAX_CLUSTER = 8
# what the band plan weighs: the card's bytes/s (H100 SXM data sheet) and
# the seconds a block takes for one item (a 64-value group of K across a
# block's tile of O) at two blocks an SM, by n-tiles of the instance: the
# 2d geometry's walk at GPT-J-6B's fc and proj, 1.54-1.70 us a group at
# n = 64 (8 n-tiles) and 2.15-2.38 at n = 128 (16), on an H100 80GB HBM3 at
# 700 W (tools/core_plans.py --kernel batch, PERF.md §6 row 21); fewer
# n-tiles take 8's, unmeasured
_PLAN_BW = 3.35e12
_PLAN_STEP_S = {1: 1.6e-6, 2: 1.6e-6, 4: 1.6e-6, 8: 1.6e-6, 16: 2.3e-6}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def batch_planes(packed: torch.Tensor, scales: torch.Tensor,
                 math_: str) -> torch.Tensor:
    """The weight [K, O] f32 in natural K order (the low plane's K/2 rows,
    then the high plane's) that ``math_`` feeds the matrix unit."""
    if math_ not in BATCH_MATHS:
        raise ValueError(f"unknown batch math {math_!r}; known: "
                         f"{BATCH_MATHS}")
    p = packed.to(torch.int32)
    sb = scales.repeat_interleave(QK, dim=0)  # bf16 [K, O]: row r // 32
    v = torch.cat([p & 0x0F, p >> 4])  # [K, O], element order
    if math_ == "f32x":
        return f32x_weight(v, sb.to(torch.float32))
    if math_ == "bsub":
        return ((v - 8).to(torch.bfloat16) * sb).to(torch.float32)
    return (v.to(torch.bfloat16) * sb).to(torch.float32)


def batch_corr(x: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """bnos's output init (batch_lab.py:make_fn.corr_of, :276-281):
    −8 · xs @ s in f32, xs [n, K/32] the f32 sums of x over each block."""
    n, K = x.shape  # noqa: N806
    xs = x.to(torch.float32).reshape(n, K // QK, QK).sum(-1)
    return -8.0 * torch.matmul(xs, scales.to(torch.float32))


def q4_batch_lab_plain(x: torch.Tensor, packed: torch.Tensor,
                       scales: torch.Tensor, math_: str, geometry: str,
                       corr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x · W in f32 with W from ``batch_planes`` (x widened exactly from
    bf16), plus ``corr`` for bnos.  Both geometries compute this."""
    if geometry not in GEOMETRIES:
        raise ValueError(f"unknown geometry {geometry!r}; known: "
                         f"{GEOMETRIES}")
    y = torch.matmul(x.to(torch.float32), batch_planes(packed, scales, math_))
    return y + corr if math_ == "bnos" else y


# ---------------------------------------------------------------------------
# kernel
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def batch_tiles(n: int) -> int:
    """The fewest 8-row n-tiles of ``BATCH_TILES`` that hold n rows."""
    return next(t for t in BATCH_TILES if 8 * t >= n)


def batch_tile_o(nt: int) -> int:
    """Output columns a warp of K15 takes at ``nt`` n-tiles: fewer as n
    grows, so its nt * tile_o / 4 accumulators stay in registers
    (csrc/q4_batch_lab.cu:cols_j)."""
    return 128 if nt == 1 else 64 if nt <= 4 else 32


def batch_2d_plan(n: int, K: int, O: int, sm_count: int,  # noqa: N803
                  max_clusters: Callable[[int, int], int]) -> Tuple[int, int]:
    """(nt, cluster) of K15's 2d geometry: the fewest n-tiles that hold n,
    then ``core_plan`` over the instance's clusters (``max_clusters(nt,
    cluster)`` at once): a block's 4 warps on neighbouring column tiles of
    ``batch_tile_o(nt)``, K split over the cluster in 64-value groups, one
    wave, at least 1.5 blocks an SM where a plan gives that."""
    nt = batch_tiles(n)
    _, cluster = core_plan(K, O, sm_count,
                           functools.partial(max_clusters, nt),
                           tile_o=batch_tile_o(nt), wcs=(BATCH_WARPS,))
    return nt, cluster


def band_splits(bands: int, n: int, O: int, blocks_fit: int) -> int:  # noqa: N803
    """The blocks a band's tiles of O are dealt to: as many as fill one
    wave with the other bands' (``blocks_fit`` blocks at once), at most
    one a tile."""
    tiles = -(-O // (BATCH_WARPS * batch_tile_o(batch_tiles(n))))
    return max(1, min(tiles, blocks_fit // bands))


def band_plan(n: int, K: int, O: int, sm_count: int,  # noqa: N803
              blocks_fit: Optional[int] = None) -> int:
    """K15's band count, from the shapes: the b in [1, min(K/64,
    ``blocks_fit``)] (the blocks the card holds at once, two an SM by
    default: one wave) that minimises the modelled time, a block's items
    (its ``band_splits`` share of the block tiles of O times ceil(K/64 / b)
    groups) at ``_PLAN_STEP_S`` each, plus the partials' 8·b·n·O bytes at
    the card's rate: a band more is worth its n·O partials only while it
    shortens the longest block's walk."""
    nt = batch_tiles(n)
    step_s = _PLAN_STEP_S[nt]
    tiles = -(-O // (BATCH_WARPS * batch_tile_o(nt)))
    groups = K // (2 * QK)
    fit = 2 * sm_count if blocks_fit is None else blocks_fit
    best, best_t = 1, math.inf
    for b in range(1, max(1, min(groups, fit)) + 1):
        per_block = -(-tiles // band_splits(b, n, O, fit))
        t = per_block * -(-groups // b) * step_s + 8 * b * n * O / _PLAN_BW
        if t < best_t:
            best, best_t = b, t
    return best


def check_batch_plan(geometry: str, plan: Tuple[int, int], n: int, K: int,  # noqa: N803
                     O: int, max_clusters: Callable[[int, int], int]) -> None:  # noqa: N803
    """Raise on a plan K15 does not take: 2d (nt, cluster), nt n-tiles that
    hold n and a cluster of 1..8 whose clusters all fit on the card at once
    (``max_clusters(nt, cluster)``), or a cluster of 1 (the only plan that
    may take waves); band (nt, bands), 1 <= bands <= K/64 and no more
    blocks than fit at once (``max_clusters(nt, 1)``)."""
    nt, c = plan
    if nt not in BATCH_TILES or 8 * nt < n:
        raise ValueError(f"q4_batch_lab: {nt} n-tiles do not hold n={n}; "
                         f"known: {BATCH_TILES}")
    if geometry == "2d":
        tiles = -(-O // (BATCH_WARPS * batch_tile_o(nt)))
        if not 1 <= c <= BATCH_MAX_CLUSTER:
            raise ValueError(f"q4_batch_lab: cluster {c} not in 1.."
                             f"{BATCH_MAX_CLUSTER}")
        if c > 1 and tiles > max_clusters(nt, c):
            raise ValueError(f"q4_batch_lab: {tiles} clusters of {c} do not "
                             "fit on the card at once (an over-full plan)")
    elif not 1 <= c <= min(K // (2 * QK), max_clusters(nt, 1)):
        raise ValueError(f"q4_batch_lab: {c} bands: 1..{K // (2 * QK)} and "
                         "no more blocks than fit at once (an over-full "
                         "plan)")


@functools.lru_cache(maxsize=None)
def _max_clusters(index: int, math: int, band: bool, nt: int,
                  cluster: int) -> int:
    with torch.cuda.device(index):
        return _build.function("q4_batch_lab", "q4_batch_lab_max_clusters",
                               (_I,) * 4)(nt, math, int(band), cluster)


@functools.lru_cache(maxsize=None)
def _plan(index: int, math: int, geometry: str, n: int, K: int,  # noqa: N803
          O: int) -> Tuple[int, int]:  # noqa: N803
    band = geometry == "band"
    fits = functools.partial(_max_clusters, index, math, band)
    if not band:
        return batch_2d_plan(n, K, O, _sm_count(index), fits)
    nt = batch_tiles(n)
    return nt, band_plan(n, K, O, _sm_count(index), fits(nt, 1))


def _check(what, x, packed, scales, math_, geometry, corr):
    if math_ not in BATCH_MATHS:
        raise ValueError(f"{what}: unknown math {math_!r}; known: "
                         f"{BATCH_MATHS}")
    if geometry not in GEOMETRIES:
        raise ValueError(f"{what}: unknown geometry {geometry!r}; known: "
                         f"{GEOMETRIES}")
    if x.dim() != 2 or x.dtype != torch.bfloat16:
        raise ValueError(f"{what}: x must be bf16 [n, K]")
    n, K = x.shape  # noqa: N806
    if not 1 <= n <= BATCH_MAX_ROWS:
        raise ValueError(f"{what}: x must have 1..{BATCH_MAX_ROWS} rows, got "
                         f"{n}")
    if K % (2 * QK):
        raise ValueError(f"{what}: K={K} must be a multiple of {2 * QK}")
    if (packed.dtype != torch.uint8 or packed.dim() != 2
            or packed.shape[0] != K // 2):
        raise ValueError(f"{what}: packed must be plane-split uint8 [K/2, O]")
    O = packed.shape[1]  # noqa: N806
    if scales.dtype != torch.bfloat16 or tuple(scales.shape) != (K // QK, O):
        raise ValueError(f"{what}: scales must be bf16 {(K // QK, O)}")
    if (corr is None) != (math_ != "bnos"):
        raise ValueError(f"{what}: corr is bnos's input, and only bnos's")
    if corr is not None and (corr.dtype != torch.float32
                             or tuple(corr.shape) != (n, O)):
        raise ValueError(f"{what}: corr must be f32 {(n, O)}")
    return n, K, O


def batch_plan(device: torch.device, math_: str, geometry: str, n: int,
               K: int, O: int) -> Tuple[int, int]:  # noqa: N803
    """The plan ``q4_batch_lab`` takes on ``device`` (a CUDA card) for n
    rows of x and a [K/2, O] weight: (nt, cluster) for 2d, (nt, bands) for
    band."""
    return _plan(device.index or 0, BATCH_MATHS.index(math_), geometry, n,
                 K, O)


def q4_batch_lab(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                 math_: str, geometry: str,
                 corr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K15: y [n, O] f32 for 1 <= n <= 128 rows of bf16 x and a plane-split
    weight under ``math_`` and ``geometry``; bnos takes ``corr`` [n, O] f32
    (``batch_corr``)."""
    if x.device.type == "cpu":
        _check("q4_batch_lab", x, packed, scales, math_, geometry, corr)
        return q4_batch_lab_plain(x, packed, scales, math_, geometry, corr)
    return q4_batch_lab_planned(x, packed, scales, math_, geometry, corr,
                                None)


def q4_batch_lab_planned(x: torch.Tensor, packed: torch.Tensor,
                         scales: torch.Tensor, math_: str, geometry: str,
                         corr: Optional[torch.Tensor],
                         plan: Optional[Tuple[int, int]]) -> torch.Tensor:
    """K15 on the card under ``plan``, (nt, cluster) for 2d or (nt, bands)
    for band, or the planners' when None (``check_batch_plan`` refuses a
    plan that does not fit): the card tests run every kind."""
    what = "q4_batch_lab"
    n, K, O = _check(what, x, packed, scales, math_, geometry,  # noqa: N806
                     corr)
    if x.device.type != "cuda":
        raise ValueError(f"{what}: x must be a CUDA or a CPU tensor")
    for name, t in (("x", x), ("packed", packed), ("scales", scales),
                    ("corr", corr)):
        if t is None:
            continue
        if t.requires_grad:
            raise ValueError(f"{what}: the kernel has no backward, and {name} "
                             "needs a gradient")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous on "
                             f"{x.device}")
    if O % 16 or any(t.data_ptr() % 16 for t in (x, packed, scales)):
        raise ValueError(f"{what}: O must be a multiple of 16 and x, packed "
                         "and scales 16-byte aligned")
    index = x.device.index or 0
    math_i = BATCH_MATHS.index(math_)
    band = geometry == "band"
    if plan is None:
        plan = _plan(index, math_i, geometry, n, K, O)
    else:
        check_batch_plan(geometry, plan, n, K, O,
                         functools.partial(_max_clusters, index, math_i,
                                           band))
    nt, c = plan
    out = torch.empty((n, O), dtype=torch.float32, device=x.device)
    partial = (torch.empty((c, n, O), dtype=torch.float32, device=x.device)
               if band else None)
    # 2d: the cluster; band: the blocks a band's tiles are dealt to
    blocks = (band_splits(c, n, O, _max_clusters(index, math_i, True, nt, 1))
              if band else c)
    p = _build.ptr
    _build.launch(what, "q4_batch_lab_launch", _ARGS, p(x), p(packed),
                  p(scales), p(corr), p(partial), p(out), n, K, O, math_i,
                  int(band), nt, blocks, c if band else 0,
                  _build.stream_ptr(x.device))
    return out
