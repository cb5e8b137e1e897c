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

"2d": a block owns 128 output columns and walks all of K; "band": a block
owns a band of K across all of O, and a second launch sums the bands'
partials in order.  Same function, another order of the f32 sums.

A CPU tensor goes through the plain PyTorch version; a CUDA tensor launches
the kernel or raises.  The kernel has no backward.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from vsim_tpu_torch.ops import _build
from vsim_tpu_torch.ops.q4_lab import f32x_weight
from vsim_tpu_torch.quant.q4 import QK

BATCH_MATHS = ("f32x", "bsub", "bnos")
GEOMETRIES = ("2d", "band")
BATCH_MAX_ROWS = 128
# max|kernel − plain| / max|plain| on the card: the order of the f32 sums
# only (bnos's terms are ~30x its result, as pairC's in ops/q4_lab.py)
TOL_BATCH = 1e-4

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_P,) * 6 + (_I,) * 6 + (_P,)
# what the band plan weighs: the card's bytes/s (H100 SXM data sheet) and
# the seconds a block takes for one 64-value step of K, by row tile (16-64
# rows; 128), from the 2d rows of chip_smoke.py's lab path on an H100 80GB
# HBM3 at 700 W: 2d walks K/64 steps a block in 1.34-1.73 us (n = 64) and
# 1.86-1.88 us (n = 128) a step
_PLAN_BW = 3.35e12
_PLAN_STEP_S = (1.4e-6, 1.9e-6)


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


def band_plan(n: int, K: int, O: int, sm_count: int) -> int:  # noqa: N803
    """K15's band count, from the shapes: the b in [1, min(K/64, 2·SMs)]
    (two blocks an SM fit the shared memory, so one wave) that minimises
    the modelled time, a block's steps (every 128-column tile of O times
    its ceil(K/64 / b) groups) at ``_PLAN_STEP_S`` each, plus the partials'
    8·b·n·O bytes at the card's rate: a band more is worth its n·O
    partials only while it shortens the longest block's walk."""
    step_s = _PLAN_STEP_S[n > 64]
    tiles, groups = -(-O // 128), K // (2 * QK)
    best, best_t = 1, math.inf
    for b in range(1, min(groups, 2 * sm_count) + 1):
        t = tiles * -(-groups // b) * step_s + 8 * b * n * O / _PLAN_BW
        if t < best_t:
            best, best_t = b, t
    return best


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


def q4_batch_lab(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                 math_: str, geometry: str,
                 corr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K15: y [n, O] f32 for 1 <= n <= 128 rows of bf16 x and a plane-split
    weight under ``math_`` and ``geometry``; bnos takes ``corr`` [n, O] f32
    (``batch_corr``)."""
    what = "q4_batch_lab"
    n, K, O = _check(what, x, packed, scales, math_, geometry,  # noqa: N806
                     corr)
    if x.device.type == "cpu":
        return q4_batch_lab_plain(x, packed, scales, math_, geometry, corr)
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
    band = geometry == "band"
    bands = band_plan(n, K, O, _sm_count(x.device.index)) if band else 0
    out = torch.empty((n, O), dtype=torch.float32, device=x.device)
    partial = (torch.empty((bands, n, O), dtype=torch.float32,
                           device=x.device) if band else None)
    p = _build.ptr
    _build.launch(what, "q4_batch_lab_launch", _ARGS, p(x), p(packed),
                  p(scales), p(corr), p(partial), p(out), n, K, O,
                  BATCH_MATHS.index(math_), int(band), bands,
                  _build.stream_ptr(x.device))
    return out
