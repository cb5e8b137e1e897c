"""Q4_0 matmul kernels (counterpart of vsim_tpu/ops/pallas_q4.py).

K1 ``q4_gemv_ps`` (csrc/q4_gemv_ps.cu): n <= 32 rows of bf16 x, the
grouped-integer math of ``_kernel_ps_giw`` / ``_kernel_ps_gi[_bias]``, on
the Q4 core of csrc/q4_core.cuh (mma.sync on conversion-free nibbles, K
split over a thread-block cluster, ``core_plan``) at n <= 8, and at 9-32
rows (the giw kernel's own domain) a second instance that reads the weight
once for 2 or 4 n-tiles of 8 rows (``k1_rows_plan``).  The router
(ops/matmul.py) sends K1 n <= 8 rows only.
K2 ``q4_matmul_ps`` (csrc/q4_matmul_ps.cu): n <= 128 rows, the per-element
dequant math of ``_kernel_ps[_bias]``: planes (v - 8)·s rounded to bf16 (x
too) or kept in f32, as ``round_planes`` says (ops/matmul.py decides it
from the math).  A GEMV at n <= 8; at 9-128 rows tensor cores, bf16
products with bf16 planes and TF32 products (exact for bf16 scales) with
f32 planes.
K9 ``q4_matmul_i`` and K10 ``q4_matmul_stacked`` (csrc/q4_matmul_i.cu): the
interleaved ("i") layout of ``_kernel`` and ``_kernel_stacked``, n <= 128,
one kernel: K1's core in that layout (mma.sync at every n, K split over a
cluster, ``i_plan``), reading the weight once at 9-128 rows; K10 picks
layer ``il`` (an int32 device tensor) of a stacked [L, K/2, O] weight
inside the kernel.
K11 ``q4_mlp_ps`` (csrc/q4_mlp_ps.cu): the fused ``act(x Wfc + bfc) Wproj +
bproj`` of ``_kernel_mlp_ps``, both weights plane-split, n <= 8, all in f32:
two launches of the same core, h in f32 between them.

The dequant math (``set_dequant_math``: "i32", "f32x", "f32xf" or "gi", the
JAX package's names and default) decides which kernel the routes take and
where they round (ops/matmul.py, models/transformer.py:mlp).  "i32" and
"f32x" give the same numbers: (v - 8)·s is exact in f32 either way.

Each matmul wrapper takes x [n, K], ``packed`` [K/2, O] uint8 and
``scales`` [K/32, O] bf16, and an optional f32 ``bias`` [O]; it returns f32
[n, O].  A CPU tensor goes through the plain PyTorch version beside the
kernel; a CUDA tensor launches the kernel or raises, and raises too when x
or a bias needs a gradient: the kernels have no backward.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Optional, Tuple

import torch

from vsim_tpu_torch.ops import _build
from vsim_tpu_torch.quant.q4 import QK

GEMV_MAX_ROWS = 8
K1_MAX_ROWS = 32  # K1's own domain (the giw kernel's N <= 32)
MATMUL_MAX_ROWS = 128
MLP_MAX_ROWS = 8
_GEMV_TILE_O = 1024  # output columns per block of K2's GEMV (n <= 8)
_MMA_TILE_O = 128  # output columns per block of K2's tensor-core instance
_MLP_F_MULTIPLE = 128  # K11's contract since its first port: F % 128 == 0
# the Q4 core of K1 and K11 (csrc/q4_core.cuh)
CORE_WARPS = 4  # warps a block
CORE_TILE_O = 128  # output columns a warp
CORE_MAX_CLUSTER = 8  # blocks a cluster (the portable limit)
# K1's 9-32-row instance (csrc/q4_gemv_ps.cu, rows::): 64 columns a warp
K1_ROWS_TILE_O = 64
# K9/K10 (csrc/q4_matmul_i.cu): instances by 8-row n-tiles of x
I_TILES = (1, 2, 4, 8, 16)

MATHS = ("i32", "f32x", "f32xf", "gi")
_dequant_math = "gi"

# K11's activations (models/transformer.py:_FUSED_ACTS maps config names)
MLP_ACTS = {"gelu_tanh": 0, "relu": 1, "gelu_exact": 2}

_P, _I = ctypes.c_void_p, ctypes.c_int
_GEMV_ARGS = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)
_MATMUL_ARGS = (_P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P)
_I_ARGS = (_P, _I, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)
_MLP_ARGS = (_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
             _I, _I, _P)


def set_dequant_math(name: str) -> None:
    """Select the dequant math of the Q4 routes (pallas_q4.py:74)."""
    global _dequant_math
    if name not in MATHS:
        raise ValueError(f"unknown dequant math {name!r}; known: {MATHS}")
    _dequant_math = name


def get_dequant_math() -> str:
    return _dequant_math


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def q4_gemv_ps_plain(x: torch.Tensor, packed: torch.Tensor,
                     scales: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grouped-integer math (_gi_rescale): x rounded to bf16; per 32-group
    s_lo (Σ x v_lo − 8 Σ x) + s_hi (Σ x v_hi − 8 Σ x), v in 0..15."""
    n, K = x.shape  # noqa: N806
    half = K // 2
    G = half // QK  # noqa: N806
    xf = _bf16(x)
    xlo = xf[:, :half].reshape(n, G, QK).transpose(0, 1)  # [G, n, 32]
    xhi = xf[:, half:].reshape(n, G, QK).transpose(0, 1)
    vlo = (packed & 0x0F).to(torch.float32).reshape(G, QK, -1)  # [G, 32, O]
    vhi = (packed >> 4).to(torch.float32).reshape(G, QK, -1)
    part_lo = torch.bmm(xlo, vlo)  # [G, n, O]
    part_hi = torch.bmm(xhi, vhi)
    xs_lo = xlo.sum(-1, keepdim=True)  # [G, n, 1]
    xs_hi = xhi.sum(-1, keepdim=True)
    s = scales.to(torch.float32)
    s_lo = s[:G, None, :]  # [G, 1, O]
    s_hi = s[G:2 * G, None, :]
    y = (s_lo * (part_lo - 8.0 * xs_lo) + s_hi * (part_hi - 8.0 * xs_hi)).sum(0)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y


def _ps_planes(packed: torch.Tensor, scales: torch.Tensor):
    """The two f32 planes (v − 8)·s of a plane-split weight, [K/2, O] each:
    packed row c is element c (scale row c/32) and K/2 + c (K/64 + c/32)."""
    G = packed.shape[0] // QK  # noqa: N806
    s = scales.to(torch.float32)
    lo = ((packed & 0x0F).to(torch.float32) - 8.0) \
        * s[:G].repeat_interleave(QK, dim=0)
    hi = ((packed >> 4).to(torch.float32) - 8.0) \
        * s[G:2 * G].repeat_interleave(QK, dim=0)
    return lo, hi


def q4_matmul_ps_plain(x: torch.Tensor, packed: torch.Tensor,
                       scales: torch.Tensor, bias: Optional[torch.Tensor],
                       round_planes: bool) -> torch.Tensor:
    """Per-element dequant (_dequant_planes_ps): planes (v − 8)·s, with
    planes and x rounded to bf16 when ``round_planes``; the product
    accumulates in f32."""
    w = torch.cat(_ps_planes(packed, scales), dim=0)  # [K, O]
    xf = x.to(torch.float32)
    if round_planes:
        w, xf = _bf16(w), _bf16(xf)
    y = torch.matmul(xf, w)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y


def q4_matmul_i_plain(x: torch.Tensor, packed: torch.Tensor,
                      scales: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      round_planes: bool = False) -> torch.Tensor:
    """Interleaved-layout dequant matmul (_kernel / _dequant_planes): byte c
    holds elements 2c (low nibble) and 2c+1 (high), both with scale row
    c // 16, each (v − 8)·s; y = x · W in f32 (one product over K, the sum
    order of dequantize_km + matmul), planes and x rounded to bf16 when
    ``round_planes``."""
    s = scales.to(torch.float32).repeat_interleave(QK // 2, dim=0)  # [K/2, O]
    lo = ((packed & 0x0F).to(torch.float32) - 8.0) * s
    hi = ((packed >> 4).to(torch.float32) - 8.0) * s
    w = torch.stack([lo, hi], dim=1).reshape(-1, lo.shape[1])  # [K, O]
    xf = x.to(torch.float32)
    if round_planes:
        w, xf = _bf16(w), _bf16(xf)
    y = torch.matmul(xf, w)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y


def stacked_layer(t: torch.Tensor, il: torch.Tensor) -> torch.Tensor:
    """Layer ``il`` (an int32 tensor, one element) of a stacked tensor,
    without a host sync (a copy: index_select)."""
    return torch.index_select(t, 0, il.reshape(1).to(torch.long))[0]


def q4_matmul_stacked_plain(x: torch.Tensor, packed: torch.Tensor,
                            scales: torch.Tensor, il: torch.Tensor,
                            bias: Optional[torch.Tensor] = None,
                            round_planes: bool = False) -> torch.Tensor:
    """``q4_matmul_i_plain`` on layer ``il`` of a stacked [L, K/2, O]
    weight (_kernel_stacked)."""
    return q4_matmul_i_plain(x, stacked_layer(packed, il),
                             stacked_layer(scales, il), bias, round_planes)


def _erf_poly(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz–Stegun 7.1.26, as pallas_q4.py:_erf_poly (|err| <=
    1.5e-7): what the fused TPU kernel computes for exact GELU."""
    ax = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    y = 1.0 - poly * torch.exp(-ax * ax)
    return torch.where(x < 0, -y, y)


def mlp_activation(h: torch.Tensor, act: str) -> torch.Tensor:
    """K11's activations in f32 (_kernel_mlp_ps)."""
    if act == "gelu_tanh":
        return 0.5 * h * (1.0 + torch.tanh(
            math.sqrt(2.0 / math.pi) * (h + 0.044715 * h * h * h)))
    if act == "relu":
        return torch.clamp_min(h, 0.0)
    if act == "gelu_exact":
        return 0.5 * h * (1.0 + _erf_poly(h * 0.7071067811865476))
    raise ValueError(f"unknown fused-MLP activation {act!r}; known: "
                     f"{sorted(MLP_ACTS)}")


def q4_mlp_ps_plain(x: torch.Tensor, fc_packed: torch.Tensor,
                    fc_scales: torch.Tensor, fc_bias: Optional[torch.Tensor],
                    proj_packed: torch.Tensor, proj_scales: torch.Tensor,
                    proj_bias: Optional[torch.Tensor],
                    act: str) -> torch.Tensor:
    """``act(x Wfc + bfc) Wproj + bproj`` with x, both weights' planes and
    h in f32, never rounded (the f32xf math _kernel_mlp_ps always uses)."""
    xf = x.to(torch.float32)
    half_e = xf.shape[1] // 2
    lo, hi = _ps_planes(fc_packed, fc_scales)
    h = torch.matmul(xf[:, :half_e], lo) + torch.matmul(xf[:, half_e:], hi)
    if fc_bias is not None:
        h = h + fc_bias.to(torch.float32)
    h = mlp_activation(h, act)
    half_f = h.shape[1] // 2
    lo, hi = _ps_planes(proj_packed, proj_scales)
    y = torch.matmul(h[:, :half_f], lo) + torch.matmul(h[:, half_f:], hi)
    if proj_bias is not None:
        y = y + proj_bias.to(torch.float32)
    return y


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _check(x, packed, scales, bias, max_rows, x_dtypes, what, group=2 * QK,
           ndim=2):
    """Validate a matmul launch; ``group`` is the multiple K must be (64 for
    plane-split weights: whole 32-row groups in each plane), ``ndim`` the
    weight's (3 for a stacked one)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: x must be a CUDA tensor")
    if x.requires_grad or (bias is not None and bias.requires_grad):
        raise ValueError(f"{what}: the kernel has no backward, and x or the "
                         "bias needs a gradient (a gradient through a Q4 "
                         "weight takes the n > 128 dequant route)")
    for name, t in (("packed", packed), ("scales", scales), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, x on {x.device}")
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous")
    if x.dim() != 2 or x.shape[0] > max_rows or x.shape[0] < 1:
        raise ValueError(f"{what}: x must be [1..{max_rows}, K], got "
                         f"{tuple(x.shape)}")
    if x.dtype not in x_dtypes:
        raise ValueError(f"{what}: x dtype {x.dtype} not in {x_dtypes}")
    n, K = x.shape  # noqa: N806
    if K % group:
        raise ValueError(f"{what}: K={K} must be a multiple of {group}")
    lead = packed.shape[:-2]
    if (packed.dtype != torch.uint8 or packed.dim() != ndim
            or packed.shape[-2] != K // 2):
        raise ValueError(f"{what}: packed must be uint8 "
                         f"{'[L, K/2, O]' if ndim == 3 else '[K/2, O]'}")
    O = packed.shape[-1]  # noqa: N806
    if scales.dtype != torch.bfloat16 or tuple(scales.shape) != (
            *lead, K // QK, O):
        raise ValueError(f"{what}: scales must be bf16 [..., K/32, O] = "
                         f"{(*lead, K // QK, O)}, got {scales.dtype} "
                         f"{tuple(scales.shape)}")
    if bias is not None and (bias.dtype != torch.float32
                             or tuple(bias.shape) != (O,)):
        raise ValueError(f"{what}: bias must be f32 [O]")
    return n, K, O


def _check_quads(what, O, packed, scales):  # noqa: N803
    if O % 4 or packed.data_ptr() % 4 or scales.data_ptr() % 8:
        raise ValueError(f"{what}: O must be a multiple of 4 and the weight "
                         "4-byte (packed) / 8-byte (scales) aligned")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def core_plan(K: int, O: int, sm_count: int,  # noqa: N803
              max_clusters: Callable[[int], int], tile_o: int = CORE_TILE_O,
              wcs: Tuple[int, ...] = (1, 2, 4)) -> Tuple[int, int]:
    """(wc, cluster) of the Q4 core for a [K/2, O] weight: a block's 4 warps
    take ``wc`` column tiles of ``tile_o`` (``wc`` one of ``wcs``) and split
    K ``4 / wc`` ways in units of 64 values of K (the last may be half of
    one: K = 32 * odd in the "i" layout), and the ``cluster`` blocks of a
    cluster split it further, so K is split ``4 / wc * cluster`` ways
    without partials in HBM.  Only plans whose clusters all fit on the card
    at once (``max_clusters(cluster)``) are taken: one wave.  Of those with
    1.5 blocks an SM or more (loads in flight on every SM), else a block an
    SM, the ones whose busiest warp's units times the blocks is within 5% of
    the least (the ideal, tiles x units / 4, when every warp has the same
    number of units and every block four warps on columns of the weight);
    of those the most
    blocks, then the smallest cluster (the fastest plan at every GPT-J-6B
    and Pythia-12B shape in ``tools/core_plans.py``'s sweep on the card,
    PERF.md).  Depends on the shape and the card alone, so a shape sums in
    one order."""
    groups = -(-K // (2 * QK))
    tiles = -(-O // tile_o)
    plans = []  # (blocks, work, wc, cluster)
    for wc in wcs:
        clusters = -(-tiles // wc)
        for c in range(1, CORE_MAX_CLUSTER + 1):
            if clusters <= max_clusters(c):
                blocks = clusters * c
                work = -(-groups // (CORE_WARPS // wc * c)) * blocks
                plans.append((blocks, work, wc, c))
    if not plans:  # more column tiles than the card holds clusters: waves
        return max(wcs), 1
    plans = ([p for p in plans if 2 * p[0] >= 3 * sm_count]
             or [p for p in plans if p[0] >= sm_count] or plans)
    least = min(p[1] for p in plans)
    _, _, wc, c = min((p for p in plans if 20 * p[1] <= 21 * least),
                      key=lambda p: (-p[0], p[3], p[2]))
    return wc, c


@functools.lru_cache(maxsize=None)
def _max_clusters(source: str, index: int, cluster: int) -> int:
    with torch.cuda.device(index):
        return _build.function(source, f"{source}_max_clusters",
                               (_I,))(cluster)


@functools.lru_cache(maxsize=None)
def _plan(source: str, index: int, K: int, O: int) -> Tuple[int, int]:  # noqa: N803
    return core_plan(K, O, _sm_count(index),
                     functools.partial(_max_clusters, source, index))


def i_tile_o(nt: int) -> int:
    """Output columns a warp of K9/K10 takes at ``nt`` n-tiles of x: fewer
    as n grows, so the nt * tile_o / 4 accumulators a thread holds stay in
    registers (csrc/q4_matmul_i.cu:cols_j)."""
    return 128 if nt == 1 else 64 if nt <= 4 else 32


def i_plan(n: int, K: int, O: int, sm_count: int,  # noqa: N803
           max_clusters: Callable[[int, int], int]) -> Tuple[int, int, int]:
    """(nt, wc, cluster) of K9/K10 for n rows of x and a [K/2, O] "i"
    weight: the fewest 8-row n-tiles of ``I_TILES`` that hold n, then
    ``core_plan`` on that instance's clusters (``max_clusters(nt,
    cluster)``).  At n <= 8, K1's plans; past 8 rows every warp of a block
    takes its own columns of the same units of K (wc = 4: they share the
    x staged in shared memory) and only the cluster splits K."""
    nt = next(t for t in I_TILES if 8 * t >= n)
    fits = functools.partial(max_clusters, nt)
    if nt == 1:
        return (nt, *core_plan(K, O, sm_count, fits))
    return (nt, *core_plan(K, O, sm_count, fits, tile_o=i_tile_o(nt),
                           wcs=(CORE_WARPS,)))


def k1_rows_plan(n: int, K: int, O: int, sm_count: int,  # noqa: N803
                 max_clusters: Callable[[int, int], int]) -> Tuple[int, int]:
    """(nt, cluster) of K1's 9-32-row instance for n rows of x and a
    [K/2, O] weight: 2 n-tiles of 8 rows up to 16 rows, else 4, then
    ``core_plan`` on that instance's clusters (``max_clusters(nt,
    cluster)``) with every warp of a block on its own 64 columns of the same
    groups (wc = 4): only the cluster splits K."""
    if not GEMV_MAX_ROWS < n <= K1_MAX_ROWS:
        raise ValueError(f"k1_rows_plan: n={n} is not in 9..{K1_MAX_ROWS}")
    nt = 2 if n <= 16 else 4
    _, c = core_plan(K, O, sm_count, functools.partial(max_clusters, nt),
                     tile_o=K1_ROWS_TILE_O, wcs=(CORE_WARPS,))
    return nt, c


@functools.lru_cache(maxsize=None)
def _k1_rows_max_clusters(index: int, nt: int, cluster: int) -> int:
    with torch.cuda.device(index):
        return _build.function("q4_gemv_ps", "q4_gemv_ps_rows_max_clusters",
                               (_I, _I))(nt, cluster)


@functools.lru_cache(maxsize=None)
def _k1_rows_plan(index: int, n: int, K: int, O: int) -> Tuple[int, int]:  # noqa: N803
    return k1_rows_plan(n, K, O, _sm_count(index),
                        functools.partial(_k1_rows_max_clusters, index))


@functools.lru_cache(maxsize=None)
def _i_max_clusters(index: int, x_bf16: bool, round_planes: bool, nt: int,
                    cluster: int) -> int:
    with torch.cuda.device(index):
        return _build.function("q4_matmul_i", "q4_matmul_i_max_clusters",
                               (_I, _I, _I, _I))(nt, int(x_bf16),
                                                 int(round_planes), cluster)


@functools.lru_cache(maxsize=None)
def _i_plan(index: int, n: int, K: int, O: int, x_bf16: bool,  # noqa: N803
            round_planes: bool) -> Tuple[int, int, int]:
    return i_plan(n, K, O, _sm_count(index),
                  functools.partial(_i_max_clusters, index, x_bf16,
                                    round_planes))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, copied if its data does not start on 16 bytes (the core reads
    x 16 bytes at a time)."""
    return t.clone() if t.data_ptr() % 16 else t


def q4_gemv_ps(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1: y [n, O] f32 for n <= 32 rows of bf16 x."""
    if x.device.type == "cpu":
        return q4_gemv_ps_plain(x, packed, scales, bias)
    return q4_gemv_ps_planned(x, packed, scales, bias, None)


def q4_gemv_ps_planned(x: torch.Tensor, packed: torch.Tensor,
                       scales: torch.Tensor, bias: Optional[torch.Tensor],
                       plan: Optional[Tuple[int, int]]) -> torch.Tensor:
    """K1 on the card.  At n <= 8 under ``plan`` (wc, cluster), or
    ``core_plan``'s when None; at 9-32 rows under (nt, cluster), or
    ``k1_rows_plan``'s: the card tests run every kind of plan on small
    shapes.  One launch."""
    n, K, O = _check(x, packed, scales, bias, K1_MAX_ROWS,  # noqa: N806
                     (torch.bfloat16,), "q4_gemv_ps")
    _check_quads("q4_gemv_ps", O, packed, scales)
    x = _aligned(x)
    out = torch.empty((n, O), dtype=torch.float32, device=x.device)
    if n <= GEMV_MAX_ROWS:
        wc, cluster = plan or _plan("q4_gemv_ps", x.device.index, K, O)
        _build.launch("q4_gemv_ps", "q4_gemv_ps_launch", _GEMV_ARGS,
                      _build.ptr(x), _build.ptr(packed),
                      _build.ptr(scales), _build.ptr(bias), _build.ptr(out),
                      n, K, O, wc, cluster, _build.stream_ptr(x.device))
        return out
    nt, cluster = plan or _k1_rows_plan(x.device.index, n, K, O)
    _build.launch("q4_gemv_ps", "q4_gemv_ps_rows_launch", _GEMV_ARGS,
                  _build.ptr(x), _build.ptr(packed),
                  _build.ptr(scales), _build.ptr(bias), _build.ptr(out),
                  n, K, O, nt, cluster, _build.stream_ptr(x.device))
    return out


def q4_matmul_ps_splits(n: int, K: int, O: int,  # noqa: N803
                        sm_count: int) -> int:
    """K2's split of K in whole 64-value groups (32 packed rows of each
    plane), from the shapes alone: as many splits of the column tiles (1024
    columns for the GEMV at n <= 8, 128 for the tensor-core instances) as
    fill two blocks an SM without starting a second wave, one block an SM
    for the tensor cores past 32 rows (where the partials would outweigh the
    weight).  Both plane contracts take the same plan: the bf16- and the
    TF32-product instances hold as many blocks an SM."""
    tile = _GEMV_TILE_O if n <= GEMV_MAX_ROWS else _MMA_TILE_O
    blocks = sm_count * (2 if n <= 32 else 1)
    return max(1, min(K // (2 * QK), blocks // -(-O // tile)))


def q4_matmul_ps(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                 bias: Optional[torch.Tensor],
                 round_planes: bool) -> torch.Tensor:
    """K2: y [n, O] f32 for n <= 128 rows of bf16 or f32 x, planes and x
    rounded to bf16 when ``round_planes``."""
    if x.device.type == "cpu":
        return q4_matmul_ps_plain(x, packed, scales, bias, round_planes)
    return q4_matmul_ps_planned(x, packed, scales, bias, round_planes, None)


def q4_matmul_ps_planned(x: torch.Tensor, packed: torch.Tensor,
                         scales: torch.Tensor, bias: Optional[torch.Tensor],
                         round_planes: bool,
                         splits: Optional[int]) -> torch.Tensor:
    """K2 on the card with K split ``splits`` ways (1 to K/64), or
    ``q4_matmul_ps_splits``'s when None: the card tests run every split."""
    what = "q4_matmul_ps"
    n, K, O = _check(x, packed, scales, bias, MATMUL_MAX_ROWS,  # noqa: N806
                     (torch.bfloat16, torch.float32), what)
    if n <= GEMV_MAX_ROWS:
        _check_quads(what, O, packed, scales)
    if splits is None:
        splits = q4_matmul_ps_splits(n, K, O, _sm_count(x.device.index))
    out = torch.empty((n, O), dtype=torch.float32, device=x.device)
    partial = (torch.empty((splits, n, O), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    _build.launch(what, "q4_matmul_ps_launch", _MATMUL_ARGS,
                  _build.ptr(x), int(x.dtype == torch.bfloat16),
                  int(round_planes), _build.ptr(packed),
                  _build.ptr(scales), _build.ptr(bias), _build.ptr(partial),
                  _build.ptr(out), n, K, O, splits,
                  _build.stream_ptr(x.device))
    return out


def q4_matmul_i(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K9: y [n, O] f32 for n <= 128 rows of x and an interleaved weight;
    f32 planes, as ``q4_matmul`` calls ``pallas_q4_matmul`` (acc f32)."""
    if x.device.type == "cpu":
        return q4_matmul_i_plain(x, packed, scales, bias)
    return q4_matmul_i_planned(x, packed, scales, None, bias, False, None)


def q4_matmul_stacked(x: torch.Tensor, packed: torch.Tensor,
                      scales: torch.Tensor, il: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      round_planes: bool = False) -> torch.Tensor:
    """K10: y [n, O] f32 = x · (layer ``il`` of a stacked interleaved
    [L, K/2, O] weight); the kernel reads ``il`` (int32, one element, on
    x's device) itself, so no layer is sliced and the host never syncs."""
    if x.device.type == "cpu":
        return q4_matmul_stacked_plain(x, packed, scales, il, bias,
                                       round_planes)
    return q4_matmul_i_planned(x, packed, scales, il, bias, round_planes,
                               None)


def q4_matmul_i_planned(x: torch.Tensor, packed: torch.Tensor,
                        scales: torch.Tensor, il: Optional[torch.Tensor],
                        bias: Optional[torch.Tensor], round_planes: bool,
                        plan: Optional[Tuple[int, int, int]]) -> torch.Tensor:
    """K10 on the card (K9 when ``il`` is None: a [K/2, O] weight, f32
    planes) under ``plan`` (nt, wc, cluster), or ``i_plan``'s when None:
    the card tests run every kind of plan on small shapes.  One launch."""
    what = "q4_matmul_i" if il is None else "q4_matmul_stacked"
    _, K, O = _check(x, packed, scales, bias, MATMUL_MAX_ROWS,  # noqa: N806
                     (torch.bfloat16, torch.float32), what, group=QK,
                     ndim=2 if il is None else 3)
    if il is not None and (
            not isinstance(il, torch.Tensor) or il.dtype != torch.int32
            or il.numel() != 1 or il.device != x.device):
        raise ValueError(f"{what}: il must be a one-element int32 tensor on "
                         f"{x.device}")
    _check_quads(what, O, packed, scales)
    n = x.shape[0]
    x_bf16 = x.dtype == torch.bfloat16
    nt, wc, cluster = plan or _i_plan(x.device.index, n, K, O, x_bf16,
                                      bool(round_planes))
    x = _aligned(x)
    out = torch.empty((n, O), dtype=torch.float32, device=x.device)
    _build.launch(what, "q4_matmul_i_launch", _I_ARGS,
                  _build.ptr(x), int(x_bf16), _build.ptr(packed),
                  _build.ptr(scales), _build.ptr(il),
                  1 if il is None else packed.shape[0], _build.ptr(bias),
                  _build.ptr(out), n, K, O, nt, wc, cluster,
                  int(round_planes), _build.stream_ptr(x.device))
    return out


def q4_mlp_ps(x: torch.Tensor, fc_packed: torch.Tensor,
              fc_scales: torch.Tensor, fc_bias: Optional[torch.Tensor],
              proj_packed: torch.Tensor, proj_scales: torch.Tensor,
              proj_bias: Optional[torch.Tensor], act: str) -> torch.Tensor:
    """K11: ``act(x Wfc + bfc) Wproj + bproj`` → f32 [n, E] for n <= 8 rows
    of x [n, E], plane-split fc [E/2, F] and proj [F/2, E] weights; the
    [n, F] intermediate never leaves the chip and is never rounded."""
    if act not in MLP_ACTS:
        raise ValueError(f"unknown fused-MLP activation {act!r}; known: "
                         f"{sorted(MLP_ACTS)}")
    if x.device.type == "cpu":
        return q4_mlp_ps_plain(x, fc_packed, fc_scales, fc_bias, proj_packed,
                               proj_scales, proj_bias, act)
    what = "q4_mlp_ps"
    n, E, F = _check(x, fc_packed, fc_scales, fc_bias,  # noqa: N806
                     MLP_MAX_ROWS, (torch.bfloat16, torch.float32), what)
    if fc_packed.dim() != 2 or F % _MLP_F_MULTIPLE:
        raise ValueError(f"{what}: fc must be [E/2, F] with F % "
                         f"{_MLP_F_MULTIPLE} == 0, got "
                         f"{tuple(fc_packed.shape)}")
    for name, t, shape, dt in (
            ("proj packed", proj_packed, (F // 2, E), torch.uint8),
            ("proj scales", proj_scales, (F // QK, E), torch.bfloat16),
            ("proj bias", proj_bias, (E,), torch.float32)):
        if t is not None and t.requires_grad:
            raise ValueError(f"{what}: the kernel has no backward, and the "
                             f"{name} needs a gradient")
        if t is not None and (tuple(t.shape) != shape or t.dtype != dt
                              or t.device != x.device
                              or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be contiguous {dt} "
                             f"{shape} on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    _check_quads(what, F, fc_packed, fc_scales)
    _check_quads(what, E, proj_packed, proj_scales)
    index = x.device.index
    fc_plan = _plan("q4_mlp_ps", index, E, F)
    proj_plan = _plan("q4_mlp_ps", index, F, E)
    x = _aligned(x)
    h = torch.empty((n, F), dtype=torch.float32, device=x.device)
    out = torch.empty((n, E), dtype=torch.float32, device=x.device)
    _build.launch(what, "q4_mlp_ps_launch", _MLP_ARGS,
                  _build.ptr(x), int(x.dtype == torch.bfloat16),
                  _build.ptr(fc_packed), _build.ptr(fc_scales),
                  _build.ptr(fc_bias), _build.ptr(proj_packed),
                  _build.ptr(proj_scales), _build.ptr(proj_bias),
                  _build.ptr(h), _build.ptr(out), n, E, F, MLP_ACTS[act],
                  *fc_plan, *proj_plan, _build.stream_ptr(x.device))
    return out
