"""Plane-split Q4_0 matmul kernels (counterpart of vsim_tpu/ops/pallas_q4.py).

K1 ``q4_gemv_ps`` (csrc/q4_gemv_ps.cu): n <= 8 rows of bf16 x, the
grouped-integer math of ``_kernel_ps_giw`` / ``_kernel_ps_gi[_bias]``.
K2 ``q4_matmul_ps`` (csrc/q4_matmul_ps.cu): n <= 128 rows, the per-element
dequant math of ``_kernel_ps[_bias]`` (bf16 planes for bf16 x, f32 planes for
f32 x).

Each wrapper takes x [n, K], the plane-split ``packed`` [K/2, O] uint8 and
``scales`` [K/32, O] bf16, and an optional f32 ``bias`` [O]; it returns f32
[n, O].  A CPU tensor goes through the plain PyTorch version beside the
kernel; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from vsim_tpu_torch.ops import _build
from vsim_tpu_torch.quant.q4 import QK

GEMV_MAX_ROWS = 8
MATMUL_MAX_ROWS = 128
_GEMV_TILE_O = 1024  # output columns per K1 block (csrc/q4_gemv_ps.cu)

_P, _I = ctypes.c_void_p, ctypes.c_int
_GEMV_ARGS = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P)
_MATMUL_ARGS = (_P, _I, _P, _P, _P, _P, _I, _I, _I, _P)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def q4_gemv_ps_plain(x: torch.Tensor, packed: torch.Tensor,
                     scales: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grouped-integer math (_gi_rescale): x rounded to bf16; per 32-group
    s_lo (Σ x v_lo − 8 Σ x) + s_hi (Σ x v_hi − 8 Σ x), v in 0..15."""
    n, K = x.shape  # noqa: N806
    half = K // 2
    G = half // QK  # noqa: N806
    xf = x.to(torch.bfloat16).to(torch.float32)
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


def q4_matmul_ps_plain(x: torch.Tensor, packed: torch.Tensor,
                       scales: torch.Tensor,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-element dequant (_dequant_planes_ps): planes (v − 8)·s, rounded
    to bf16 when x is bf16 ("f32x"), unrounded for f32 x ("f32xf"); the
    product accumulates in f32."""
    half = packed.shape[0]
    G = half // QK  # noqa: N806
    s = scales.to(torch.float32)
    lo = ((packed & 0x0F).to(torch.float32) - 8.0) \
        * s[:G].repeat_interleave(QK, dim=0)
    hi = ((packed >> 4).to(torch.float32) - 8.0) \
        * s[G:2 * G].repeat_interleave(QK, dim=0)
    w = torch.cat([lo, hi], dim=0)  # [K, O]
    if x.dtype == torch.bfloat16:
        w = w.to(torch.bfloat16).to(torch.float32)
    y = torch.matmul(x.to(torch.float32), w)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _check(x, packed, scales, bias, max_rows, x_dtypes, what):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: x must be a CUDA tensor")
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
    if K % (2 * QK):
        raise ValueError(f"{what}: K={K} must be a multiple of 64 (whole "
                         "32-row groups in each plane)")
    if packed.dtype != torch.uint8 or packed.dim() != 2 \
            or packed.shape[0] != K // 2:
        raise ValueError(f"{what}: packed must be uint8 [K/2, O]")
    O = packed.shape[1]  # noqa: N806
    if scales.dtype != torch.bfloat16 or tuple(scales.shape) != (K // QK, O):
        raise ValueError(f"{what}: scales must be bf16 [K/32, O] = "
                         f"{(K // QK, O)}, got {scales.dtype} "
                         f"{tuple(scales.shape)}")
    if bias is not None and (bias.dtype != torch.float32
                             or tuple(bias.shape) != (O,)):
        raise ValueError(f"{what}: bias must be f32 [O]")
    return n, K, O


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def gemv_splits(K: int, O: int, sm_count: int) -> int:
    """K1's split of the 32-row groups across blocks: enough blocks for two
    per SM, never more splits than groups."""
    tiles = -(-O // _GEMV_TILE_O)
    return max(1, min(K // (2 * QK), -(-2 * sm_count // tiles)))


def q4_gemv_ps(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1: y [n, O] f32 for n <= 8 rows of bf16 x."""
    if x.device.type == "cpu":
        return q4_gemv_ps_plain(x, packed, scales, bias)
    n, K, O = _check(x, packed, scales, bias, GEMV_MAX_ROWS,  # noqa: N806
                     (torch.bfloat16,), "q4_gemv_ps")
    if O % 4 or packed.data_ptr() % 4 or scales.data_ptr() % 8:
        raise ValueError("q4_gemv_ps: O must be a multiple of 4 and the "
                         "weight 4-byte (packed) / 8-byte (scales) aligned")
    splits = gemv_splits(K, O, _sm_count(x.device.index))
    out = torch.empty((n, O), dtype=torch.float32, device=x.device)
    partial = (torch.empty((splits, n, O), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    _build.launch("q4_gemv_ps", "q4_gemv_ps_launch", _GEMV_ARGS,
                  _build.ptr(x), _build.ptr(packed), _build.ptr(scales),
                  _build.ptr(bias), _build.ptr(partial), _build.ptr(out),
                  n, K, O, splits, _build.stream_ptr(x.device))
    return out


def q4_matmul_ps(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2: y [n, O] f32 for n <= 128 rows of bf16 or f32 x."""
    if x.device.type == "cpu":
        return q4_matmul_ps_plain(x, packed, scales, bias)
    n, K, O = _check(x, packed, scales, bias, MATMUL_MAX_ROWS,  # noqa: N806
                     (torch.bfloat16, torch.float32), "q4_matmul_ps")
    out = torch.empty((n, O), dtype=torch.float32, device=x.device)
    _build.launch("q4_matmul_ps", "q4_matmul_ps_launch", _MATMUL_ARGS,
                  _build.ptr(x), int(x.dtype == torch.bfloat16),
                  _build.ptr(packed), _build.ptr(scales), _build.ptr(bias),
                  _build.ptr(out), n, K, O, _build.stream_ptr(x.device))
    return out
