"""Causal blockwise (flash) attention, forward (port of
vsim_tpu/ops/attention.py:_fwd_kernel).

K4 ``flash_attention_fwd`` (csrc/flash_attention.cu) takes head-major
q [B, H, T, D] and k/v [B, H, S, D], bf16 or f32 (all one dtype); query t
sees key s iff s <= n_past + t; optional ALiBi slopes [H].  It returns
``out`` [B, H, T, D] in q's dtype and ``lse`` [B, H, T] f32 (kept for the
training slice's backward).  A CPU tensor goes through
``flash_attention_plain``; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from vsim_tpu_torch.ops import _build

NEG_INF = float(torch.finfo(torch.float32).min)
_MAX_D = 256  # csrc/flash_attention.cu kMaxD
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float,
         _P)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, n_past: int = 0, scale: float,
                          slopes: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4 with the kernel's numerics: f32 scores, p
    rounded to v's dtype before p·v, unrounded p in the denominator."""
    T, S = q.shape[2], k.shape[2]  # noqa: N806
    s = torch.einsum("bhtd,bhsd->bhts", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    s_idx = torch.arange(S, device=q.device)
    if slopes is not None:
        s = s + slopes.to(torch.float32)[None, :, None, None] \
            * s_idx.to(torch.float32)
    t_idx = n_past + torch.arange(T, device=q.device)
    mask = s_idx[None, :] <= t_idx[:, None]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)  # noqa: E741
    pv = torch.einsum("bhts,bhsd->bhtd", p.to(v.dtype).to(torch.float32),
                      v.to(torch.float32))
    live = l > 0
    out = torch.where(live, pv / torch.where(live, l, 1.0), 0.0)
    lse = torch.where(live, m + torch.log(torch.where(live, l, 1.0)),
                      NEG_INF)
    return out.to(q.dtype), lse[..., 0]


def _check(q, k, v, slopes):
    for name, t in (("k", k), ("v", v), ("slopes", slopes)):
        if t is not None and t.device != q.device:
            raise ValueError(f"flash_attention_fwd: {name} on {t.device}, "
                             f"q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v), ("slopes", slopes)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"flash_attention_fwd: {name} must be contiguous")
    if q.dtype not in (torch.bfloat16, torch.float32) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention_fwd: q, k, v must share one dtype, "
                         "bf16 or f32")
    B, H, T, D = q.shape  # noqa: N806
    S = k.shape[2]  # noqa: N806
    if tuple(k.shape) != (B, H, S, D) or tuple(v.shape) != (B, H, S, D):
        raise ValueError("flash_attention_fwd: k/v must be [B, H, S, D]")
    if D > _MAX_D:
        raise ValueError(f"flash_attention_fwd: head dim {D} > {_MAX_D}")
    if slopes is not None and (slopes.dtype != torch.float32
                               or tuple(slopes.shape) != (H,)):
        raise ValueError("flash_attention_fwd: slopes must be f32 [H]")
    return B, H, T, S, D


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, n_past: int = 0, scale: float,
                        slopes: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: (out [B, H, T, D] in q's dtype, lse [B, H, T] f32)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, n_past=n_past, scale=scale,
                                     slopes=slopes)
    B, H, T, S, D = _check(q, k, v, slopes)  # noqa: N806
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    p = _build.ptr
    _build.launch("flash_attention", "flash_attention_launch", _ARGS,
                  p(q), p(k), p(v), p(out), p(lse), p(slopes),
                  int(q.dtype == torch.bfloat16), B, H, T, S, D, int(n_past),
                  float(scale), _build.stream_ptr(q.device))
    return out, lse


def attention_reference(q, k, v, *, n_past: int = 0,
                        scale: Optional[float] = None,
                        slopes: Optional[torch.Tensor] = None):
    """Causal materialized f32 softmax reference in the JAX package's
    [B, T, H, D] layout (k/v [B, S, H, D])."""
    T, S, D = q.shape[1], k.shape[1], q.shape[-1]  # noqa: N806
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bthd,bshd->bhts", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    s_idx = torch.arange(S, device=q.device)
    if slopes is not None:
        s = s + slopes.to(torch.float32)[None, :, None, None] \
            * s_idx.to(torch.float32)
    t_idx = n_past + torch.arange(T, device=q.device)
    s = torch.where(s_idx[None, :] <= t_idx[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", p, v.to(torch.float32))
    return out.to(q.dtype)
