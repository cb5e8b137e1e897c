"""Causal blockwise (flash) attention, forward and backward (port of
vsim_tpu/ops/attention.py).

K4 ``flash_attention_fwd`` (csrc/flash_attention.cu, replaces
``_fwd_kernel``) takes head-major q [B, H, T, D] and k/v [B, H, S, D], bf16
or f32 (all one dtype); query t sees key s iff s <= n_past + t; optional
ALiBi slopes [H].  It returns ``out`` [B, H, T, D] in q's dtype and ``lse``
[B, H, T] f32.

The backward recomputes p from q, k and lse, as ``_flash_core_bwd`` does:
K7 ``flash_attention_bwd_dq`` (replaces ``_bwd_dq_kernel``) and K8
``flash_attention_bwd_dkv`` (replaces ``_bwd_dkv_kernel``), both in
csrc/flash_attention_bwd.cu, two passes with no atomics, so the gradients
are the same from run to run.  ``flash_attention_bwd_route`` names the
instance a call takes: f32 at D = 64 and 128 runs on the tensor cores, each
f32 product as three TF32 products of operands split by ``tf32_round``
("mma_3xtf32"); everything else on the FMA units ("fma").
``FlashAttention`` wires K4 and K7/K8 into autograd; ``flash_attention`` is
the differentiable entry.

A CPU tensor goes through the plain versions; a CUDA tensor launches the
kernels or raises.
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
# K7: q, k, v, do, lse, dsum, dq, slopes; K8: ... dk, dv, slopes; then
# is_bf16, mma, B, H, T, S, D, n_past, scale, stream
_BWD_DQ_ARGS = (_P,) * 8 + (_I,) * 8 + (ctypes.c_float, _P)
_BWD_DKV_ARGS = (_P,) * 9 + (_I,) * 8 + (ctypes.c_float, _P)
_MMA_HEAD_DIMS = (64, 128)  # csrc/flash_attention_bwd.cu's 3xTF32 instances


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


def _check(q, k, v, slopes, what="flash_attention_fwd"):
    """Shapes (B, H, T, S, D) after checking what the kernels take."""
    for name, t in (("k", k), ("v", v), ("slopes", slopes)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{what}: {name} on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v), ("slopes", slopes)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if q.dtype not in (torch.bfloat16, torch.float32) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what}: q, k, v must share one dtype, bf16 or f32")
    B, H, T, D = q.shape  # noqa: N806
    S = k.shape[2]  # noqa: N806
    if tuple(k.shape) != (B, H, S, D) or tuple(v.shape) != (B, H, S, D):
        raise ValueError(f"{what}: k/v must be [B, H, S, D]")
    if D > _MAX_D:
        raise ValueError(f"{what}: head dim {D} > {_MAX_D}")
    if slopes is not None and (slopes.dtype != torch.float32
                               or tuple(slopes.shape) != (H,)):
        raise ValueError(f"{what}: slopes must be f32 [H]")
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


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor, *,
                              n_past: int = 0, scale: float,
                              slopes: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, ...]:
    """Plain version of K7 and K8 with the Pallas kernels' numerics
    (``_flash_core_bwd``, ``_bwd_dq_kernel``, ``_bwd_dkv_kernel``): do
    rounded to q's dtype, dsum = rowsum(do·out) in f32, p = exp(s − lse)
    (0 where masked or lse == NEG_INF), ds = p·(do·vᵀ − dsum)·scale, and
    dq = ds·k, dk = dsᵀ·q, dv = pᵀ·do in f32 with p unrounded.  Returns
    (dq, dk, dv) in q's, k's and v's dtypes."""
    do, dsum = _bwd_inputs(out, do, q.dtype)
    return _bwd_plain(q, k, v, do, lse, dsum, n_past=n_past, scale=scale,
                      slopes=slopes)


def _bwd_inputs(out, do, dtype):
    """do rounded to q's dtype and dsum = rowsum(do·out) [B, H, T] f32,
    computed outside the kernels as the JAX package does."""
    do = do.to(dtype).contiguous()
    return do, (do.to(torch.float32) * out.to(torch.float32)).sum(dim=-1)


def _bwd_plain(q, k, v, do, lse, dsum, *, n_past, scale, slopes):
    f32 = torch.float32
    T, S = q.shape[2], k.shape[2]  # noqa: N806
    dsum = dsum[..., None]
    qf, kf, vf, dof = (x.to(f32) for x in (q, k, v, do))
    s = torch.einsum("bhtd,bhsd->bhts", qf, kf) * scale
    s_idx = torch.arange(S, device=q.device)
    if slopes is not None:
        s = s + slopes.to(f32)[None, :, None, None] * s_idx.to(f32)
    t_idx = n_past + torch.arange(T, device=q.device)
    live = (s_idx[None, :] <= t_idx[:, None]) & (lse[..., None] != NEG_INF)
    p = torch.where(live, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bhtd,bhsd->bhts", dof, vf)
    ds = p * (dp - dsum) * scale
    dq = torch.einsum("bhts,bhsd->bhtd", ds, kf)
    dk = torch.einsum("bhts,bhtd->bhsd", ds, qf)
    dv = torch.einsum("bhts,bhtd->bhsd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_route(dtype: torch.dtype, head_dim: int) -> str:
    """The K7/K8 instance a call with q of ``dtype`` and head dim
    ``head_dim`` takes on the card: "mma_3xtf32" (tensor cores, f32 at D =
    64 and 128) or "fma" (FMA tiles: bf16 at any D, f32 at other D)."""
    if dtype == torch.float32 and head_dim in _MMA_HEAD_DIMS:
        return "mma_3xtf32"
    return "fma"


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (a 10-bit mantissa), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32``: the plain statement of the
    3xTF32 split, ``big = tf32_round(x)``, ``small = tf32_round(x − big)``.
    Non-finite values pass through."""
    bits = x.contiguous().view(torch.int32)
    r = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def _check_bwd(q, k, v, do, lse, dsum, slopes, what):
    B, H, T, S, D = _check(q, k, v, slopes, what)  # noqa: N806
    if do.device != q.device or do.dtype != q.dtype \
            or tuple(do.shape) != (B, H, T, D) or not do.is_contiguous():
        raise ValueError(f"{what}: do must be contiguous {q.dtype} "
                         f"[B, H, T, D] on {q.device}")
    for name, t in (("lse", lse), ("dsum", dsum)):
        if t.device != q.device or t.dtype != torch.float32 \
                or tuple(t.shape) != (B, H, T) or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous f32 "
                             f"[B, H, T] on {q.device}")
    if D % 4:
        raise ValueError(f"{what}: head dim {D} is not a multiple of 4")
    if any(t.data_ptr() % 16 for t in (q, k, v, do)):
        raise ValueError(f"{what}: q, k, v, do must be 16-byte aligned")
    return B, H, T, S, D


def _mma(dtype, D):  # noqa: N803
    return int(flash_attention_bwd_route(dtype, D) == "mma_3xtf32")


def flash_attention_bwd_dq(q, k, v, do, lse, dsum, *, n_past: int = 0,
                           scale: float,
                           slopes: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """K7: dq [B, H, T, D] in q's dtype from the saved lse and dsum =
    rowsum(do·out) [B, H, T] f32; ``do`` in q's dtype.  CPU tensors take
    the plain version."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, do, lse, dsum, n_past=n_past, scale=scale,
                          slopes=slopes)[0]
    B, H, T, S, D = _check_bwd(q, k, v, do, lse, dsum, slopes,  # noqa: N806
                               "flash_attention_bwd_dq")
    dq = torch.empty_like(q)
    p = _build.ptr
    _build.launch("flash_attention_bwd_dq", "flash_attention_bwd_dq_launch",
                  _BWD_DQ_ARGS, p(q), p(k), p(v), p(do), p(lse), p(dsum),
                  p(dq), p(slopes), int(q.dtype == torch.bfloat16),
                  _mma(q.dtype, D), B, H, T, S, D, int(n_past), float(scale),
                  _build.stream_ptr(q.device))
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, dsum, *, n_past: int = 0,
                            scale: float,
                            slopes: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8: (dk, dv) [B, H, S, D] in k's and v's dtype; key rows no query
    sees get zeros.  CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, do, lse, dsum, n_past=n_past, scale=scale,
                          slopes=slopes)[1:]
    B, H, T, S, D = _check_bwd(q, k, v, do, lse, dsum, slopes,  # noqa: N806
                               "flash_attention_bwd_dkv")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    p = _build.ptr
    _build.launch("flash_attention_bwd_dkv",
                  "flash_attention_bwd_dkv_launch", _BWD_DKV_ARGS, p(q), p(k),
                  p(v), p(do), p(lse), p(dsum), p(dk), p(dv), p(slopes),
                  int(q.dtype == torch.bfloat16), _mma(q.dtype, D), B, H, T,
                  S, D, int(n_past), float(scale), _build.stream_ptr(q.device))
    return dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, n_past: int = 0, scale: float,
                        slopes: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv) of ``out = flash_attention_fwd(q, k, v)`` for the
    incoming gradient ``do``: K7 then K8 (their plain versions on CPU
    tensors)."""
    do, dsum = _bwd_inputs(out, do, q.dtype)
    kw = dict(n_past=n_past, scale=scale, slopes=slopes)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, dsum, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, dsum, **kw)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Causal flash attention with its flash backward: K4 forward, K7/K8
    backward (the plain versions on the CPU).  Saves q, k, v, out, lse."""

    @staticmethod
    def forward(ctx, q, k, v, n_past: int, scale: float,
                slopes: Optional[torch.Tensor]):
        out, lse = flash_attention_fwd(q, k, v, n_past=n_past, scale=scale,
                                       slopes=slopes)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.n_past, ctx.scale, ctx.slopes = n_past, scale, slopes
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g.contiguous(),
                                         n_past=ctx.n_past, scale=ctx.scale,
                                         slopes=ctx.slopes)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    n_past: int = 0, scale: float,
                    slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable causal flash attention, head-major: q [B, H, T, D],
    k/v [B, H, S, D] → out [B, H, T, D] in q's dtype."""
    return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), int(n_past), float(scale),
                                slopes)


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
