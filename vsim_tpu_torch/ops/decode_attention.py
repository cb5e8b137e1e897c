"""Single-token attention over the quantized KV cache (port of
vsim_tpu/ops/decode_attention.py, non-fresh mode).

K3 ``decode_attention_q`` (csrc/decode_attention.cu) attends one query per
(b, h) over layer ``il`` of the stacked cache, keys s <= n_past[b]:

  q        [B, H, D]          rounded to bf16 (as the JAX wrapper does)
  k_q/v_q  [L, B, H, S, Dp]   int8 (Dp = D) or plane-packed uint8 int4
                              (Dp = D/2, byte c = dims c | c + D/2)
  k_s/v_s  [L, B, H, S]       bf16 per-(token, head) scales
  n_past   [B] int32
  out      [B, H, D] f32

A CPU tensor goes through ``decode_attention_plain``; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from vsim_tpu_torch.ops import _build

NEG_INF = float(torch.finfo(torch.float32).min)
_MAX_DP = 512  # packed columns a K3 block covers (csrc/decode_attention.cu)
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
         ctypes.c_float, _P)

Store = Tuple[torch.Tensor, torch.Tensor]


def kv_int(vals: torch.Tensor) -> torch.Tensor:
    """Integer cache values as f32 [..., D]: int8 as is, int4 unpacked
    from its two nibble planes (value nibble - 8)."""
    if vals.dtype == torch.uint8:
        p = vals.to(torch.int16)
        return torch.cat([(p & 0x0F) - 8, (p >> 4) - 8], dim=-1).to(
            torch.float32)
    return vals.to(torch.float32)


def decode_attention_plain(q: torch.Tensor, k_store: Store, v_store: Store,
                           il: int, n_past: torch.Tensor, *, scale: float,
                           slopes: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain version of K3: same scores, mask and softmax, materialized
    over the keys up to the longest row's horizon."""
    k_q, k_s = k_store
    v_q, v_s = v_store
    S = k_q.shape[3]  # noqa: N806
    n = min(int(n_past.max()) + 1, S)
    qf = q.to(torch.bfloat16).to(torch.float32)
    keys = kv_int(k_q[il, :, :, :n])  # [B, H, n, D]
    s = torch.einsum("bhd,bhsd->bhs", qf, keys) \
        * k_s[il, :, :, :n].to(torch.float32) * scale
    s_idx = torch.arange(n, device=q.device)
    if slopes is not None:
        s = s + slopes.to(torch.float32)[None, :, None] \
            * s_idx.to(torch.float32)
    mask = (s_idx[None, :] <= n_past[:, None].to(s_idx.dtype))[:, None, :]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)  # noqa: E741
    pw = p * v_s[il, :, :, :n].to(torch.float32)
    ctx = torch.einsum("bhs,bhsd->bhd", pw, kv_int(v_q[il, :, :, :n]))
    return ctx / torch.where(l > 0, l, 1.0)


def _check(q, k_store, v_store, il, n_past, slopes):
    k_q, k_s = k_store
    v_q, v_s = v_store
    dev = q.device
    tensors = {"q": q, "k_q": k_q, "k_s": k_s, "v_q": v_q, "v_s": v_s,
               "n_past": n_past}
    if slopes is not None:
        tensors["slopes"] = slopes
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"decode_attention_q: {name} on {t.device}, "
                             f"q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention_q: {name} must be contiguous")
    B, H, D = q.shape  # noqa: N806
    L, B2, H2, S, Dp = k_q.shape  # noqa: N806
    packed4 = k_q.dtype == torch.uint8
    if k_q.dtype not in (torch.int8, torch.uint8) or v_q.dtype != k_q.dtype:
        raise ValueError("decode_attention_q: cache values must be int8 or "
                         "plane-packed uint8 (int4)")
    if (B2, H2) != (B, H) or Dp != (D // 2 if packed4 else D) or D % 2:
        raise ValueError(f"decode_attention_q: cache {tuple(k_q.shape)} does "
                         f"not fit q {tuple(q.shape)}")
    if Dp > _MAX_DP:
        raise ValueError(f"decode_attention_q: packed head dim {Dp} > "
                         f"{_MAX_DP}")
    if tuple(v_q.shape) != tuple(k_q.shape) or tuple(k_s.shape) != (
            L, B, H, S) or tuple(v_s.shape) != (L, B, H, S):
        raise ValueError("decode_attention_q: k/v shapes disagree")
    if k_s.dtype != torch.bfloat16 or v_s.dtype != torch.bfloat16:
        raise ValueError("decode_attention_q: cache scales must be bf16")
    if n_past.dtype != torch.int32 or tuple(n_past.shape) != (B,):
        raise ValueError("decode_attention_q: n_past must be int32 [B]")
    if slopes is not None and (slopes.dtype != torch.float32
                               or tuple(slopes.shape) != (H,)):
        raise ValueError("decode_attention_q: slopes must be f32 [H]")
    if not 0 <= il < L:
        raise ValueError(f"decode_attention_q: layer {il} outside [0, {L})")
    return packed4, B, H, S, D


def decode_attention_q(q: torch.Tensor, k_store: Store, v_store: Store,
                       il: int, n_past: torch.Tensor, *, scale: float,
                       slopes: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """K3: attention of q [B, H, D] over layer ``il`` → [B, H, D] f32."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_store, v_store, il, n_past,
                                      scale=scale, slopes=slopes)
    qb = q.to(torch.bfloat16).contiguous()
    packed4, B, H, S, D = _check(qb, k_store, v_store, il, n_past,  # noqa: N806
                                 slopes)
    out = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
    p = _build.ptr
    _build.launch("decode_attention", "decode_attention_launch", _ARGS,
                  p(qb), p(k_store[0]), p(k_store[1]), p(v_store[0]),
                  p(v_store[1]), p(n_past), p(slopes), p(out), int(packed4),
                  int(il), B, H, S, D, float(scale),
                  _build.stream_ptr(q.device))
    return out


def decode_attention_oracle(q: torch.Tensor, k_store: Store, v_store: Store,
                            il: int, n_past, *, scale: float,
                            slopes: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Materialized reference for tests (the JAX package's
    decode_attention_oracle): f32 q, dequantized cache, softmax.
    q [B, 1, H, D] → [B, 1, H, D] f32."""
    B = q.shape[0]  # noqa: N806
    k_q, k_s = k_store
    v_q, v_s = v_store
    keys = kv_int(k_q[il]) * k_s[il].to(torch.float32)[..., None]
    values = kv_int(v_q[il]) * v_s[il].to(torch.float32)[..., None]
    S = keys.shape[2]  # noqa: N806
    s = torch.einsum("bthd,bhsd->bhts", q.to(torch.float32), keys) * scale
    s_idx = torch.arange(S, device=q.device)
    if slopes is not None:
        s = s + slopes.to(torch.float32)[None, :, None, None] \
            * s_idx.to(torch.float32)
    n_past = torch.as_tensor(n_past, device=q.device).reshape(-1).expand(B)
    mask = s_idx[None, :] <= n_past[:, None]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bhsd->bthd", p, values)
