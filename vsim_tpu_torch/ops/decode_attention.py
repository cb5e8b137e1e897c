"""Single-token attention over the quantized KV cache, and the row writer
of the ragged serving step and of the graphed one-token step (port of
vsim_tpu/ops/decode_attention.py).

K3 ``decode_attention_q`` (csrc/decode_attention.cu) attends one query per
(b, h) over layer ``il`` of the stacked cache, keys s <= n_past[b], split
across blocks by ``decode_split_plan`` (flash-decoding: partials, then an
in-order combine; K5 shares both):

  q        [B, H, D]          rounded to bf16 (as the JAX wrapper does)
  k_q/v_q  [L, B, H, S, Dp]   int8 (Dp = D) or plane-packed uint8 int4
                              (Dp = D/2, byte c = dims c | c + D/2)
  k_s/v_s  [L, B, H, S]       bf16 per-(token, head) scales
  n_past   [B] int32
  out      [B, H, D] f32

K5 ``decode_attention_fresh`` (the same source, fresh mode) attends keys
s < min(n_past[b], S) of the cache plus this step's own quantized row
``fresh_rows = (knq [B, H, Dp], kns [B, H] bf16, vnq, vns)``, which the
cache does not hold yet.  K6 ``scatter_rows`` (csrc/kv_scatter_rows.cu)
then writes every layer's rows ``(kq [L, B, H, Dp], ks [L, B, H], vq, vs)``
at slot n_past[b], in place; a row with n_past[b] outside [0, S) writes
nothing (n_past = S is the serving engine's inactive-slot sentinel).  With
a layer ``il`` it writes that layer's rows ([B, H, Dp], [B, H]) alone: the
graphed one-token step writes its row so before K3 reads the layer.

A CPU tensor goes through the plain version beside each kernel; a CUDA
tensor launches the kernel or raises, and raises too when q or another
float input needs a gradient: K3 and K5 have no backward.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from vsim_tpu_torch.ops import _build

NEG_INF = float(torch.finfo(torch.float32).min)
_MAX_DP = 512  # packed columns a K3 / K5 block covers (csrc/decode_attention.cu)
_SPLIT_TILE = 64  # keys per tile of K3/K5's pass 1 (kSplitTile)
_P, _I = ctypes.c_void_p, ctypes.c_int
# q, kq, ks, vq, vs, n_past, slopes, part, out; packed4, il, B, H, S, D, c,
# n_split, W; scale; stream
_ARGS = (_P,) * 9 + (_I,) * 9 + (ctypes.c_float, _P)
# q, kq, ks, vq, vs, n_past, slopes, knq, kns, vnq, vns, part, out; packed4,
# il, B, H, S, D, c, n_split, W; scale; stream
_FRESH_ARGS = (_P,) * 13 + (_I,) * 9 + (ctypes.c_float, _P)
_SCATTER_ARGS = (_P,) * 9 + (_I,) * 5 + (_P,)

Store = Tuple[torch.Tensor, torch.Tensor]
Rows = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


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


def decode_split_plan(B: int, H: int, S: int, n_sm: int  # noqa: N803
                      ) -> Tuple[int, int]:
    """K3's and K5's split of the S cache rows of each (b, h): (c,
    n_split), splits [i c, i c + c) for i < n_split.  From the shapes alone,
    never from n_past, so the call makes no host sync.  c is a power-of-two
    multiple of the 64-key tile, the largest whose grid of B·H·n_split
    blocks holds at least 1.5× the SM count (about two waves), or 64 where S
    does not allow that many: 16 splits of 128 at GPT-J B=1 on 132 SMs, 8 of
    256 at Pythia-12B's 40 heads, 2 of 1024 for the B=8 serving step."""
    c = _SPLIT_TILE
    while c < S:
        c *= 2
    while c > _SPLIT_TILE and B * H * -(-S // c) < 1.5 * n_sm:
        c //= 2
    return c, max(1, -(-S // c))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _load_width(Dp: int, tensors) -> int:  # noqa: N803
    """K3/K5's load width in bytes: the largest power of two up to 16 that
    divides Dp and every cache address, so each row chunk is one aligned
    load."""
    w = 16
    while w > 1 and (Dp % w or any(t.data_ptr() % w for t in tensors)):
        w //= 2
    return w


def decode_attention_fresh_plain(q: torch.Tensor, k_store: Store,
                                 v_store: Store, il: int, n_past: torch.Tensor,
                                 fresh_rows: Rows, *, scale: float,
                                 slopes: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Plain version of K5: the masked scores of cache rows
    s < min(n_past[b], S) and the fresh row's score (ALiBi at position
    n_past[b]) in one softmax.  Materialized over all S rows, so it makes
    no host sync."""
    k_q, k_s = k_store
    v_q, v_s = v_store
    knq, kns, vnq, vns = fresh_rows
    S = k_q.shape[3]  # noqa: N806
    qf = q.to(torch.bfloat16).to(torch.float32)
    s = torch.einsum("bhd,bhsd->bhs", qf, kv_int(k_q[il])) \
        * k_s[il].to(torch.float32) * scale
    s_new = (qf * kv_int(knq)).sum(-1) * kns.to(torch.float32) * scale
    s_idx = torch.arange(S, device=q.device)
    if slopes is not None:
        sl = slopes.to(torch.float32)[None, :]
        s = s + sl[..., None] * s_idx.to(torch.float32)
        s_new = s_new + sl * n_past.to(torch.float32)[:, None]
    mask = (s_idx[None, :] < n_past[:, None].to(s_idx.dtype))[:, None, :]
    s = torch.where(mask, s, NEG_INF)
    m = torch.maximum(s.amax(dim=-1), s_new)[..., None]  # [B, H, 1]
    p = torch.where(mask, torch.exp(s - m), 0.0)
    p_new = torch.exp(s_new[..., None] - m)
    l = p.sum(dim=-1, keepdim=True) + p_new  # noqa: E741
    pw = p * v_s[il].to(torch.float32)
    ctx = torch.einsum("bhs,bhsd->bhd", pw, kv_int(v_q[il])) \
        + p_new * vns.to(torch.float32)[..., None] * kv_int(vnq)
    return ctx / l


def scatter_rows_plain(k_store: Store, v_store: Store, rows: Rows,
                       n_past: torch.Tensor, il: Optional[int] = None) -> None:
    """Plain version of K6: index assignment of the rows at slot n_past[b],
    in place; a row outside [0, S) keeps the cache's bytes.  Every layer's
    rows (kq [L, B, H, Dp], ks [L, B, H], vq, vs), or with ``il`` one
    layer's (kq [B, H, Dp], ks [B, H], ...) into layer ``il`` alone."""
    if il is not None:
        k_store = tuple(t[il:il + 1] for t in k_store)
        v_store = tuple(t[il:il + 1] for t in v_store)
        rows = tuple(r[None] for r in rows)
    kq, ks, vq, vs = rows
    L, B, H = ks.shape  # noqa: N806
    S = k_store[0].shape[3]  # noqa: N806
    dev = ks.device
    keep = ((n_past >= 0) & (n_past < S))[None, :, None]  # [1, B, 1]
    ix = (torch.arange(L, device=dev)[:, None, None],
          torch.arange(B, device=dev)[None, :, None],
          torch.arange(H, device=dev)[None, None, :],
          n_past.long().clamp(0, S - 1)[None, :, None])  # -> [L, B, H]
    for (vals, scales), (rq, rs) in ((k_store, (kq, ks)), (v_store, (vq, vs))):
        vals[ix] = torch.where(keep[..., None], rq, vals[ix])
        scales[ix] = torch.where(keep, rs, scales[ix])


def _check(what, q, k_store, v_store, il, n_past, slopes, fresh_rows=None):
    k_q, k_s = k_store
    v_q, v_s = v_store
    dev = q.device
    tensors = {"q": q, "k_q": k_q, "k_s": k_s, "v_q": v_q, "v_s": v_s,
               "n_past": n_past}
    if slopes is not None:
        tensors["slopes"] = slopes
    if fresh_rows is not None:
        tensors.update(zip(("knq", "kns", "vnq", "vns"), fresh_rows))
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.requires_grad:
            raise ValueError(f"{what}: the kernel has no backward, and {name} "
                             "needs a gradient")
    B, H, D = q.shape  # noqa: N806
    L, B2, H2, S, Dp = k_q.shape  # noqa: N806
    packed4 = k_q.dtype == torch.uint8
    if k_q.dtype not in (torch.int8, torch.uint8) or v_q.dtype != k_q.dtype:
        raise ValueError(f"{what}: cache values must be int8 or plane-packed "
                         "uint8 (int4)")
    if (B2, H2) != (B, H) or Dp != (D // 2 if packed4 else D) or D % 2:
        raise ValueError(f"{what}: cache {tuple(k_q.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    if Dp > _MAX_DP:
        raise ValueError(f"{what}: packed head dim {Dp} > {_MAX_DP}")
    if tuple(v_q.shape) != tuple(k_q.shape) or tuple(k_s.shape) != (
            L, B, H, S) or tuple(v_s.shape) != (L, B, H, S):
        raise ValueError(f"{what}: k/v shapes disagree")
    if k_s.dtype != torch.bfloat16 or v_s.dtype != torch.bfloat16:
        raise ValueError(f"{what}: cache scales must be bf16")
    if n_past.dtype != torch.int32 or tuple(n_past.shape) != (B,):
        raise ValueError(f"{what}: n_past must be int32 [B]")
    if slopes is not None and (slopes.dtype != torch.float32
                               or tuple(slopes.shape) != (H,)):
        raise ValueError(f"{what}: slopes must be f32 [H]")
    if not 0 <= il < L:
        raise ValueError(f"{what}: layer {il} outside [0, {L})")
    if fresh_rows is not None:
        knq, kns, vnq, vns = fresh_rows
        if knq.dtype != k_q.dtype or vnq.dtype != k_q.dtype or tuple(
                knq.shape) != (B, H, Dp) or tuple(vnq.shape) != (B, H, Dp):
            raise ValueError(f"{what}: fresh rows must be [B, H, Dp] of the "
                             "cache's value dtype")
        if kns.dtype != torch.bfloat16 or vns.dtype != torch.bfloat16 or \
                tuple(kns.shape) != (B, H) or tuple(vns.shape) != (B, H):
            raise ValueError(f"{what}: fresh scales must be bf16 [B, H]")
    return packed4, B, H, S, D


def _split_scratch(what, qb, k_store, v_store,
                   B, H, S, D, packed4):  # noqa: N803
    """The split plan, load width, partials scratch and output of a K3 or
    K5 launch (both share pass 1 and the combine)."""
    Dp = D // 2 if packed4 else D  # noqa: N806
    w = _load_width(Dp, (k_store[0], v_store[0]))
    if Dp // w > 256:
        raise ValueError(f"{what}: the cache's addresses allow only {w}-byte "
                         f"loads of {Dp}-byte rows")
    c, n_split = decode_split_plan(B, H, S, _sm_count(qb.device.index or 0))
    part = torch.empty((B, H, n_split, D + 2), dtype=torch.float32,
                       device=qb.device)
    out = torch.empty((B, H, D), dtype=torch.float32, device=qb.device)
    return c, n_split, w, part, out


def decode_attention_q(q: torch.Tensor, k_store: Store, v_store: Store,
                       il: int, n_past: torch.Tensor, *, scale: float,
                       slopes: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """K3: attention of q [B, H, D] over layer ``il`` → [B, H, D] f32."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_store, v_store, il, n_past,
                                      scale=scale, slopes=slopes)
    what = "decode_attention_q"
    qb = q.to(torch.bfloat16).contiguous()
    packed4, B, H, S, D = _check(  # noqa: N806
        what, qb, k_store, v_store, il, n_past, slopes)
    c, n_split, w, part, out = _split_scratch(what, qb, k_store, v_store, B,
                                              H, S, D, packed4)
    p = _build.ptr
    _build.launch("decode_attention", "decode_attention_launch", _ARGS,
                  p(qb), p(k_store[0]), p(k_store[1]), p(v_store[0]),
                  p(v_store[1]), p(n_past), p(slopes), p(part), p(out),
                  int(packed4), int(il), B, H, S, D, c, n_split, w,
                  float(scale), _build.stream_ptr(q.device))
    return out


def decode_attention_fresh(q: torch.Tensor, k_store: Store, v_store: Store,
                           il: int, n_past: torch.Tensor, fresh_rows: Rows, *,
                           scale: float,
                           slopes: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """K5: attention of q [B, H, D] over layer ``il``'s rows < n_past[b]
    and this step's ``fresh_rows`` → [B, H, D] f32."""
    if q.device.type == "cpu":
        return decode_attention_fresh_plain(q, k_store, v_store, il, n_past,
                                            fresh_rows, scale=scale,
                                            slopes=slopes)
    what = "decode_attention_fresh"
    qb = q.to(torch.bfloat16).contiguous()
    rows = tuple(r.contiguous() for r in fresh_rows)
    packed4, B, H, S, D = _check(  # noqa: N806
        what, qb, k_store, v_store, il, n_past, slopes, rows)
    c, n_split, w, part, out = _split_scratch(what, qb, k_store, v_store, B,
                                              H, S, D, packed4)
    p = _build.ptr
    _build.launch("decode_attention_fresh", "decode_attention_fresh_launch",
                  _FRESH_ARGS, p(qb), p(k_store[0]), p(k_store[1]),
                  p(v_store[0]), p(v_store[1]), p(n_past), p(slopes),
                  *(p(r) for r in rows), p(part), p(out), int(packed4),
                  int(il), B, H, S, D, c, n_split, w, float(scale),
                  _build.stream_ptr(q.device))
    return out


def scatter_rows(k_store: Store, v_store: Store, rows: Rows,
                 n_past: torch.Tensor, il: Optional[int] = None) -> None:
    """K6: write rows (kq [L, B, H, Dp], ks [L, B, H], vq, vs) into every
    layer of the cache at slot n_past[b], in place, on the current stream
    (after the layer loop whose K5 calls read the cache); with ``il``, one
    layer's rows (kq [B, H, Dp], ks [B, H], ...) into layer ``il`` alone,
    one launch (the graphed one-token step, before K3 reads the layer)."""
    if n_past.device.type == "cpu":
        scatter_rows_plain(k_store, v_store, rows, n_past, il)
        return
    k_q, k_s = k_store
    v_q, v_s = v_store
    what = "scatter_rows"
    tensors = {"k_q": k_q, "k_s": k_s, "v_q": v_q, "v_s": v_s,
               **dict(zip(("kq", "ks", "vq", "vs"), rows)), "n_past": n_past}
    for name, t in tensors.items():
        if t.device != n_past.device:
            raise ValueError(f"{what}: {name} on {t.device}, n_past on "
                             f"{n_past.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    Lc, B, H, S, Dp = k_q.shape  # noqa: N806
    kq, ks, vq, vs = rows
    if k_q.dtype not in (torch.int8, torch.uint8) or any(
            t.dtype != k_q.dtype for t in (v_q, kq, vq)):
        raise ValueError(f"{what}: cache values and rows must share one dtype,"
                         " int8 or uint8")
    if any(t.dtype != torch.bfloat16 for t in (k_s, v_s, ks, vs)):
        raise ValueError(f"{what}: scales must be bf16")
    if tuple(v_q.shape) != (Lc, B, H, S, Dp) or any(
            tuple(t.shape) != (Lc, B, H, S) for t in (k_s, v_s)):
        raise ValueError(f"{what}: k/v cache shapes disagree")
    lead = (Lc,) if il is None else ()
    if any(tuple(t.shape) != lead + (B, H, Dp) for t in (kq, vq)) or any(
            tuple(t.shape) != lead + (B, H) for t in (ks, vs)):
        raise ValueError(f"{what}: rows must be {lead + (B, H, Dp)} and "
                         f"{lead + (B, H)} for a cache {tuple(k_q.shape)}"
                         + ("" if il is None else f" and layer {il}"))
    if n_past.dtype != torch.int32 or tuple(n_past.shape) != (B,):
        raise ValueError(f"{what}: n_past must be int32 [B]")
    if il is not None and not 0 <= il < Lc:
        raise ValueError(f"{what}: layer {il} outside [0, {Lc})")
    cache = (k_q, k_s, v_q, v_s) if il is None else tuple(
        t[il] for t in (k_q, k_s, v_q, v_s))  # contiguous views of layer il
    p = _build.ptr
    _build.launch("scatter_rows", "scatter_rows_launch", _SCATTER_ARGS,
                  p(kq), p(ks), p(vq), p(vs), p(n_past), *(p(t) for t in cache),
                  Lc if il is None else 1, B, H, S, Dp,
                  _build.stream_ptr(n_past.device))


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
