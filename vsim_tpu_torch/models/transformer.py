"""Decoder forward for the four reference architectures (port of
vsim_tpu/models/transformer.py, per-layer form).

The layer loop is a Python loop over per-layer parameters; stacked weights
are indexed per layer as views (models/init.py:layer_of).  The KV cache is
head-major [L, B, H, S, D] and is updated in place: a float tensor, or a
pair (values, bf16 scales [L, B, H, S]) with int8 values, or plane-packed
uint8 int4 values [L, B, H, S, D/2] (byte c = dims c | c + D/2).

``n_past`` is an int (every row at one cache length: InferenceEngine) or
an int32 [B] device tensor (ragged: each row at its own length, the
continuous-batching serving step).  A ragged row whose slots fall outside
[0, S) writes nothing, so n_past = S marks an inactive serving slot.

Attention routes:
  * one new token over an int8/int4 cache, uniform n_past → write the row,
    then K3 over rows <= n_past (ops/decode_attention.py);
  * one new token over an int8/int4 cache, ragged n_past → the deferred
    write: each layer quantizes its row and K5 attends rows < n_past[b]
    plus that row; after the layer loop K6 writes every layer's rows at
    once (one launch a step, not one a layer);
  * a prefill over its own full-precision k/v (``fresh_kv``, or no cache)
    → K4 (ops/attention.py), for every T;
  * anything else (a float cache, a multi-token step over the cache) →
    the plain einsum over the dequantized cache.
Every Q4 matmul goes through ops/matmul.py:q4_matmul.  On the ragged path
``n_past`` never becomes a Python int, so a step makes no host sync.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from vsim_tpu_torch.device import DeviceLike, resolve_device, torch_dtype
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.models.init import layer_of
from vsim_tpu_torch.ops.attention import flash_attention_fwd
from vsim_tpu_torch.ops.decode_attention import (
    NEG_INF,
    decode_attention_fresh,
    decode_attention_q,
    kv_int,
    scatter_rows,
)
from vsim_tpu_torch.ops.layers import get_activation, layer_norm
from vsim_tpu_torch.ops.matmul import q4_matmul
from vsim_tpu_torch.ops.rope import apply_rope
from vsim_tpu_torch.quant.q4 import Q4Tensor, q4_take_rows

Params = Dict[str, Any]


def alibi_slopes(n_head: int, device: DeviceLike = "cpu") -> torch.Tensor:
    """ALiBi head slopes (HF BLOOM build_alibi_tensor)."""
    cp2 = 2 ** math.floor(math.log2(n_head))
    base = 2.0 ** (-(2.0 ** -(math.log2(cp2) - 3)))
    slopes = [base ** i for i in range(1, cp2 + 1)]
    if cp2 != n_head:
        extra = 2.0 ** (-(2.0 ** -(math.log2(2 * cp2) - 3)))
        slopes += [extra ** i for i in range(1, 2 * (n_head - cp2) + 1, 2)]
    return torch.tensor(slopes, dtype=torch.float32, device=device)


def _inv_scale(s: torch.Tensor) -> torch.Tensor:
    pos = s > 0
    return torch.where(pos, 1.0 / torch.where(pos, s, 1.0), 0.0)


def _kv_quantize(new: torch.Tensor, scale_dtype):
    """Per-(token, head) symmetric int8 of a [B, H, T, D] slice:
    q = round(x / s) (half to even, as jnp.round), s = amax_D / 127."""
    a = new.to(torch.float32)
    s = a.abs().amax(dim=-1) / 127.0
    q = torch.round(a * _inv_scale(s)[..., None]).clamp(-127, 127)
    return q.to(torch.int8), s.to(scale_dtype)


def _kv_quantize4(new: torch.Tensor, scale_dtype):
    """Per-(token, head) symmetric int4, s = amax/7, offset-8 nibbles,
    plane-packed along D: byte c holds dims c (low) and c + D/2 (high)."""
    a = new.to(torch.float32)
    s = a.abs().amax(dim=-1) / 7.0
    q = torch.round(a * _inv_scale(s)[..., None]).clamp(-7, 7)
    q = q.to(torch.int16) + 8
    D = q.shape[-1]  # noqa: N806
    packed = q[..., : D // 2] | (q[..., D // 2:] << 4)
    return packed.to(torch.uint8), s.to(scale_dtype)


def _is_packed4(store) -> bool:
    return isinstance(store, tuple) and store[0].dtype == torch.uint8


def _kv_write(store, new: torch.Tensor, il: int, n_past) -> None:
    """Write a [B, T, H, D] slice into layer ``il`` at slots
    [n_past, n_past + T), in place, quantizing for an int8/int4 cache.
    A ragged ``n_past`` ([B] tensor) drops the slots outside [0, S)."""
    B, T, H = new.shape[:3]  # noqa: N806
    S = (store[0] if isinstance(store, tuple) else store).shape[3]  # noqa: N806
    new = new.transpose(1, 2)  # [B, H, T, D]
    if isinstance(store, tuple):
        quantize = _kv_quantize4 if _is_packed4(store) else _kv_quantize
        pairs = tuple(zip(store, quantize(new, store[1].dtype)))
    else:
        pairs = ((store, new.to(store.dtype)),)
    if not isinstance(n_past, torch.Tensor):
        if n_past < 0 or n_past + T > S:
            raise ValueError(f"cache write [{n_past}, {n_past + T}) outside "
                             f"[0, {S})")
        for dst, x in pairs:
            dst[il, :, :, n_past:n_past + T] = x
        return
    # Ragged: every chunk position t targets slot clamp(n_past + t, 0, S-1).
    # A target that is a real slot of the chunk takes that slot's value
    # (several writers of one slot all carry it); any other keeps the
    # cache's value, so dropped rows write nothing, with no host sync.
    dev = new.device
    npl = n_past.long()[:, None]
    slot = (npl + torch.arange(T, device=dev)).clamp(0, S - 1)  # [B, T]
    rel = slot - npl
    real = ((rel >= 0) & (rel < T))[:, None, :]  # [B, 1, T]
    ix = (torch.arange(B, device=dev)[:, None, None],
          torch.arange(H, device=dev)[None, :, None], slot[:, None, :])
    src = ix[:2] + (rel.clamp(0, T - 1)[:, None, :],)
    for dst, x in pairs:
        layer = dst[il]  # [B, H, S(, Dp)], a view
        keep = real if x.dim() == 3 else real[..., None]
        layer[ix] = torch.where(keep, x[src], layer[ix])


def _kv_read(store, il: int, n: int, dtype) -> torch.Tensor:
    """The first ``n`` slots of layer ``il``, dequantized: [B, H, n, D]."""
    if isinstance(store, tuple):
        vals, scales = store
        v = kv_int(vals[il, :, :, :n]).to(dtype)
        return v * scales[il, :, :, :n].to(dtype)[..., None]
    return store[il, :, :, :n].to(dtype)


def _linear(x, w, b, cdt):
    return q4_matmul(x, w, bias=b, compute_dtype=cdt).to(cdt)


def _attend_plain(q, keys, values, n_past, slopes, cdt):
    """The einsum path: materialized scores over the cache prefix; query t
    of row b sees key s iff s <= n_past (or n_past[b]) + t."""
    T, S = q.shape[1], keys.shape[2]  # noqa: N806
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bthd,bhsd->bhts", q.to(torch.float32),
                     keys.to(cdt).to(torch.float32)) * scale
    s_idx = torch.arange(S, device=q.device)
    if slopes is not None:
        s = s + slopes[None, :, None, None] * s_idx.to(torch.float32)
    if isinstance(n_past, torch.Tensor):
        n_past = n_past.long()[:, None]
    t_idx = (n_past + torch.arange(T, device=q.device)).reshape(-1, T)
    mask = s_idx[None, None, :] <= t_idx[:, :, None]  # [B or 1, T, S]
    s = torch.where(mask[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(cdt).to(torch.float32)
    ctx = torch.einsum("bhts,bhsd->bthd", p, values.to(cdt).to(torch.float32))
    return ctx.to(cdt)


def attention(cfg: ModelConfig, lp: Params, h: torch.Tensor,
              k_all, v_all, il: int, positions: torch.Tensor, n_past,
              n_past_vec: Optional[torch.Tensor], slopes: Optional[torch.Tensor],
              fresh_kv: bool = False,
              pending: Optional[list] = None) -> torch.Tensor:
    """``pending`` (a list) selects the deferred ragged decode step: this
    layer's quantized k/v rows are appended to it, for the caller's one
    all-layer K6 write after the loop."""
    B, T, E = h.shape  # noqa: N806
    H, D = cfg.n_head, cfg.head_dim  # noqa: N806
    cdt = h.dtype
    if "w_qkv" in lp:  # fused head-interleaved [q_h | k_h | v_h]
        qkv = _linear(h, lp["w_qkv"], lp.get("b_qkv"), cdt).view(B, T, H, 3, D)
        q, k, v = qkv.unbind(dim=3)
    else:
        q = _linear(h, lp["wq"], lp.get("bq"), cdt).view(B, T, H, D)
        k = _linear(h, lp["wk"], lp.get("bk"), cdt).view(B, T, H, D)
        v = _linear(h, lp["wv"], lp.get("bv"), cdt).view(B, T, H, D)
    if cfg.n_rot > 0:
        q = apply_rope(q, positions, cfg.n_rot,
                       interleaved=cfg.rotary_interleaved, base=cfg.rope_base)
        k = apply_rope(k, positions, cfg.n_rot,
                       interleaved=cfg.rotary_interleaved, base=cfg.rope_base)
    scale = 1.0 / math.sqrt(D)

    if pending is not None:
        quantize = _kv_quantize4 if _is_packed4(k_all) else _kv_quantize
        sdt = k_all[1].dtype
        kq, ks = quantize(k.transpose(1, 2), sdt)  # [B, H, 1, Dp], [B, H, 1]
        vq, vs = quantize(v.transpose(1, 2), sdt)
        rows = (kq[:, :, 0], ks[:, :, 0], vq[:, :, 0], vs[:, :, 0])
        pending.append(rows)
        ctx = decode_attention_fresh(q[:, 0], k_all, v_all, il, n_past_vec,
                                     rows, scale=scale, slopes=slopes)
        ctx = ctx.to(cdt).reshape(B, 1, E)
        return _linear(ctx, lp["wo"], lp.get("bo"), cdt)
    if k_all is not None:
        _kv_write(k_all, k, il, n_past)
        _kv_write(v_all, v, il, n_past)
        if T == 1 and not fresh_kv and isinstance(k_all, tuple):
            ctx = decode_attention_q(q[:, 0], k_all, v_all, il, n_past_vec,
                                     scale=scale, slopes=slopes)
            ctx = ctx.to(cdt).reshape(B, 1, E)
            return _linear(ctx, lp["wo"], lp.get("bo"), cdt)
    if k_all is None or fresh_kv:  # attend over this chunk's own k/v
        out, _ = flash_attention_fwd(
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), n_past=n_past, scale=scale,
            slopes=slopes)
        ctx = out.transpose(1, 2).to(cdt).reshape(B, T, E)
    else:
        n = (k_all[0] if isinstance(k_all, tuple) else k_all).shape[3] \
            if isinstance(n_past, torch.Tensor) else n_past + T
        keys = _kv_read(k_all, il, n, cdt)
        values = _kv_read(v_all, il, n, cdt)
        ctx = _attend_plain(q, keys, values, n_past, slopes, cdt).reshape(B, T, E)
    return _linear(ctx, lp["wo"], lp.get("bo"), cdt)


def mlp(cfg: ModelConfig, lp: Params, h: torch.Tensor) -> torch.Tensor:
    act = get_activation(cfg.activation)
    y = _linear(h, lp["w_fc"], lp.get("b_fc"), h.dtype)
    y = act(y.to(torch.float32)).to(h.dtype)
    return _linear(y, lp["w_proj"], lp.get("b_proj"), h.dtype)


def decoder_layer(cfg: ModelConfig, lp: Params, x: torch.Tensor, k_all,
                  v_all, il: int, positions: torch.Tensor, n_past,
                  n_past_vec, slopes, fresh_kv: bool = False,
                  pending: Optional[list] = None) -> torch.Tensor:
    """One block; residual topology per arch (NeoX parallel, GPT-J parallel
    with one shared LN, BLOOM/GPT-2 sequential)."""
    h1 = layer_norm(x, lp["ln1_w"], lp["ln1_b"], cfg.ln_eps)
    attn_out = attention(cfg, lp, h1, k_all, v_all, il, positions, n_past,
                         n_past_vec, slopes, fresh_kv, pending)
    if cfg.parallel_residual:
        h2 = h1 if cfg.shared_layernorm else layer_norm(
            x, lp["ln2_w"], lp["ln2_b"], cfg.ln_eps)
        return x + attn_out + mlp(cfg, lp, h2)
    x = x + attn_out
    h2 = layer_norm(x, lp["ln2_w"], lp["ln2_b"], cfg.ln_eps)
    return x + mlp(cfg, lp, h2)


def embed(cfg: ModelConfig, params: Params, token_ids: torch.Tensor, dtype):
    wte = params["wte"]
    if isinstance(wte, Q4Tensor):
        return q4_take_rows(wte, token_ids, dtype=dtype)
    return wte[token_ids].to(dtype)


def per_layer(layers, n_layer: int) -> List[Params]:
    """Per-layer parameter dicts from a dict of stacked/per-layer entries
    (a list of dicts passes through)."""
    if isinstance(layers, list):
        return layers
    return [{k: layer_of(v, il) for k, v in layers.items()}
            for il in range(n_layer)]


def forward(cfg: ModelConfig, params: Params, token_ids: torch.Tensor,
            cache: Optional[Dict[str, Any]], n_past=0,
            fresh_kv: bool = False
            ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Token ids [B, T] → (logits [B, T, n_vocab] f32, cache).

    ``n_past`` is the cache length before this chunk: an int for every row,
    or an int32 [B] tensor on the tokens' device (ragged).  The cache is
    updated in place and returned.  ``fresh_kv`` (a prefill from an empty
    cache, n_past = 0) attends over the chunk's own full-precision k/v."""
    cdt = torch_dtype(cfg.compute_dtype)
    B, T = token_ids.shape  # noqa: N806
    dev = token_ids.device
    ragged = isinstance(n_past, torch.Tensor)
    if ragged and fresh_kv:
        raise ValueError("fresh_kv prefills from an empty cache: n_past = 0")
    if ragged:
        positions = n_past.long()[:, None] + torch.arange(T, device=dev)
    else:
        positions = (n_past + torch.arange(T, device=dev))[None, :].expand(
            B, T)
    x = embed(cfg, params, token_ids, cdt)
    if cfg.learned_pos:  # a sentinel row's position is past the table
        wpe = params["wpe"]
        x = x + wpe[positions.clamp(max=wpe.shape[0] - 1)].to(cdt)
    if "emb_ln_w" in params:
        x = layer_norm(x, params["emb_ln_w"], params["emb_ln_b"], cfg.ln_eps)
    slopes = alibi_slopes(cfg.n_head, dev) if cfg.alibi else None
    k_all = cache["k"] if cache is not None else None
    v_all = cache["v"] if cache is not None else None
    if ragged:
        n_past_vec = n_past
    else:
        n_past_vec = (torch.full((B,), n_past, dtype=torch.int32, device=dev)
                      if k_all is not None and T == 1 else None)
    deferred = ragged and T == 1 and isinstance(k_all, tuple)
    pending: Optional[list] = [] if deferred else None
    for il, lp in enumerate(per_layer(params["layers"], cfg.n_layer)):
        x = decoder_layer(cfg, lp, x, k_all, v_all, il, positions, n_past,
                          n_past_vec, slopes, fresh_kv, pending)
    if deferred:  # every layer's rows at once, after the last K5 read
        rows = tuple(torch.stack(r) for r in zip(*pending))
        scatter_rows(k_all, v_all, rows, n_past)
    x = layer_norm(x, params["ln_f_w"], params["ln_f_b"], cfg.ln_eps)
    logits = q4_matmul(x, params["lm_head"], bias=params.get("lm_head_b"),
                       compute_dtype=cdt)
    if logits.shape[-1] != cfg.n_vocab:  # lm head padded for the kernels
        logits = logits[..., : cfg.n_vocab]
    return logits.to(torch.float32), cache


def init_cache(cfg: ModelConfig, batch: int, n_ctx: Optional[int] = None,
               dtype=None, device: DeviceLike = None) -> Dict[str, Any]:
    """Preallocated head-major KV cache [L, B, H, S, D].  ``dtype`` (or
    cfg.kv_dtype) "int8" stores (int8 values, bf16 scales [L, B, H, S]) per
    side; "int4" plane-packs two dims per byte (uint8 [.., D/2])."""
    dev = resolve_device(device)
    S = n_ctx or cfg.n_ctx  # noqa: N806
    name = str(dtype or cfg.kv_dtype).replace("torch.", "")
    shape = (cfg.n_layer, batch, cfg.n_head, S, cfg.head_dim)

    def pair(vdtype, d):
        return (torch.zeros((*shape[:-1], d), dtype=vdtype, device=dev),
                torch.zeros(shape[:-1], dtype=torch.bfloat16, device=dev))

    if name == "int4":
        if cfg.head_dim % 2:
            raise ValueError("int4 KV needs an even head_dim")
        return {"k": pair(torch.uint8, cfg.head_dim // 2),
                "v": pair(torch.uint8, cfg.head_dim // 2)}
    if name == "int8":
        return {"k": pair(torch.int8, cfg.head_dim),
                "v": pair(torch.int8, cfg.head_dim)}
    dt = torch_dtype(name)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}
