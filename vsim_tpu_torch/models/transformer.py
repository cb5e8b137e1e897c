"""Decoder forward for the four reference architectures (port of
vsim_tpu/models/transformer.py, per-layer form).

The layer loop is a Python loop over per-layer parameters.  A stacked Q4
weight reaches each layer as a ``Q4Layer`` (ops/matmul.py: K10 picks the
layer inside the kernel); other stacked entries are per-layer views
(models/init.py:layer_of).  The KV cache is
head-major [L, B, H, S, D] and is updated in place: a float tensor, or a
pair (values, bf16 scales [L, B, H, S]) with int8 values, or plane-packed
uint8 int4 values [L, B, H, S, D/2] (byte c = dims c | c + D/2).

``n_past`` is an int (every row at one cache length: InferenceEngine) or
an int32 [B] device tensor (ragged: each row at its own length, the
continuous-batching serving step).  A ragged row whose slots fall outside
[0, S) writes nothing, so n_past = S marks an inactive serving slot.

Attention routes:
  * one new token over an int8/int4 cache, uniform n_past, or ragged with
    ``write_first`` (InferenceEngine's graphed step, whose n_past lives on
    the device) → write the row, then K3 over rows <= n_past[b]
    (ops/decode_attention.py); both give the same cache bytes and logits.
    A uniform n_past writes by slicing; a ragged one through K6's one-layer
    instance (``scatter_rows(..., il)``: k and v of the layer in one launch,
    a row outside [0, S) writing nothing);
  * one new token over an int8/int4 cache, ragged n_past → the deferred
    write: each layer quantizes its row and K5 attends rows < n_past[b]
    plus that row; after the layer loop K6 writes every layer's rows at
    once (one launch a step, not one a layer);
  * a prefill over its own full-precision k/v (``fresh_kv``, or no cache:
    training and perplexity) → ``flash_attention`` (ops/attention.py), K4
    forward and K7/K8 backward, for every T; with ``cfg.use_flash`` False
    the plain einsum over that k/v instead (the JAX package's switch; its
    T >= 256 and S % 128 gates have no counterpart);
  * anything else (a float cache, a multi-token step over the cache) →
    the plain einsum over the dequantized cache: all S rows, masked, for
    a one-token step or a ragged n_past, rows < n_past + T otherwise.
Every Q4 matmul goes through ops/matmul.py:q4_matmul, or with
``cfg.act_quant`` through q4_matmul_act_quant; off the gi dequant math an
MLP of n <= 8 rows with plane-split weights is one K11 launch (``mlp``).
On the ragged path
``n_past`` never becomes a Python int, so a step makes no host sync and
can be captured in a CUDA graph; BLOOM's ALiBi slopes, the one tensor a
step would copy from the host, are built once by the engines and passed
in.

Under a mesh (parallel/context.py:use_mesh) each rank runs its own shard
(parallel/sharding.py:shard_params): its heads, ffn neurons and vocab
rows, its cache heads [L, B, H/tp, S, D].  Head counts come from the
weights' shapes, so a block whose weights are whole runs as without a
mesh; ALiBi slopes are sliced to the rank's heads.  The collectives run at
named points: the f32 partial sums after ``wo`` and ``w_proj`` are
all-reduced before the replicated bias is added, once, and the cast
(``_linear``); a vocab-split embedding is a masked local lookup plus an
all-reduce; the lm head's logits are gathered to the whole vocabulary, so
every rank samples the same token.  A weight the sharding holds whole
(where GSPMD would gather it) takes its whole input: a whole ``wo`` or
``w_proj`` under split heads or neurons runs on its input gathered over
the model axis, with no all-reduce (``_out_linear``); a whole lm head
gives whole logits, a whole ``wte`` is a plain lookup.  Under
``rules={"seq": "model"}`` (Megatron-SP, for a prefill or
``forward_nocache``) the residual stream keeps the rank's tokens through
the LN/residual segments, its token axis padded to a multiple of the axis,
and is gathered, pad rows dropped, before attention, the MLP and the
head: no pad row reaches attention, the cache or the logits.  Without a
mesh nothing of this runs, and the single-device path is unchanged.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from vsim_tpu_torch.device import DeviceLike, resolve_device, torch_dtype
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.models.init import layer_of
from vsim_tpu_torch.ops.attention import flash_attention
from vsim_tpu_torch.ops.decode_attention import (
    NEG_INF,
    decode_attention_fresh,
    decode_attention_q,
    kv_int,
    scatter_rows,
)
from vsim_tpu_torch.ops.layers import get_activation, layer_norm
from vsim_tpu_torch.ops.matmul import Q4Layer, q4_matmul, q4_matmul_act_quant
from vsim_tpu_torch.ops.q4_cuda import MLP_MAX_ROWS, get_dequant_math, q4_mlp_ps
from vsim_tpu_torch.ops.rope import apply_rope
from vsim_tpu_torch.parallel import context as pctx
from vsim_tpu_torch.quant.q4 import Q4Tensor, q4_take_rows

Params = Dict[str, Any]

# config activations K11 computes (vsim_tpu/models/transformer.py:371-373)
_FUSED_ACTS = {"gelu_tanh": "gelu_tanh", "gelu_new": "gelu_tanh",
               "gelu_fast": "gelu_tanh", "relu": "relu",
               "gelu_exact": "gelu_exact"}


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


def _row_slots(n_past: torch.Tensor, S: int):  # noqa: N803
    """A one-token ragged write's targets into a float cache: (slot [B]
    int64, n_past[b] clamped into [0, S); keep [B] bool, n_past[b] in
    [0, S))."""
    n = n_past.long()
    slot = n.clamp(0, S - 1)
    return slot, slot == n


def _kv_write(store, new: torch.Tensor, il: int, n_past,
              rows: Optional[tuple] = None) -> None:
    """Write a [B, T, H, D] slice into layer ``il`` at slots
    [n_past, n_past + T), in place, quantizing for an int8/int4 cache.
    A ragged ``n_past`` ([B] tensor) drops the slots outside [0, S);
    ``rows`` is its ``_row_slots`` for T = 1 into a float cache, made once
    a step (a quantized cache's one-token ragged row goes to K6)."""
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
    dev = new.device
    if T == 1 and not isinstance(store, tuple):  # slot n_past[b] if in [0, S)
        slot, keep = rows if rows is not None else _row_slots(n_past, S)
        ((_, x),) = pairs
        layer = store[il]  # [B, H, S, D], a view
        ix = slot.view(B, 1, 1, 1).expand_as(x)
        layer.scatter_(2, ix, torch.where(keep.view(B, 1, 1, 1), x,
                                          layer.gather(2, ix)))
        return
    # Ragged: every chunk position t targets slot clamp(n_past + t, 0, S-1).
    # A target that is a real slot of the chunk takes that slot's value
    # (several writers of one slot all carry it); any other keeps the
    # cache's value, so dropped rows write nothing, with no host sync.
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


def _quantized_row(k_all, k: torch.Tensor, v: torch.Tensor):
    """This step's one k/v row [B, 1, H, D] quantized for the int8/int4
    cache ``k_all``, as ``_kv_write`` quantizes a slice: (kq [B, H, Dp],
    ks [B, H], vq, vs)."""
    quantize = _kv_quantize4 if _is_packed4(k_all) else _kv_quantize
    sdt = k_all[1].dtype
    kq, ks = quantize(k.transpose(1, 2), sdt)  # [B, H, 1, Dp], [B, H, 1]
    vq, vs = quantize(v.transpose(1, 2), sdt)
    return kq[:, :, 0], ks[:, :, 0], vq[:, :, 0], vs[:, :, 0]


def _kv_read(store, il: int, n: int, dtype) -> torch.Tensor:
    """The first ``n`` slots of layer ``il``, dequantized: [B, H, n, D]."""
    if isinstance(store, tuple):
        vals, scales = store
        v = kv_int(vals[il, :, :, :n]).to(dtype)
        return v * scales[il, :, :, :n].to(dtype)[..., None]
    return store[il, :, :, :n].to(dtype)


class Par(NamedTuple):
    """A forward's mesh axes (parallel/context.py:axis), None where the
    mesh does not split: ``heads`` / ``ffn`` split attention's and the
    MLP's weights, ``vocab`` the embedding and lm head, ``seq`` (sequence
    parallelism) the residual stream's ``n_tok`` tokens."""

    heads: Optional[pctx.Axis] = None
    ffn: Optional[pctx.Axis] = None
    vocab: Optional[pctx.Axis] = None
    seq: Optional[pctx.Axis] = None
    n_tok: int = 0


NO_PAR = Par()


def _out_features(w) -> int:
    return w.out_features if isinstance(w, (Q4Tensor, Q4Layer)) \
        else w.shape[-2]


def _in_features(w) -> int:
    if isinstance(w, Q4Layer):
        return w.stacked.in_features
    return w.in_features if isinstance(w, Q4Tensor) else w.shape[-1]


def _split_axis(n_local: int, n_full: int, ax: Optional[pctx.Axis],
                what: str) -> Optional[pctx.Axis]:
    """The axis a block's weights split over under a mesh axis ``ax``
    (None without one, or when they are whole here): ``n_local`` of
    ``n_full`` heads or neurons on this rank."""
    if ax is None or n_local == n_full:
        return None
    if n_local * ax.size != n_full:
        raise ValueError(
            f"{what}: {n_local} of {n_full} on this rank, which is not a "
            f"whole share over {ax.size} ranks: the model axis must split "
            "them into whole heads (parallel/sharding.py:check_heads)")
    return ax


def _whole_weight(w, n_local: int, ax: Optional[pctx.Axis]) -> bool:
    """Whether the output weight ``w`` of a block split over ``ax`` (its
    input ``n_local`` wide on this rank) is whole here: held whole where
    the JAX specs replicate it (parallel/sharding.py:shard_params)."""
    return ax is not None and _in_features(w) == n_local * ax.size


def _seq_local(a: torch.Tensor, par: Par) -> torch.Tensor:
    """This rank's tokens (axis 1) of every token's ``a``, the token axis
    padded with zero rows to a multiple of ``par.seq`` (GSPMD's padding;
    ``_seq_full`` drops the pad rows again)."""
    pad = -par.n_tok % par.seq.size
    if pad:
        a = torch.nn.functional.pad(a, (0, 0, 0, pad))
    return pctx.local(a, 1, par.seq)


def _seq_full(a: torch.Tensor, par: Par) -> torch.Tensor:
    """Every token's ``a`` from each rank's share: gathered over
    ``par.seq``, the pad rows dropped."""
    return pctx.gather(a.contiguous(), 1, par.seq).narrow(1, 0, par.n_tok)


def _linear(x, w, b, cdt, act_quant: bool = False,
            reduce: Optional[pctx.Axis] = None, par: Par = NO_PAR):
    """``x @ w.T + b`` in ``cdt``.  ``reduce``: each rank of that axis holds
    a K slice of ``w`` (row-parallel): the f32 partial sums are all-reduced,
    then the replicated bias is added once and the result cast.  Under
    ``par.seq``: then keep this rank's tokens (axis 1)."""
    if reduce is None and par.seq is None:
        if act_quant:
            y = q4_matmul_act_quant(x, w, compute_dtype=cdt)
            return (y if b is None else y + b.to(y.dtype)).to(cdt)
        return q4_matmul(x, w, bias=b, compute_dtype=cdt).to(cdt)
    y = (q4_matmul_act_quant(x, w, compute_dtype=cdt) if act_quant
         else q4_matmul(x, w, compute_dtype=cdt))
    return _row_parallel_out(y, b, cdt, reduce, par)


def _out_linear(x, w, b, cdt, act_quant: bool, ax: Optional[pctx.Axis],
                par: Par):
    """A block's output product (``wo``, ``w_proj``) on ``x``, the block
    split over ``ax``: row-parallel where ``w`` holds this rank's K slice;
    where ``w`` is whole here, ``x`` gathered over ``ax`` (head / neuron
    order) and the whole product, no all-reduce, the bias added once."""
    if _whole_weight(w, x.shape[-1], ax):
        x, ax = pctx.gather(x.contiguous(), -1, ax), None
    return _linear(x, w, b, cdt, act_quant, ax, par)


def _row_parallel_out(y, b, dtype, reduce, par: Par):
    """A row-parallel product's f32 partial sums [B, T, O] → the sum (over
    ``reduce``), this rank's tokens (``par.seq``), + bias, in ``dtype``."""
    if reduce is not None:
        y = pctx.all_reduce(y.contiguous(), reduce)
    if par.seq is not None:
        y = _seq_local(y, par)
    return (y if b is None else y + b.to(y.dtype)).to(dtype)


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
              fresh_kv: bool = False, pending: Optional[list] = None,
              rows: Optional[tuple] = None, par: Par = NO_PAR
              ) -> torch.Tensor:
    """``pending`` (a list) selects the deferred ragged decode step: this
    layer's quantized k/v rows are appended to it, for the caller's one
    all-layer K6 write after the loop.  ``rows``: ``_kv_write``'s.  Under
    a mesh it runs the heads the weights hold (the rank's share); under
    ``par.seq`` ``h`` holds every token and the output this rank's."""
    B, T, _ = h.shape  # noqa: N806
    D = cfg.head_dim  # noqa: N806
    H = cfg.n_head if par.heads is None else local_heads(cfg, lp)  # noqa: N806
    E = H * D  # noqa: N806
    red = _split_axis(H, cfg.n_head, par.heads, "attention heads")
    cdt, aq = h.dtype, cfg.act_quant
    if "w_qkv" in lp:  # fused head-interleaved [q_h | k_h | v_h]
        qkv = _linear(h, lp["w_qkv"], lp.get("b_qkv"), cdt, aq).view(
            B, T, H, 3, D)
        q, k, v = qkv.unbind(dim=3)
    else:
        q = _linear(h, lp["wq"], lp.get("bq"), cdt, aq).view(B, T, H, D)
        k = _linear(h, lp["wk"], lp.get("bk"), cdt, aq).view(B, T, H, D)
        v = _linear(h, lp["wv"], lp.get("bv"), cdt, aq).view(B, T, H, D)
    if cfg.n_rot > 0:
        q = apply_rope(q, positions, cfg.n_rot,
                       interleaved=cfg.rotary_interleaved, base=cfg.rope_base)
        k = apply_rope(k, positions, cfg.n_rot,
                       interleaved=cfg.rotary_interleaved, base=cfg.rope_base)
    scale = 1.0 / math.sqrt(D)
    # the reference's decode kernel rounds q to bf16, and it takes that
    # kernel only where D % 128 == 0; elsewhere its einsum keeps q in f32
    round_q = D % 128 == 0

    if pending is not None:
        rows = _quantized_row(k_all, k, v)
        pending.append(rows)
        ctx = decode_attention_fresh(q[:, 0], k_all, v_all, il, n_past_vec,
                                     rows, scale=scale, slopes=slopes,
                                     round_q=round_q)
        ctx = ctx.to(cdt).reshape(B, 1, E)
        return _out_linear(ctx, lp["wo"], lp.get("bo"), cdt, aq, red, par)
    if k_all is not None:
        if T == 1 and isinstance(n_past, torch.Tensor) and isinstance(
                k_all, tuple):  # K6's one-layer instance: one launch
            scatter_rows(k_all, v_all, _quantized_row(k_all, k, v), n_past,
                         il)
        else:
            _kv_write(k_all, k, il, n_past, rows)
            _kv_write(v_all, v, il, n_past, rows)
        if T == 1 and not fresh_kv and isinstance(k_all, tuple):
            ctx = decode_attention_q(q[:, 0], k_all, v_all, il, n_past_vec,
                                     scale=scale, slopes=slopes,
                                     round_q=round_q)
            ctx = ctx.to(cdt).reshape(B, 1, E)
            return _out_linear(ctx, lp["wo"], lp.get("bo"), cdt, aq, red, par)
    if k_all is None or fresh_kv:  # attend over this chunk's own k/v
        if cfg.use_flash:
            out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), n_past=n_past,
                                  scale=scale, slopes=slopes)
            ctx = out.transpose(1, 2).to(cdt).reshape(B, T, E)
        else:
            ctx = _attend_plain(q, k.transpose(1, 2), v.transpose(1, 2),
                                n_past, slopes, cdt).reshape(B, T, E)
    else:
        # a ragged step reads every row (n_past is on the device); so does
        # a uniform one-token step, so that the two give the same bits
        n = (k_all[0] if isinstance(k_all, tuple) else k_all).shape[3] \
            if isinstance(n_past, torch.Tensor) or T == 1 else n_past + T
        keys = _kv_read(k_all, il, n, cdt)
        values = _kv_read(v_all, il, n, cdt)
        ctx = _attend_plain(q, keys, values, n_past, slopes, cdt).reshape(B, T, E)
    return _out_linear(ctx, lp["wo"], lp.get("bo"), cdt, aq, red, par)


def local_heads(cfg: ModelConfig, lp: Params) -> int:
    """The attention heads a layer's weights hold (a rank's share under a
    mesh): q/k/v's output rows, fused or not, over the head dim."""
    D = cfg.head_dim  # noqa: N806
    fused = "w_qkv" in lp
    per = 3 * D if fused else D
    out = _out_features(lp["w_qkv" if fused else "wq"])
    if out % per:
        raise ValueError(f"{out} q/k/v output rows do not hold whole heads "
                         f"of {per} rows: the model axis must split "
                         "attention into whole heads")
    return out // per


def _fusable(w) -> bool:
    return isinstance(w, Q4Tensor) and w.layout == "ps"


def mlp(cfg: ModelConfig, lp: Params, h: torch.Tensor,
        par: Par = NO_PAR) -> torch.Tensor:
    """fc, activation, proj.  Off the gi math, n <= 8 rows with plane-split
    weights take K11, which keeps h in f32 (the unfused route rounds it to
    the compute dtype twice): the n <= 8 cut decides the numerics.  Under
    a mesh the weights hold a rank's neurons and proj's output is reduced,
    or proj is whole and takes every neuron (``_out_linear``); under
    ``par.seq`` the output holds this rank's tokens."""
    w_fc, w_proj = lp["w_fc"], lp["w_proj"]
    n_fc = _out_features(w_fc)
    red = _split_axis(n_fc, cfg.n_ff, par.ffn, "ffn neurons")
    split = red is not None or par.seq is not None
    n = h.numel() // h.shape[-1]
    if (not cfg.act_quant and _fusable(w_fc) and _fusable(w_proj)
            and not _whole_weight(w_proj, n_fc, red)
            and cfg.activation in _FUSED_ACTS
            and get_dequant_math() != "gi" and n <= MLP_MAX_ROWS):
        b_fc, b_proj = (None if b is None else b.to(torch.float32).contiguous()
                        for b in (lp.get("b_fc"), lp.get("b_proj")))
        y = q4_mlp_ps(h.reshape(n, -1).contiguous(), w_fc.packed,
                      w_fc.scales, b_fc, w_proj.packed, w_proj.scales,
                      None if split else b_proj, _FUSED_ACTS[cfg.activation])
        y = y.reshape(*h.shape[:-1], -1)
        if split:
            return _row_parallel_out(y, b_proj, h.dtype, red, par)
        return y.to(h.dtype)
    act = get_activation(cfg.activation)
    y = _linear(h, lp["w_fc"], lp.get("b_fc"), h.dtype, cfg.act_quant)
    y = act(y.to(torch.float32)).to(h.dtype)
    return _out_linear(y, w_proj, lp.get("b_proj"), h.dtype, cfg.act_quant,
                       red, par)


def decoder_layer(cfg: ModelConfig, lp: Params, x: torch.Tensor, k_all,
                  v_all, il: int, positions: torch.Tensor, n_past,
                  n_past_vec, slopes, fresh_kv: bool = False,
                  pending: Optional[list] = None,
                  rows: Optional[tuple] = None,
                  par: Par = NO_PAR) -> torch.Tensor:
    """One block; residual topology per arch (NeoX parallel, GPT-J parallel
    with one shared LN, BLOOM/GPT-2 sequential).  Under ``par.seq`` ``x``
    holds this rank's tokens; the LN outputs are gathered before
    attention and the MLP."""
    def full(a):  # every token, under sequence parallelism
        return a if par.seq is None else _seq_full(a, par)

    h1 = full(layer_norm(x, lp["ln1_w"], lp["ln1_b"], cfg.ln_eps))
    attn_out = attention(cfg, lp, h1, k_all, v_all, il, positions, n_past,
                         n_past_vec, slopes, fresh_kv, pending, rows, par)
    if cfg.parallel_residual:
        h2 = h1 if cfg.shared_layernorm else full(layer_norm(
            x, lp["ln2_w"], lp["ln2_b"], cfg.ln_eps))
        return x + attn_out + mlp(cfg, lp, h2, par)
    x = x + attn_out
    h2 = full(layer_norm(x, lp["ln2_w"], lp["ln2_b"], cfg.ln_eps))
    return x + mlp(cfg, lp, h2, par)


def _lookup(wte, token_ids: torch.Tensor, dtype):
    if isinstance(wte, Q4Tensor):
        return q4_take_rows(wte, token_ids, dtype=dtype)
    return wte[token_ids].to(dtype)


def embed(cfg: ModelConfig, params: Params, token_ids: torch.Tensor, dtype,
          vocab: Optional[pctx.Axis] = None):
    """Token embeddings [.., E].  ``vocab``: the axis a vocab-split
    ``wte`` (fewer rows than the vocabulary) splits over: each rank looks
    up the ids in its rows, zeros elsewhere, and the ranks' rows are
    summed in f32 (exact: one rank holds each id)."""
    wte = params["wte"]
    rows = _out_features(wte)
    if vocab is None or rows >= cfg.n_vocab:
        return _lookup(wte, token_ids, dtype)
    if rows * vocab.size < cfg.n_vocab:
        raise ValueError(f"wte: {rows} rows a rank over {vocab.size} ranks "
                         f"do not cover {cfg.n_vocab} tokens")
    ids = token_ids - vocab.index * rows
    hit = (ids >= 0) & (ids < rows)
    x = _lookup(wte, ids.clamp(0, rows - 1), dtype).to(torch.float32)
    x = torch.where(hit[..., None], x, 0.0).contiguous()
    return pctx.all_reduce(x, vocab).to(dtype)


def embed_inputs(cfg: ModelConfig, params: Params, token_ids: torch.Tensor,
                 positions: torch.Tensor, cdt, par: Par = NO_PAR
                 ) -> torch.Tensor:
    """The residual stream's input: token embeddings, GPT-2's learned
    positions (a sentinel row's position is past the table: clamped) and
    BLOOM's embedding LN."""
    x = embed(cfg, params, token_ids, cdt, par.vocab)
    if cfg.learned_pos:
        wpe = params["wpe"]
        x = x + wpe[positions.clamp(max=wpe.shape[0] - 1)].to(cdt)
    if "emb_ln_w" in params:
        x = layer_norm(x, params["emb_ln_w"], params["emb_ln_b"], cfg.ln_eps)
    return x


def _whole_head(rows: int, cfg: ModelConfig, vocab: pctx.Axis) -> bool:
    """Whether an lm head of ``rows`` rows on this rank is whole: a head
    is held whole only where its rows do not divide the axis, and a split
    one holds fewer rows than the vocabulary (or, padded, a share of a
    multiple of 1024 rows, which the axis divides)."""
    return rows >= cfg.n_vocab and rows % vocab.size != 0


def head_logits(cfg: ModelConfig, params: Params, x: torch.Tensor, cdt,
                par: Par = NO_PAR) -> torch.Tensor:
    """Final LN and lm head: x [B, T(/seq), E] → logits [B, T, n_vocab]
    f32.  Under a mesh the rank's vocab rows' logits are gathered (and,
    under ``par.seq``, every token first); a whole head's are whole."""
    x = layer_norm(x, params["ln_f_w"], params["ln_f_b"], cfg.ln_eps)
    if par.seq is not None:
        x = _seq_full(x, par)
    lm = params["lm_head"]
    logits = q4_matmul(x, lm, bias=params.get("lm_head_b"),
                       compute_dtype=cdt)
    if par.vocab is not None and not _whole_head(_out_features(lm), cfg,
                                                 par.vocab):
        logits = pctx.gather(logits.contiguous(), -1, par.vocab)
    if logits.shape[-1] != cfg.n_vocab:  # lm head padded for the kernels
        logits = logits[..., : cfg.n_vocab]
    return logits.to(torch.float32)


def mesh_axes(token_ids: torch.Tensor, seq_parallel: bool) -> Par:
    """The current mesh's axes for a forward over ``token_ids`` [B, T];
    ``seq_parallel``: this call may split its tokens (a prefill or a
    cache-free forward), which it does under the "seq" rule, at any T
    (``_seq_local`` pads)."""
    if pctx.current_mesh() is None:
        return NO_PAR
    seq = pctx.axis("seq") if seq_parallel else None
    return Par(pctx.axis("heads"), pctx.axis("ffn"), pctx.axis("vocab"),
               seq, token_ids.shape[1])


def local_slopes(cfg: ModelConfig, slopes: Optional[torch.Tensor],
                 lp: Params, par: Par) -> Optional[torch.Tensor]:
    """ALiBi slopes for the heads layer ``lp`` holds: the rank's slice of
    a whole-model vector when a mesh splits the heads."""
    if slopes is None or par.heads is None or slopes.shape[0] != cfg.n_head:
        return slopes
    heads = local_heads(cfg, lp)
    ax = _split_axis(heads, cfg.n_head, par.heads, "attention heads")
    return slopes if ax is None else pctx.local(slopes, 0, ax)


def _stacked_q4(v) -> bool:
    return isinstance(v, Q4Tensor) and v.packed.dim() == 3


def per_layer(layers, n_layer: int) -> List[Params]:
    """Per-layer parameter dicts from a dict of stacked/per-layer entries
    (a list of dicts passes through).  A stacked Q4 weight becomes a
    ``Q4Layer`` whose index is one element of an int32 tensor built once on
    the weights' device, so K10 selects the layer inside the kernel; other
    stacked entries become per-layer views."""
    if isinstance(layers, list):
        return layers
    stacked = [v for v in layers.values() if _stacked_q4(v)]
    ils = (torch.arange(n_layer, dtype=torch.int32, device=stacked[0].device)
           if stacked else None)
    return [{k: Q4Layer(v, ils[il]) if _stacked_q4(v) else layer_of(v, il)
             for k, v in layers.items()} for il in range(n_layer)]


def forward(cfg: ModelConfig, params: Params, token_ids: torch.Tensor,
            cache: Optional[Dict[str, Any]], n_past=0,
            fresh_kv: bool = False, *, write_first: bool = False,
            slopes: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Token ids [B, T] → (logits [B, T, n_vocab] f32, cache).

    ``n_past`` is the cache length before this chunk: an int for every row,
    or an int32 [B] tensor on the tokens' device (ragged).  The cache is
    updated in place and returned.  ``fresh_kv`` (a prefill from an empty
    cache, n_past = 0) attends over the chunk's own full-precision k/v.
    ``write_first`` sends a ragged T=1 step over a quantized cache through
    the uniform route's write-then-K3 instead of the deferred K5/K6 one.
    ``slopes``: ALiBi slopes built once (``alibi_slopes``); built here from
    the config when None."""
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
    par = mesh_axes(token_ids, cache is None or fresh_kv)
    x = embed_inputs(cfg, params, token_ids, positions, cdt, par)
    if par.seq is not None:  # this rank's tokens through the residual
        x = _seq_local(x, par)
    layers = per_layer(params["layers"], cfg.n_layer)
    if not cfg.alibi:
        slopes = None
    else:
        if slopes is None:
            slopes = alibi_slopes(cfg.n_head, dev)
        slopes = local_slopes(cfg, slopes, layers[0], par)
    k_all = cache["k"] if cache is not None else None
    v_all = cache["v"] if cache is not None else None
    if ragged:
        n_past_vec = n_past
    else:
        n_past_vec = (torch.full((B,), n_past, dtype=torch.int32, device=dev)
                      if k_all is not None and T == 1 else None)
    deferred = ragged and T == 1 and isinstance(k_all, tuple) \
        and not write_first
    pending: Optional[list] = [] if deferred else None
    rows = None  # a one-token ragged write's targets, made once a step
    if ragged and T == 1 and isinstance(k_all, torch.Tensor):
        rows = _row_slots(n_past, k_all.shape[3])
    for il, lp in enumerate(layers):
        x = decoder_layer(cfg, lp, x, k_all, v_all, il, positions, n_past,
                          n_past_vec, slopes, fresh_kv, pending, rows, par)
    if deferred:  # every layer's rows at once, after the last K5 read
        rows = tuple(torch.stack(r) for r in zip(*pending))
        scatter_rows(k_all, v_all, rows, n_past)
    return head_logits(cfg, params, x, cdt, par), cache


def forward_nocache(cfg: ModelConfig, params: Params,
                    token_ids: torch.Tensor) -> torch.Tensor:
    """Cache-free forward (training, perplexity): logits [B, T, n_vocab]."""
    logits, _ = forward(cfg, params, token_ids, None, 0)
    return logits


def init_cache(cfg: ModelConfig, batch: int, n_ctx: Optional[int] = None,
               dtype=None, device: DeviceLike = None,
               heads: Optional[int] = None) -> Dict[str, Any]:
    """Preallocated head-major KV cache [L, B, H, S, D].  ``dtype`` (or
    cfg.kv_dtype) "int8" stores (int8 values, bf16 scales [L, B, H, S]) per
    side; "int4" plane-packs two dims per byte (uint8 [.., D/2]).
    ``heads``: H when a rank holds a share of the model's heads."""
    dev = resolve_device(device)
    S = n_ctx or cfg.n_ctx  # noqa: N806
    name = str(dtype or cfg.kv_dtype).replace("torch.", "")
    shape = (cfg.n_layer, batch, heads or cfg.n_head, S, cfg.head_dim)

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
