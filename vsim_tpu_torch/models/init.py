"""Parameter initialization and load-time repacks (port of
vsim_tpu/models/init.py).

``init_params`` and ``random_q4_params`` draw from
``np.random.default_rng(seed)`` in the JAX package's order, so one seed
gives byte-identical weights in both packages.  Parameters are a plain dict:

  params = {"wte": Q4Tensor | [V, E], "layers": {name: stacked [L, ...]
            tensor or Q4Tensor} or a per-layer list of dicts (an engine's:
            a stacked Q4 weight as one Q4Layer per layer), "ln_f_w", "ln_f_b",
            "lm_head": Q4Tensor | [V, E], "lm_head_b" (gptj), "wpe" (gpt2),
            "emb_ln_w"/"emb_ln_b" (bloom)}
"""

from __future__ import annotations

from typing import Any, Dict, Iterator

import numpy as np
import torch

from vsim_tpu_torch.device import DeviceLike, resolve_device
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.ops.matmul import Q4Layer
from vsim_tpu_torch.quant.q4 import (
    DEFAULT_SCALE_DTYPE,
    QK,
    Q4Tensor,
    _cast_scales_np,
    quantize_q4_0_np,
    tensor_from_np,
    to_plane_split,
)

_WEIGHT_SHAPES = {
    "wq": ("E", "E"), "wk": ("E", "E"), "wv": ("E", "E"), "wo": ("E", "E"),
    "w_fc": ("F", "E"), "w_proj": ("E", "F"),
}
_VEC_SHAPES = {
    "ln1_w": ("E",), "ln1_b": ("E",), "ln2_w": ("E",), "ln2_b": ("E",),
    "bq": ("E",), "bk": ("E",), "bv": ("E",), "bo": ("E",),
    "b_fc": ("F",), "b_proj": ("E",),
}


def _dims(cfg: ModelConfig) -> Dict[str, int]:
    return {"E": cfg.n_embd, "F": cfg.n_ff, "V": cfg.n_vocab}


def _device_generator(rng: str, seed: int, dev: torch.device):
    """None for ``rng="numpy"``; for ``"device"`` a torch generator on
    ``dev`` seeded with ``seed``."""
    if rng == "numpy":
        return None
    if rng != "device":
        raise ValueError(f"rng must be 'numpy' or 'device', not {rng!r}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def _stack(parts):
    if isinstance(parts[0], torch.Tensor):
        return torch.stack(parts)
    return np.stack(parts)


def init_params(cfg: ModelConfig, seed: int = 0, *, quantize: bool = False,
                device: DeviceLike = None, rng: str = "numpy"
                ) -> Dict[str, Any]:
    """Gaussian-init (std 0.02) f32 parameters, layer-stacked, optionally
    Q4_0-quantized with bf16 scales.  ``rng="device"`` draws the same tree
    with torch's generator on the device, not numpy's on the host: seconds
    less at full size, but not the JAX package's values, and not
    quantized."""
    dev = resolve_device(device)
    pdt, std = torch.float32, 0.02
    gen = _device_generator(rng, seed, dev)
    if gen is not None and quantize:
        raise ValueError("rng='device' draws dense weights only")
    np_rng = np.random.default_rng(seed)
    dims = _dims(cfg)

    def normal(shape):
        if gen is not None:
            return torch.randn(shape, generator=gen, device=dev) * std
        return (np_rng.standard_normal(shape) * std).astype(np.float32)

    def w(shape_names):
        return normal(tuple(dims[s] for s in shape_names))

    def wrap2d(mat):
        if quantize and mat.shape[-1] % QK == 0:
            p, s = quantize_q4_0_np(mat)
            return np.ascontiguousarray(p.T), np.ascontiguousarray(s.T)
        return mat, None

    def dense(a):
        if isinstance(a, torch.Tensor):
            return a.to(dev, pdt)
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, pdt)

    layer_packed = {k: [] for k in _WEIGHT_SHAPES}
    layer_scales = {k: [] for k in _WEIGHT_SHAPES}
    layer_vecs = {k: [] for k in _VEC_SHAPES}
    for _ in range(cfg.n_layer):
        for k, sh in _WEIGHT_SHAPES.items():
            p, s = wrap2d(w(sh))
            layer_packed[k].append(p)
            layer_scales[k].append(s)
        for k, sh in _VEC_SHAPES.items():
            if k.startswith("ln"):
                base = np.ones if k.endswith("_w") else np.zeros
                layer_vecs[k].append(
                    base(tuple(dims[s] for s in sh), dtype=np.float32))
            else:
                layer_vecs[k].append(w(sh))

    layers: Dict[str, Any] = {}
    for k in _WEIGHT_SHAPES:
        stacked = _stack(layer_packed[k])
        if layer_scales[k][0] is not None:
            layers[k] = Q4Tensor(
                packed=tensor_from_np(stacked, dev),
                scales=tensor_from_np(np.stack(layer_scales[k]), dev))
        else:
            layers[k] = dense(stacked)
    for k in _VEC_SHAPES:
        layers[k] = dense(_stack(layer_vecs[k]))

    def big(shape):
        p, s = wrap2d(normal(shape))
        if s is not None:
            return Q4Tensor(packed=tensor_from_np(p, dev),
                            scales=tensor_from_np(s, dev))
        return dense(p)

    E = cfg.n_embd  # noqa: N806
    params: Dict[str, Any] = {
        "wte": big((cfg.n_vocab, E)),
        "layers": layers,
        "ln_f_w": torch.ones(E, dtype=pdt, device=dev),
        "ln_f_b": torch.zeros(E, dtype=pdt, device=dev),
        "lm_head": big((cfg.n_vocab, E)),
    }
    if cfg.learned_pos:
        params["wpe"] = dense(normal((cfg.n_ctx, E)))
    if cfg.arch == "bloom":
        params["emb_ln_w"] = torch.ones(E, dtype=pdt, device=dev)
        params["emb_ln_b"] = torch.zeros(E, dtype=pdt, device=dev)
    if cfg.final_logit_bias:
        params["lm_head_b"] = torch.zeros(cfg.n_vocab, dtype=pdt, device=dev)
    return params


def random_q4_params(cfg: ModelConfig, seed: int = 0,
                     device: DeviceLike = None, *, rng: str = "numpy"
                     ) -> Dict[str, Any]:
    """Benchmark-grade Q4 params: random packed bytes and bf16 scales
    drawn directly (no float weights, no quantization pass), byte-identical
    to the JAX package's (stacked) ones for one seed.  ``rng="device"``
    draws the same tree with torch's generator on the device: seconds less
    at full size, but not the JAX package's bytes."""
    dev = resolve_device(device)
    gen = _device_generator(rng, seed, dev)
    np_rng = np.random.default_rng(seed)
    dims = _dims(cfg)
    L = cfg.n_layer  # noqa: N806

    def q4_draw(shape_packed, shape_scales):
        if gen is not None:
            packed = torch.randint(0, 256, shape_packed, generator=gen,
                                   device=dev, dtype=torch.uint8)
            scales = torch.rand(shape_scales, generator=gen, device=dev)
            return Q4Tensor(packed=packed,
                            scales=(scales * 0.01).to(DEFAULT_SCALE_DTYPE))
        packed = np_rng.integers(0, 256, size=shape_packed, dtype=np.uint8)
        scales = np_rng.random(shape_scales, dtype=np.float32) * 0.01
        return Q4Tensor(packed=tensor_from_np(packed, dev),
                        scales=tensor_from_np(
                            _cast_scales_np(scales, DEFAULT_SCALE_DTYPE), dev))

    def q4(shape_names, stacked=True):
        O, K = (dims[s] for s in shape_names)  # noqa: N806
        if not stacked:
            return q4_draw((K // 2, O), (K // QK, O))
        return q4_draw((L, K // 2, O), (L, K // QK, O))

    layers: Dict[str, Any] = {k: q4(sh) for k, sh in _WEIGHT_SHAPES.items()}
    for k, sh in _VEC_SHAPES.items():
        shape = (L, *(dims[s] for s in sh))
        fill = torch.ones if k.startswith("ln") and k.endswith("_w") \
            else torch.zeros
        layers[k] = fill(shape, dtype=torch.float32, device=dev)
    E = cfg.n_embd  # noqa: N806
    params: Dict[str, Any] = {
        "wte": q4(("V", "E"), stacked=False),
        "layers": layers,
        "ln_f_w": torch.ones(E, device=dev),
        "ln_f_b": torch.zeros(E, device=dev),
        "lm_head": q4(("V", "E"), stacked=False),
    }
    if cfg.learned_pos:
        params["wpe"] = torch.zeros((cfg.n_ctx, E), device=dev)
    if cfg.arch == "bloom":
        params["emb_ln_w"] = torch.ones(E, device=dev)
        params["emb_ln_b"] = torch.zeros(E, device=dev)
    if cfg.final_logit_bias:
        params["lm_head_b"] = torch.zeros(cfg.n_vocab, device=dev)
    return params


def layer_of(v, il: int):
    """Layer ``il`` of a per-layer list, a stacked tensor or a stacked
    Q4Tensor (a view: stacked weights are never copied per layer)."""
    if isinstance(v, Q4Tensor) and v.packed.dim() == 3:
        return v.layer(il)
    return v[il]


def prepare_unrolled_params(params: Dict[str, Any], *,
                            plane_split: bool = True) -> Dict[str, Any]:
    """Engine-load transform: each stacked Q4 weight becomes a per-layer
    list, with ``plane_split`` plane-split when K % 64 == 0 (the port's
    kernels need whole 32-row groups in each plane, nothing more); the lm
    head too.  Small stacked tensors (LN weights, biases) stay stacked.
    Returns a new dict; the caller's is not modified."""
    def convert(t: Q4Tensor) -> Q4Tensor:
        if plane_split and t.in_features % (2 * QK) == 0:
            return to_plane_split(t)
        return t

    layers = {}
    for k, v in params["layers"].items():
        if isinstance(v, Q4Tensor) and v.packed.dim() == 3:
            v = [v.layer(i) for i in range(v.packed.shape[0])]
        if isinstance(v, (list, tuple)) and v and isinstance(v[0], Q4Tensor):
            v = [convert(t) for t in v]
        layers[k] = v
    out = dict(params, layers=layers)
    if isinstance(out.get("lm_head"), Q4Tensor):
        out["lm_head"] = convert(out["lm_head"])
    return out


def fuse_qkv_params(cfg: ModelConfig, params: Dict[str, Any]
                    ) -> Dict[str, Any]:
    """Fuse wq/wk/wv (+bq/bk/bv) into one head-interleaved ``w_qkv``
    (+``b_qkv``): output columns per head h are [q_h | k_h | v_h], so one
    reshape [.., H, 3, D] recovers q/k/v.  Returns a new dict."""
    layers = dict(params["layers"])
    if "w_qkv" in layers or "wq" not in layers:
        return params
    H, D = cfg.n_head, cfg.head_dim  # noqa: N806
    wq, wk, wv = (layers.pop(k) for k in ("wq", "wk", "wv"))

    def mix_last(a, b, c):
        lead = a.shape[:-1]
        stk = torch.stack([x.reshape(*lead, H, D) for x in (a, b, c)], dim=-2)
        return stk.reshape(*lead, 3 * H * D)

    def mix_q4(q, k, v):
        return Q4Tensor(packed=mix_last(q.packed, k.packed, v.packed),
                        scales=mix_last(q.scales, k.scales, v.scales),
                        layout=q.layout)

    if isinstance(wq, (list, tuple)):
        layers["w_qkv"] = [mix_q4(*t) for t in zip(wq, wk, wv)]
    elif isinstance(wq, Q4Tensor):
        layers["w_qkv"] = mix_q4(wq, wk, wv)
    else:  # dense stacked [L, O, K]: interleave the output axis
        stk = torch.stack([x.reshape(x.shape[0], H, D, x.shape[-1])
                           for x in (wq, wk, wv)], dim=2)
        layers["w_qkv"] = stk.reshape(wq.shape[0], 3 * H * D, wq.shape[-1])
    if all(k in layers for k in ("bq", "bk", "bv")):
        layers["b_qkv"] = mix_last(*(layers.pop(k) for k in ("bq", "bk", "bv")))
    return dict(params, layers=layers)


def iter_tensors(tree, _seen=None) -> Iterator[torch.Tensor]:
    """Every tensor of a params tree (Q4 weights as packed + scales; a
    stacked weight that several Q4Layers share, once)."""
    seen = set() if _seen is None else _seen
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, Q4Layer):
        if id(tree.stacked) not in seen:
            seen.add(id(tree.stacked))
            yield from iter_tensors(tree.stacked, seen)
    elif isinstance(tree, Q4Tensor):
        yield tree.packed
        yield tree.scales
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from iter_tensors(v, seen)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from iter_tensors(v, seen)


def param_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in iter_tensors(params))


def params_to(params, device: DeviceLike, _moved=None):
    """Copy of a params tree on ``device`` (tensors already there are
    shared, not copied; a Q4 weight that several leaves share, as a tied
    lm head or the stacked weight of several Q4Layers, is moved once)."""
    moved = {} if _moved is None else _moved
    if isinstance(params, torch.Tensor):
        return params.to(device)
    if isinstance(params, Q4Layer):
        key = id(params.stacked)
        if key not in moved:
            moved[key] = params.stacked.to(device)
        return Q4Layer(moved[key], params.il.to(device))
    if isinstance(params, Q4Tensor):
        if id(params) not in moved:
            moved[id(params)] = params.to(device)
        return moved[id(params)]
    if isinstance(params, dict):
        return {k: params_to(v, device, moved) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to(v, device, moved) for v in params]
    raise TypeError(f"unexpected params leaf {type(params).__name__}")
