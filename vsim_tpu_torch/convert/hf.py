"""HuggingFace model → the port's params tree (port of
vsim_tpu/convert/hf.py): one pass from an HF state dict to layer-stacked,
optionally Q4_0-quantized tensors, in place of the reference's two-stage
converters/convert_*_to_ggml.py → quantize_*.cpp pipeline.

Per-arch remaps, as the reference converters make them:
  * GPT-NeoX: the fused query_key_value splits head-wise into q/k/v (the
    [H, 3, D, E] reshape; convert_gptneox_to_ggml.py:109-183 probes the
    nn.Linear for the same split);
  * GPT-J / CodeGen: CodeGen's qkv_proj splits into GPT-J's q/k/v
    (``split_codegen_qkv``, convert_gptj_to_ggml.py:121-211);
  * BLOOM: the fused query_key_value splits head-wise, as NeoX's;
  * GPT-2: the Conv1D weights, stored [in, out], are transposed.

Quantization follows quantize_*.cpp:171-263: every 2-D ``.*weight`` whose
contraction dim is a multiple of QK goes Q4_0; biases and layer norms stay
f32.  It takes a transformers model object or a state dict; transformers
itself is never imported here.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from vsim_tpu_torch.device import DeviceLike, resolve_device, torch_dtype
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.quant.q4 import DEFAULT_SCALE_DTYPE, QK, Q4Tensor


def _np(t) -> np.ndarray:
    """torch tensor / np array → float32 numpy."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


class Converter:
    def __init__(self, cfg: ModelConfig, quantize: bool = True,
                 scale_dtype=DEFAULT_SCALE_DTYPE, param_dtype=torch.float32,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.quantize = quantize
        self.scale_dtype = scale_dtype
        self.param_dtype = torch_dtype(param_dtype)
        self.device = resolve_device(device)

    def weight(self, mat: np.ndarray):
        """2-D (or stacked 3-D) matmul weight → Q4Tensor or dense tensor."""
        if self.quantize and mat.shape[-1] % QK == 0:
            return Q4Tensor.from_dense_np(mat, scale_dtype=self.scale_dtype,
                                          device=self.device)
        return self.vec(mat)

    def vec(self, v: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(v, np.float32)).to(
            self.device, self.param_dtype)


def split_qkv_headwise(w: np.ndarray, n_head: int, head_dim: int):
    """Split fused [(H*3*D), E] (per-head [q;k;v] interleave: the NeoX and
    BLOOM layout) into three [H*D, E] matrices."""
    E = w.shape[-1]  # noqa: N806
    w = w.reshape(n_head, 3, head_dim, E)
    return (w[:, 0].reshape(-1, E), w[:, 1].reshape(-1, E),
            w[:, 2].reshape(-1, E))


def split_qkv_headwise_bias(b: np.ndarray, n_head: int, head_dim: int):
    b = b.reshape(n_head, 3, head_dim)
    return (b[:, 0].ravel(), b[:, 1].ravel(), b[:, 2].ravel())


def _stack_layers(layers: List[Dict[str, Any]], cv: Converter
                  ) -> Dict[str, Any]:
    """Stack per-layer numpy dicts along axis 0 and wrap them (the 2-D
    weights quantized as stacked [L, O, K] in one go)."""
    out: Dict[str, Any] = {}
    for key in layers[0]:
        mats = np.stack([lp[key] for lp in layers], axis=0)
        out[key] = cv.weight(mats) if mats.ndim == 3 and key.startswith("w") \
            else cv.vec(mats)
    return out


# ---------------------------------------------------------------------------
# per-arch state-dict walkers
# ---------------------------------------------------------------------------


def _convert_gptneox(sd, cfg: ModelConfig, cv: Converter) -> Dict[str, Any]:
    H, D = cfg.n_head, cfg.head_dim  # noqa: N806
    params: Dict[str, Any] = {
        "wte": cv.weight(_np(sd["gpt_neox.embed_in.weight"])),
        "ln_f_w": cv.vec(_np(sd["gpt_neox.final_layer_norm.weight"])),
        "ln_f_b": cv.vec(_np(sd["gpt_neox.final_layer_norm.bias"])),
        "lm_head": cv.weight(_np(sd["embed_out.weight"])),
    }
    layers = []
    for i in range(cfg.n_layer):
        p = f"gpt_neox.layers.{i}."
        wq, wk, wv = split_qkv_headwise(
            _np(sd[p + "attention.query_key_value.weight"]), H, D)
        bq, bk, bv = split_qkv_headwise_bias(
            _np(sd[p + "attention.query_key_value.bias"]), H, D)
        layers.append({
            "ln1_w": _np(sd[p + "input_layernorm.weight"]),
            "ln1_b": _np(sd[p + "input_layernorm.bias"]),
            "ln2_w": _np(sd[p + "post_attention_layernorm.weight"]),
            "ln2_b": _np(sd[p + "post_attention_layernorm.bias"]),
            "wq": wq, "bq": bq, "wk": wk, "bk": bk, "wv": wv, "bv": bv,
            "wo": _np(sd[p + "attention.dense.weight"]),
            "bo": _np(sd[p + "attention.dense.bias"]),
            "w_fc": _np(sd[p + "mlp.dense_h_to_4h.weight"]),
            "b_fc": _np(sd[p + "mlp.dense_h_to_4h.bias"]),
            "w_proj": _np(sd[p + "mlp.dense_4h_to_h.weight"]),
            "b_proj": _np(sd[p + "mlp.dense_4h_to_h.bias"]),
        })
    params["layers"] = _stack_layers(layers, cv)
    return params


def split_codegen_qkv(w: np.ndarray, n_embd: int):
    """CodeGen fused qkv_proj [3E, E] → GPT-J (wq, wk, wv), each [E, E].

    CodeGen blocks the out dim as [mp_num=4, 3E/4] with section order
    q, v, k inside each block (modeling_codegen.py's torch.split order),
    the reshape and split of convert_gptj_to_ggml.py:140-211."""
    if w.shape != (3 * n_embd, n_embd):
        raise ValueError(f"CodeGen qkv_proj is {w.shape}, want "
                         f"{(3 * n_embd, n_embd)}")
    blocks = w.reshape(4, 3 * (n_embd // 4), n_embd)
    sec = n_embd // 4
    q = blocks[:, 0 * sec: 1 * sec, :].reshape(n_embd, n_embd)
    v = blocks[:, 1 * sec: 2 * sec, :].reshape(n_embd, n_embd)
    k = blocks[:, 2 * sec: 3 * sec, :].reshape(n_embd, n_embd)
    return q, k, v


def _convert_gptj(sd, cfg: ModelConfig, cv: Converter) -> Dict[str, Any]:
    params: Dict[str, Any] = {
        "wte": cv.weight(_np(sd["transformer.wte.weight"])),
        "ln_f_w": cv.vec(_np(sd["transformer.ln_f.weight"])),
        "ln_f_b": cv.vec(_np(sd["transformer.ln_f.bias"])),
        "lm_head": cv.weight(_np(sd["lm_head.weight"])),
        "lm_head_b": cv.vec(_np(sd["lm_head.bias"])),
    }
    E = cfg.n_embd  # noqa: N806
    zeros_e = np.zeros((E,), np.float32)
    layers = []
    for i in range(cfg.n_layer):
        p = f"transformer.h.{i}."
        if p + "attn.qkv_proj.weight" in sd:  # a CodeGen checkpoint
            wq, wk, wv = split_codegen_qkv(
                _np(sd[p + "attn.qkv_proj.weight"]), E)
        else:
            wq = _np(sd[p + "attn.q_proj.weight"])
            wk = _np(sd[p + "attn.k_proj.weight"])
            wv = _np(sd[p + "attn.v_proj.weight"])
        layers.append({
            "ln1_w": _np(sd[p + "ln_1.weight"]),
            "ln1_b": _np(sd[p + "ln_1.bias"]),
            # GPT-J has one LN; the ln2 slots are filled, never read
            "ln2_w": np.ones((E,), np.float32),
            "ln2_b": zeros_e,
            "wq": wq, "bq": zeros_e,
            "wk": wk, "bk": zeros_e,
            "wv": wv, "bv": zeros_e,
            "wo": _np(sd[p + "attn.out_proj.weight"]), "bo": zeros_e,
            "w_fc": _np(sd[p + "mlp.fc_in.weight"]),
            "b_fc": _np(sd[p + "mlp.fc_in.bias"]),
            "w_proj": _np(sd[p + "mlp.fc_out.weight"]),
            "b_proj": _np(sd[p + "mlp.fc_out.bias"]),
        })
    params["layers"] = _stack_layers(layers, cv)
    return params


def _convert_bloom(sd, cfg: ModelConfig, cv: Converter) -> Dict[str, Any]:
    H, D = cfg.n_head, cfg.head_dim  # noqa: N806
    wte = _np(sd["transformer.word_embeddings.weight"])
    params: Dict[str, Any] = {
        "wte": cv.weight(wte),
        "emb_ln_w": cv.vec(
            _np(sd["transformer.word_embeddings_layernorm.weight"])),
        "emb_ln_b": cv.vec(
            _np(sd["transformer.word_embeddings_layernorm.bias"])),
        "ln_f_w": cv.vec(_np(sd["transformer.ln_f.weight"])),
        "ln_f_b": cv.vec(_np(sd["transformer.ln_f.bias"])),
        "lm_head": cv.weight(wte),  # tied
    }
    layers = []
    for i in range(cfg.n_layer):
        p = f"transformer.h.{i}."
        wq, wk, wv = split_qkv_headwise(
            _np(sd[p + "self_attention.query_key_value.weight"]), H, D)
        bq, bk, bv = split_qkv_headwise_bias(
            _np(sd[p + "self_attention.query_key_value.bias"]), H, D)
        layers.append({
            "ln1_w": _np(sd[p + "input_layernorm.weight"]),
            "ln1_b": _np(sd[p + "input_layernorm.bias"]),
            "ln2_w": _np(sd[p + "post_attention_layernorm.weight"]),
            "ln2_b": _np(sd[p + "post_attention_layernorm.bias"]),
            "wq": wq, "bq": bq, "wk": wk, "bk": bk, "wv": wv, "bv": bv,
            "wo": _np(sd[p + "self_attention.dense.weight"]),
            "bo": _np(sd[p + "self_attention.dense.bias"]),
            "w_fc": _np(sd[p + "mlp.dense_h_to_4h.weight"]),
            "b_fc": _np(sd[p + "mlp.dense_h_to_4h.bias"]),
            "w_proj": _np(sd[p + "mlp.dense_4h_to_h.weight"]),
            "b_proj": _np(sd[p + "mlp.dense_4h_to_h.bias"]),
        })
    params["layers"] = _stack_layers(layers, cv)
    return params


def gpt2_getter(sd):
    """A reader of GPT-2 state-dict entries by bare name: the LM head
    model's keys carry a "transformer." prefix, the base model's none."""
    def g(name):
        return _np(sd[name if name in sd else "transformer." + name])
    return g


def _convert_gpt2(sd, cfg: ModelConfig, cv: Converter) -> Dict[str, Any]:
    E = cfg.n_embd  # noqa: N806
    g = gpt2_getter(sd)
    wte = g("wte.weight")
    params: Dict[str, Any] = {
        "wte": cv.weight(wte),
        "wpe": cv.vec(g("wpe.weight")),
        "ln_f_w": cv.vec(g("ln_f.weight")),
        "ln_f_b": cv.vec(g("ln_f.bias")),
        "lm_head": cv.weight(wte),  # tied
    }
    layers = []
    for i in range(cfg.n_layer):
        p = f"h.{i}."
        # Conv1D stores [in, out]: transposed to [out, in]
        w_attn = g(p + "attn.c_attn.weight").T  # [3E, E]
        b_attn = g(p + "attn.c_attn.bias")  # [3E]
        layers.append({
            "ln1_w": g(p + "ln_1.weight"), "ln1_b": g(p + "ln_1.bias"),
            "ln2_w": g(p + "ln_2.weight"), "ln2_b": g(p + "ln_2.bias"),
            "wq": w_attn[:E], "bq": b_attn[:E],
            "wk": w_attn[E:2 * E], "bk": b_attn[E:2 * E],
            "wv": w_attn[2 * E:], "bv": b_attn[2 * E:],
            "wo": g(p + "attn.c_proj.weight").T,
            "bo": g(p + "attn.c_proj.bias"),
            "w_fc": g(p + "mlp.c_fc.weight").T, "b_fc": g(p + "mlp.c_fc.bias"),
            "w_proj": g(p + "mlp.c_proj.weight").T,
            "b_proj": g(p + "mlp.c_proj.bias"),
        })
    params["layers"] = _stack_layers(layers, cv)
    return params


_ARCH_CONVERTERS = {
    "gptneox": _convert_gptneox,
    "gptj": _convert_gptj,
    "bloom": _convert_bloom,
    "gpt2": _convert_gpt2,
}


def convert_state_dict(cfg: ModelConfig, state_dict: Dict[str, Any], *,
                       quantize: bool = True, scale_dtype=DEFAULT_SCALE_DTYPE,
                       param_dtype=torch.float32,
                       device: DeviceLike = None) -> Dict[str, Any]:
    """HF state dict (torch tensors or numpy) → the port's params tree on
    ``device`` (the card unless another is named)."""
    if cfg.arch not in _ARCH_CONVERTERS:
        raise ValueError(f"unsupported arch {cfg.arch!r}")
    cv = Converter(cfg, quantize=quantize, scale_dtype=scale_dtype,
                   param_dtype=param_dtype, device=device)
    return _ARCH_CONVERTERS[cfg.arch](state_dict, cfg, cv)


def convert_hf_model(model, *, quantize: bool = True, n_ctx=None,
                     scale_dtype=DEFAULT_SCALE_DTYPE,
                     param_dtype=torch.float32, device: DeviceLike = None):
    """A transformers PreTrainedModel → (cfg, params)."""
    cfg = ModelConfig.from_hf(model.config, n_ctx=n_ctx)
    params = convert_state_dict(
        cfg, dict(model.state_dict()), quantize=quantize,
        scale_dtype=scale_dtype, param_dtype=param_dtype, device=device)
    return cfg, params
