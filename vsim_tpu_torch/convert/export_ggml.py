"""An HF model → a reference ggml Q4_0 file (port of
vsim_tpu/convert/export_ggml.py), in place of the reference's
convert_*_to_ggml.py + quantize_*.cpp chain: magic, hparams, vocab and
tensor records in the reference's names, 20-byte Q4_0 blocks.  The reference
binary loads what it writes.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from vsim_tpu_torch.convert.ggml_file import (
    FTYPE_F32,
    FTYPE_Q4_0,
    GGML_NAME_MAPS,
    GGMLTensor,
    write_ggml,
)
from vsim_tpu_torch.convert.hf import (
    _np,
    gpt2_getter,
    split_codegen_qkv,
    split_qkv_headwise,
    split_qkv_headwise_bias,
)
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.quant.q4 import QK, quantize_q4_0_np, to_ggml_q4_0_bytes


def _tensor(name: str, data: np.ndarray, quantize: bool) -> GGMLTensor:
    data = np.asarray(data, np.float32)
    if quantize and data.ndim == 2 and data.shape[-1] % QK == 0:
        packed, scales = quantize_q4_0_np(data, scale_dtype=torch.float32)
        return GGMLTensor(name, data.shape, FTYPE_Q4_0,
                          to_ggml_q4_0_bytes(packed, scales))
    return GGMLTensor(name, data.shape, FTYPE_F32,
                      np.ascontiguousarray(data).view(np.uint8).reshape(-1))


def _gather_tensors(arch: str, cfg: ModelConfig, sd: Dict, quantize: bool
                    ) -> List[GGMLTensor]:
    """The arch's tensor list, in the reference's names and order."""
    names = GGML_NAME_MAPS[arch]
    H, D, E = cfg.n_head, cfg.head_dim, cfg.n_embd  # noqa: N806
    out: List[GGMLTensor] = []

    def add(slot: str, data, i: Optional[int] = None, q: bool = quantize):
        out.append(_tensor(names[slot].format(i=i), np.asarray(data), q))

    if arch == "gptneox":
        add("wte", _np(sd["gpt_neox.embed_in.weight"]))
        for i in range(cfg.n_layer):
            p = f"gpt_neox.layers.{i}."
            wq, wk, wv = split_qkv_headwise(
                _np(sd[p + "attention.query_key_value.weight"]), H, D)
            bq, bk, bv = split_qkv_headwise_bias(
                _np(sd[p + "attention.query_key_value.bias"]), H, D)
            add("ln1_w", _np(sd[p + "input_layernorm.weight"]), i)
            add("ln1_b", _np(sd[p + "input_layernorm.bias"]), i)
            add("ln2_w", _np(sd[p + "post_attention_layernorm.weight"]), i)
            add("ln2_b", _np(sd[p + "post_attention_layernorm.bias"]), i)
            for slot, data in (("wq", wq), ("bq", bq), ("wk", wk), ("bk", bk),
                               ("wv", wv), ("bv", bv)):
                add(slot, data, i)
            for slot, hf in (("wo", "attention.dense.weight"),
                             ("bo", "attention.dense.bias"),
                             ("w_fc", "mlp.dense_h_to_4h.weight"),
                             ("b_fc", "mlp.dense_h_to_4h.bias"),
                             ("w_proj", "mlp.dense_4h_to_h.weight"),
                             ("b_proj", "mlp.dense_4h_to_h.bias")):
                add(slot, _np(sd[p + hf]), i)
        add("ln_f_w", _np(sd["gpt_neox.final_layer_norm.weight"]))
        add("ln_f_b", _np(sd["gpt_neox.final_layer_norm.bias"]))
        add("lm_head", _np(sd["embed_out.weight"]))
        return out

    if arch == "gptj":
        add("wte", _np(sd["transformer.wte.weight"]))
        for i in range(cfg.n_layer):
            p = f"transformer.h.{i}."
            add("ln1_w", _np(sd[p + "ln_1.weight"]), i)
            add("ln1_b", _np(sd[p + "ln_1.bias"]), i)
            if p + "attn.qkv_proj.weight" in sd:  # CodeGen: split fused qkv
                wq, wk, wv = split_codegen_qkv(
                    _np(sd[p + "attn.qkv_proj.weight"]), E)
                add("wq", wq, i)
                add("wk", wk, i)
                add("wv", wv, i)
            else:
                for slot, hf in (("wq", "attn.q_proj.weight"),
                                 ("wk", "attn.k_proj.weight"),
                                 ("wv", "attn.v_proj.weight")):
                    add(slot, _np(sd[p + hf]), i)
            for slot, hf in (("wo", "attn.out_proj.weight"),
                             ("w_fc", "mlp.fc_in.weight"),
                             ("w_proj", "mlp.fc_out.weight")):
                add(slot, _np(sd[p + hf]), i)
            add("b_fc", _np(sd[p + "mlp.fc_in.bias"]), i)
            add("b_proj", _np(sd[p + "mlp.fc_out.bias"]), i)
        add("ln_f_w", _np(sd["transformer.ln_f.weight"]))
        add("ln_f_b", _np(sd["transformer.ln_f.bias"]))
        add("lm_head", _np(sd["lm_head.weight"]))
        add("lm_head_b", _np(sd["lm_head.bias"]))
        return out

    if arch == "bloom":
        add("wte", _np(sd["transformer.word_embeddings.weight"]))
        add("emb_ln_w", _np(sd["transformer.word_embeddings_layernorm.weight"]))
        add("emb_ln_b", _np(sd["transformer.word_embeddings_layernorm.bias"]))
        for i in range(cfg.n_layer):
            p = f"transformer.h.{i}."
            # the per-head interleaved fused qkv regrouped as
            # [all-q; all-k; all-v] (convert_bloom_to_ggml.py:125-127)
            wq, wk, wv = split_qkv_headwise(
                _np(sd[p + "self_attention.query_key_value.weight"]), H, D)
            bq, bk, bv = split_qkv_headwise_bias(
                _np(sd[p + "self_attention.query_key_value.bias"]), H, D)
            add("ln1_w", _np(sd[p + "input_layernorm.weight"]), i)
            add("ln1_b", _np(sd[p + "input_layernorm.bias"]), i)
            add("ln2_w", _np(sd[p + "post_attention_layernorm.weight"]), i)
            add("ln2_b", _np(sd[p + "post_attention_layernorm.bias"]), i)
            add("w_qkv", np.concatenate([wq, wk, wv], axis=0), i)
            add("b_qkv", np.concatenate([bq, bk, bv]), i)
            for slot, hf in (("wo", "self_attention.dense.weight"),
                             ("bo", "self_attention.dense.bias"),
                             ("w_fc", "mlp.dense_h_to_4h.weight"),
                             ("b_fc", "mlp.dense_h_to_4h.bias"),
                             ("w_proj", "mlp.dense_4h_to_h.weight"),
                             ("b_proj", "mlp.dense_4h_to_h.bias")):
                add(slot, _np(sd[p + hf]), i)
        add("ln_f_w", _np(sd["transformer.ln_f.weight"]))
        add("ln_f_b", _np(sd["transformer.ln_f.bias"]))
        return out

    if arch == "gpt2":
        g = gpt2_getter(sd)
        add("wte", g("wte.weight"))
        add("wpe", g("wpe.weight"))  # 2-D ".*weight": quantized, as the ref
        for i in range(cfg.n_layer):
            p = f"h.{i}."
            # reference gpt2 files keep HF's Conv1D orientation [in, out]
            add("w_attn", g(p + "attn.c_attn.weight"), i)
            add("b_attn", g(p + "attn.c_attn.bias"), i)
            for slot, hf in (("ln1_w", "ln_1.weight"), ("ln1_b", "ln_1.bias"),
                             ("ln2_w", "ln_2.weight"), ("ln2_b", "ln_2.bias"),
                             ("wo", "attn.c_proj.weight"),
                             ("bo", "attn.c_proj.bias"),
                             ("w_fc", "mlp.c_fc.weight"),
                             ("b_fc", "mlp.c_fc.bias"),
                             ("w_proj", "mlp.c_proj.weight"),
                             ("b_proj", "mlp.c_proj.bias")):
                add(slot, g(p + hf), i)
        add("ln_f_w", g("ln_f.weight"))
        add("ln_f_b", g("ln_f.bias"))
        return out

    raise ValueError(arch)


def export_ggml(path: str, model, *, quantize: bool = True,
                vocab: Optional[List[bytes]] = None) -> None:
    """A transformers PreTrainedModel → a reference ggml file at ``path``."""
    cfg = ModelConfig.from_hf(model.config)
    tensors = _gather_tensors(cfg.arch, cfg, dict(model.state_dict()),
                              quantize)
    hparams = {
        "n_vocab": cfg.n_vocab, "n_embd": cfg.n_embd, "n_head": cfg.n_head,
        "n_layer": cfg.n_layer, "n_rot": cfg.n_rot,
        "use_parallel_residual": int(cfg.parallel_residual),
        "multiple_of": 1,
        "ftype": 2 if quantize else 0,
    }
    if vocab is None:
        vocab = [f"<tok{i}>".encode() for i in range(cfg.n_vocab)]
    write_ggml(path, cfg.arch, hparams, vocab, tensors)
