"""The reference's ggml model files, read and written (port of
vsim_tpu/convert/ggml_file.py).

File layout (gptneox_model_load, vsim.cpp:108-458; converters/convert_*.py):
  magic 0x67676d6c ('ggml'),
  per-arch int32 hparams (no n_ctx: the reference forces 512 at load,
  vsim.cpp:758),
  vocab: n_vocab × {uint32 len, bytes}   (gptj/gpt2 prefix an explicit count,
  convert_gptj:126 / convert_gpt2:87),
  tensor records until EOF: {int32 n_dims, name_len, ftype,
  ne[n_dims] (minor-first: ne[0]=K), name bytes, raw data}.
  ftype: 0=f32, 1=f16, 2=q4_0 (20-byte blocks), 3=q4_1.

``load_ggml_model`` gives the port's params tree (the one
``params_from_numpy`` gives: layers stacked, Q4 weights as ``Q4Tensor``)
on the device asked for.  Q4_0 payloads are re-wrapped without
requantization: the nibbles are the file's, the f32 scales rounded to the
scale dtype.  Files written here load in the reference binary.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from vsim_tpu_torch import native
from vsim_tpu_torch.device import DeviceLike, resolve_device
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.models.init import params_to
from vsim_tpu_torch.quant.q4 import (
    DEFAULT_SCALE_DTYPE,
    GGML_BLOCK_BYTES,
    QK,
    Q4Tensor,
    dequantize_q4_0_np,
    dequantize_q4_1_np,
    from_ggml_q4_0_bytes,
    from_ggml_q4_1_bytes,
    tensor_from_np,
)

MAGIC = 0x67676D6C

FTYPE_F32, FTYPE_F16, FTYPE_Q4_0, FTYPE_Q4_1 = 0, 1, 2, 3

# int32 hparams after magic, per arch (see the module docstring)
HEADER_FIELDS = {
    "gptneox": ["n_vocab", "n_embd", "n_head", "n_layer", "n_rot",
                "use_parallel_residual", "ftype"],
    "gptj": ["n_vocab", "n_embd", "n_head", "n_layer", "n_rot", "ftype"],
    "bloom": ["n_vocab", "n_embd", "multiple_of", "n_head", "n_layer", "ftype"],
    "gpt2": ["n_vocab", "n_embd", "n_head", "n_layer", "n_rot", "ftype"],
}
# archs whose vocab section is prefixed with its own count
_VOCAB_COUNT_PREFIX = {"gptj", "gpt2"}


class GGMLTensor:
    __slots__ = ("name", "shape", "ftype", "raw")

    def __init__(self, name: str, shape: Tuple[int, ...], ftype: int,
                 raw: np.ndarray):
        self.name = name
        self.shape = shape  # logical numpy order (rows, cols) = (O, K)
        self.ftype = ftype
        self.raw = raw  # uint8 buffer

    def to_numpy(self) -> np.ndarray:
        """Dense f32 view of the tensor."""
        if self.ftype == FTYPE_F32:
            return self.raw.view(np.float32).reshape(self.shape)
        if self.ftype == FTYPE_F16:
            return native.f16_to_f32(
                self.raw.view(np.float16)).reshape(self.shape)
        if self.ftype == FTYPE_Q4_0:
            O, K = self.shape  # noqa: N806
            return dequantize_q4_0_np(
                *from_ggml_q4_0_bytes(self.raw, O, K, torch.float32))
        if self.ftype == FTYPE_Q4_1:
            O, K = self.shape  # noqa: N806
            return dequantize_q4_1_np(*from_ggml_q4_1_bytes(self.raw, O, K))
        raise NotImplementedError(f"ftype {self.ftype} ({self.name})")

    def to_weight(self, scale_dtype=DEFAULT_SCALE_DTYPE):
        """A CPU Q4Tensor for a 2-D Q4_0 payload (no requantization),
        else a dense f32 CPU tensor."""
        if self.ftype == FTYPE_Q4_0 and len(self.shape) == 2:
            O, K = self.shape  # noqa: N806
            packed, scales = native.ggml_to_kmajor(self.raw, O, K,
                                                   scale_dtype)
            return Q4Tensor(packed=torch.from_numpy(packed),
                            scales=tensor_from_np(scales))
        return torch.from_numpy(np.array(self.to_numpy(), np.float32))


def _nbytes(ftype: int, nelem: int, where: str) -> int:
    if ftype == FTYPE_F32:
        return nelem * 4
    if ftype == FTYPE_F16:
        return nelem * 2
    if ftype == FTYPE_Q4_0:
        return nelem // QK * GGML_BLOCK_BYTES
    if ftype == FTYPE_Q4_1:
        return nelem // QK * (8 + QK // 2)
    raise ValueError(f"{where}: unknown ftype {ftype}")


def read_ggml(path: str, arch: str):
    """→ (hparams dict, vocab list[bytes], dict name → GGMLTensor)."""
    fields = HEADER_FIELDS[arch]
    with open(path, "rb") as f:
        (magic,) = struct.unpack("<i", f.read(4))
        if magic != MAGIC:
            raise ValueError(f"{path}: bad magic {magic:#x} (want {MAGIC:#x})")
        hparams = dict(zip(fields, struct.unpack(f"<{len(fields)}i",
                                                 f.read(4 * len(fields)))))
        n_tok = hparams["n_vocab"]
        if arch in _VOCAB_COUNT_PREFIX:
            (n_tok,) = struct.unpack("<i", f.read(4))
        vocab: List[bytes] = []
        for _ in range(n_tok):
            (ln,) = struct.unpack("<I", f.read(4))
            vocab.append(f.read(ln))
        tensors: Dict[str, GGMLTensor] = {}
        while True:
            head = f.read(12)
            if len(head) < 12:
                break
            n_dims, name_len, ftype = struct.unpack("<3i", head)
            ne = struct.unpack(f"<{n_dims}i", f.read(4 * n_dims))  # minor-first
            name = f.read(name_len).decode("utf-8", errors="replace")
            nbytes = _nbytes(ftype, int(np.prod(ne)), f"{path}: {name!r}")
            raw = np.empty(nbytes, dtype=np.uint8)  # writable, read in place
            if f.readinto(memoryview(raw)) != nbytes:
                raise ValueError(f"{path}: {name!r} cut short")
            tensors[name] = GGMLTensor(name, tuple(reversed(ne)), ftype, raw)
    return hparams, vocab, tensors


def write_ggml(path: str, arch: str, hparams: Dict[str, int],
               vocab: List[bytes], tensors: List[GGMLTensor]) -> None:
    """Write a ggml file the reference binary loads."""
    fields = HEADER_FIELDS[arch]
    with open(path, "wb") as f:
        f.write(struct.pack("<i", MAGIC))
        f.write(struct.pack(f"<{len(fields)}i", *(hparams[k] for k in fields)))
        if arch in _VOCAB_COUNT_PREFIX:
            f.write(struct.pack("<i", len(vocab)))
        for tok in vocab:
            f.write(struct.pack("<I", len(tok)))
            f.write(tok)
        for t in tensors:
            ne = tuple(reversed(t.shape))
            name_b = t.name.encode("utf-8")
            f.write(struct.pack("<3i", len(ne), len(name_b), t.ftype))
            f.write(struct.pack(f"<{len(ne)}i", *ne))
            f.write(name_b)
            f.write(np.ascontiguousarray(t.raw).tobytes())


def hparams_to_config(arch: str, hparams: Dict[str, int],
                      n_ctx: int = 512) -> ModelConfig:
    """ggml header → ModelConfig (n_ctx defaults to the reference's forced
    512, vsim.cpp:758; n_ff follows each arch's convention)."""
    E = hparams["n_embd"]  # noqa: N806
    common = dict(
        n_vocab=hparams["n_vocab"], n_ctx=n_ctx, n_embd=E,
        n_head=hparams["n_head"], n_layer=hparams["n_layer"],
    )
    if arch == "gptneox":
        return ModelConfig(
            arch="gptneox", n_ff=4 * E, n_rot=hparams["n_rot"],
            parallel_residual=bool(hparams.get("use_parallel_residual", 1)),
            activation="gelu_tanh", **common,
        )
    if arch == "gptj":
        return ModelConfig(
            arch="gptj", n_ff=4 * E, n_rot=hparams["n_rot"],
            rotary_interleaved=True, parallel_residual=True,
            shared_layernorm=True, qkv_bias=False, attn_out_bias=False,
            final_logit_bias=True, activation="gelu_tanh", **common,
        )
    if arch == "bloom":
        mult = hparams.get("multiple_of", 1) or 1
        return ModelConfig(
            arch="bloom", n_ff=((4 * E + mult - 1) // mult) * mult,
            parallel_residual=False, alibi=True, activation="gelu_tanh",
            **common,
        )
    if arch == "gpt2":
        return ModelConfig(
            arch="gpt2", n_ff=4 * E, parallel_residual=False,
            learned_pos=True, activation="gelu_tanh", **common,
        )
    raise ValueError(arch)


# name of each param slot in a ggml file, per arch ({i} = layer index).
# gptneox names: vsim.cpp:276-346 tensor map.
GGML_NAME_MAPS = {
    "gptneox": {
        "wte": "gpt_neox.embed_in.weight",
        "ln_f_w": "gpt_neox.final_layer_norm.weight",
        "ln_f_b": "gpt_neox.final_layer_norm.bias",
        "lm_head": "embed_out.weight",
        "ln1_w": "gpt_neox.layers.{i}.input_layernorm.weight",
        "ln1_b": "gpt_neox.layers.{i}.input_layernorm.bias",
        "ln2_w": "gpt_neox.layers.{i}.post_attention_layernorm.weight",
        "ln2_b": "gpt_neox.layers.{i}.post_attention_layernorm.bias",
        "wq": "gpt_neox.layers.{i}.attention.query.weight",
        "bq": "gpt_neox.layers.{i}.attention.query.bias",
        "wk": "gpt_neox.layers.{i}.attention.key.weight",
        "bk": "gpt_neox.layers.{i}.attention.key.bias",
        "wv": "gpt_neox.layers.{i}.attention.value.weight",
        "bv": "gpt_neox.layers.{i}.attention.value.bias",
        "wo": "gpt_neox.layers.{i}.attention.dense.weight",
        "bo": "gpt_neox.layers.{i}.attention.dense.bias",
        "w_fc": "gpt_neox.layers.{i}.mlp.dense_h_to_4h.weight",
        "b_fc": "gpt_neox.layers.{i}.mlp.dense_h_to_4h.bias",
        "w_proj": "gpt_neox.layers.{i}.mlp.dense_4h_to_h.weight",
        "b_proj": "gpt_neox.layers.{i}.mlp.dense_4h_to_h.bias",
    },
    "gptj": {
        "wte": "transformer.wte.weight",
        "ln_f_w": "transformer.ln_f.weight",
        "ln_f_b": "transformer.ln_f.bias",
        "lm_head": "lm_head.weight",
        "lm_head_b": "lm_head.bias",
        "ln1_w": "transformer.h.{i}.ln_1.weight",
        "ln1_b": "transformer.h.{i}.ln_1.bias",
        "wq": "transformer.h.{i}.attn.q_proj.weight",
        "wk": "transformer.h.{i}.attn.k_proj.weight",
        "wv": "transformer.h.{i}.attn.v_proj.weight",
        "wo": "transformer.h.{i}.attn.out_proj.weight",
        "w_fc": "transformer.h.{i}.mlp.fc_in.weight",
        "b_fc": "transformer.h.{i}.mlp.fc_in.bias",
        "w_proj": "transformer.h.{i}.mlp.fc_out.weight",
        "b_proj": "transformer.h.{i}.mlp.fc_out.bias",
    },
    # bloom files use llama-style names; the fused qkv is re-grouped to
    # [all-q; all-k; all-v] rows by the reference converter
    # (convert_bloom_to_ggml.py:22-33, 125-127)
    "bloom": {
        "wte": "tok_embeddings.weight",
        "emb_ln_w": "norm.weight",
        "emb_ln_b": "norm.bias",
        "ln_f_w": "output_norm.weight",
        "ln_f_b": "output_norm.bias",
        "lm_head": "output.weight",
        "ln1_w": "layers.{i}.attention_norm.weight",
        "ln1_b": "layers.{i}.attention_norm.bias",
        "ln2_w": "layers.{i}.ffn_norm.weight",
        "ln2_b": "layers.{i}.ffn_norm.bias",
        "w_qkv": "layers.{i}.attention.query_key_value.weight",
        "b_qkv": "layers.{i}.attention.query_key_value.bias",
        "wo": "layers.{i}.attention.wo.weight",
        "bo": "layers.{i}.attention.wo.bias",
        "w_fc": "layers.{i}.feed_forward.w1.weight",
        "b_fc": "layers.{i}.feed_forward.w1.bias",
        "w_proj": "layers.{i}.feed_forward.w2.weight",
        "b_proj": "layers.{i}.feed_forward.w2.bias",
    },
    # gpt2 files are written by convert_gpt2_to_ggml.py from a base
    # GPT2Model state_dict: HF names without the "transformer." prefix,
    # Conv1D [in, out] orientation kept, and every 2-D ".*weight" quantized
    # along the minor (out) axis (quantize_gpt2.cpp:170).
    "gpt2": {
        "wte": "wte.weight",
        "wpe": "wpe.weight",
        "ln_f_w": "ln_f.weight",
        "ln_f_b": "ln_f.bias",
        "ln1_w": "h.{i}.ln_1.weight",
        "ln1_b": "h.{i}.ln_1.bias",
        "ln2_w": "h.{i}.ln_2.weight",
        "ln2_b": "h.{i}.ln_2.bias",
        "w_attn": "h.{i}.attn.c_attn.weight",  # fused qkv [E, 3E] conv1d
        "b_attn": "h.{i}.attn.c_attn.bias",
        "wo": "h.{i}.attn.c_proj.weight",
        "bo": "h.{i}.attn.c_proj.bias",
        "w_fc": "h.{i}.mlp.c_fc.weight",
        "b_fc": "h.{i}.mlp.c_fc.bias",
        "w_proj": "h.{i}.mlp.c_proj.weight",
        "b_proj": "h.{i}.mlp.c_proj.bias",
    },
}


def _stack(leaves: list):
    """Per-layer CPU leaves → one stacked leaf."""
    if isinstance(leaves[0], Q4Tensor):
        return Q4Tensor(packed=torch.stack([t.packed for t in leaves]),
                        scales=torch.stack([t.scales for t in leaves]))
    return torch.from_numpy(np.stack([np.asarray(t, np.float32)
                                      for t in leaves]))


def load_ggml_model(path: str, arch: str, *, n_ctx: int = 512,
                    scale_dtype=DEFAULT_SCALE_DTYPE,
                    device: DeviceLike = None):
    """A reference ggml file → (ModelConfig, params, vocab), the params on
    ``device`` (the card unless another is named)."""
    dev = resolve_device(device)
    hparams, vocab, tensors = read_ggml(path, arch)
    cfg = hparams_to_config(arch, hparams, n_ctx=n_ctx)
    names = GGML_NAME_MAPS[arch]

    def get(slot: str, i: Optional[int] = None) -> GGMLTensor:
        name = names[slot].format(i=i)
        if name not in tensors:
            raise KeyError(f"{path}: missing tensor {name!r}")
        return tensors[name]

    def w(slot, i=None):
        return get(slot, i).to_weight(scale_dtype)

    def vec(slot, i=None):
        return get(slot, i).to_numpy()

    E, F = cfg.n_embd, cfg.n_ff  # noqa: N806
    zeros_e = np.zeros((E,), np.float32)
    layer_list = []
    for i in range(cfg.n_layer):
        if arch == "gpt2":  # dense: the file's Conv1D [in, out] transposed
            wa = get("w_attn", i).to_numpy().reshape(E, 3 * E).T  # [3E, E]
            ba = get("b_attn", i).to_numpy().reshape(3 * E)
            lp = {
                "ln1_w": vec("ln1_w", i).reshape(E),
                "ln1_b": vec("ln1_b", i).reshape(E),
                "ln2_w": vec("ln2_w", i).reshape(E),
                "ln2_b": vec("ln2_b", i).reshape(E),
                "wq": wa[:E], "bq": ba[:E],
                "wk": wa[E:2 * E], "bk": ba[E:2 * E],
                "wv": wa[2 * E:], "bv": ba[2 * E:],
                "wo": vec("wo", i).reshape(E, E).T,
                "bo": vec("bo", i).reshape(E),
                "w_fc": vec("w_fc", i).reshape(E, F).T,
                "b_fc": vec("b_fc", i).reshape(F),
                "w_proj": vec("w_proj", i).reshape(F, E).T,
                "b_proj": vec("b_proj", i).reshape(E),
            }
        elif arch == "bloom":
            # the fused grouped qkv, split into [q; k; v] rows and
            # requantized (the file's blocks run along K, as ours do)
            wqkv = vec("w_qkv", i).reshape(3 * E, E)
            bqkv = vec("b_qkv", i).reshape(3 * E)

            def mk(m):
                return Q4Tensor.from_dense_np(m, scale_dtype, device="cpu")
            lp = {
                "ln1_w": vec("ln1_w", i), "ln1_b": vec("ln1_b", i),
                "ln2_w": vec("ln2_w", i), "ln2_b": vec("ln2_b", i),
                "wq": mk(wqkv[:E]), "bq": bqkv[:E],
                "wk": mk(wqkv[E:2 * E]), "bk": bqkv[E:2 * E],
                "wv": mk(wqkv[2 * E:]), "bv": bqkv[2 * E:],
                "wo": w("wo", i), "bo": vec("bo", i),
                "w_fc": w("w_fc", i), "b_fc": vec("b_fc", i),
                "w_proj": w("w_proj", i), "b_proj": vec("b_proj", i),
            }
        else:
            lp = {
                "ln1_w": vec("ln1_w", i), "ln1_b": vec("ln1_b", i),
                "wq": w("wq", i), "wk": w("wk", i), "wv": w("wv", i),
                "wo": w("wo", i),
                "w_fc": w("w_fc", i), "b_fc": vec("b_fc", i),
                "w_proj": w("w_proj", i), "b_proj": vec("b_proj", i),
            }
            if arch == "gptj":  # one LN and no attention biases
                lp.update({
                    "ln2_w": np.ones((E,), np.float32), "ln2_b": zeros_e,
                    "bq": zeros_e, "bk": zeros_e, "bv": zeros_e, "bo": zeros_e,
                })
            else:
                lp.update({
                    "ln2_w": vec("ln2_w", i), "ln2_b": vec("ln2_b", i),
                    "bq": vec("bq", i), "bk": vec("bk", i),
                    "bv": vec("bv", i), "bo": vec("bo", i),
                })
        layer_list.append(lp)

    params: Dict[str, Any] = {
        "layers": {k: _stack([lp[k] for lp in layer_list])
                   for k in layer_list[0]}}
    if arch == "gpt2":  # the tied wte, requantized along K
        params["wte"] = Q4Tensor.from_dense_np(vec("wte"), scale_dtype,
                                               device="cpu")
        params["lm_head"] = params["wte"]
        params["wpe"] = torch.from_numpy(np.array(vec("wpe"), np.float32))
        params["ln_f_w"] = torch.from_numpy(vec("ln_f_w").reshape(E).copy())
        params["ln_f_b"] = torch.from_numpy(vec("ln_f_b").reshape(E).copy())
    else:
        params["wte"] = w("wte")
        params["ln_f_w"] = torch.from_numpy(vec("ln_f_w").copy())
        params["ln_f_b"] = torch.from_numpy(vec("ln_f_b").copy())
        if arch == "bloom":
            params["emb_ln_w"] = torch.from_numpy(vec("emb_ln_w").copy())
            params["emb_ln_b"] = torch.from_numpy(vec("emb_ln_b").copy())
            lm = names["lm_head"]
            params["lm_head"] = w("lm_head") if lm in tensors \
                else params["wte"]  # tied
        else:
            params["lm_head"] = w("lm_head")
        if arch == "gptj":
            params["lm_head_b"] = torch.from_numpy(vec("lm_head_b").copy())
    return cfg, params_to(params, dev), vocab
