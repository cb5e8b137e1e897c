"""Model configuration for the four reference architectures.

Reference hparams ride in the ggml file header (vsim.cpp:44-53 for NeoX;
quantize_{gptj,bloom,gpt2}.cpp headers for the others).  Here they are a
frozen dataclass, constructible from a HuggingFace config for conversion.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str  # 'gptneox' | 'gptj' | 'bloom' | 'gpt2'
    n_vocab: int
    n_ctx: int
    n_embd: int
    n_head: int
    n_layer: int
    n_ff: int
    # rotary embedding: number of rotated head dims (0 = none)
    n_rot: int = 0
    rotary_interleaved: bool = False  # GPT-J/CodeGen interleave pairs
    rope_base: float = 10000.0
    # residual topology
    parallel_residual: bool = True  # NeoX use_parallel_residual / GPT-J
    shared_layernorm: bool = False  # GPT-J: one LN feeds both attn and MLP
    qkv_bias: bool = True
    attn_out_bias: bool = True
    alibi: bool = False  # BLOOM
    learned_pos: bool = False  # GPT-2 wpe
    activation: str = "gelu_exact"
    ln_eps: float = 1e-5
    final_logit_bias: bool = False  # GPT-J lm_head has a bias
    # runtime dtypes
    compute_dtype: str = "float32"
    kv_dtype: str = "float32"
    # reference-parity mode: also Q4_0-quantize activations before each
    # weight matmul, as the reference does in the matmul INIT phase
    # (ggml.c:5030-5038) — for bit-width-matched logits/ppl comparisons
    act_quant: bool = False
    # blockwise (flash) attention for a prefill over its own k/v and the
    # cache-free forward: K4 (ops/attention.py) at any T; False attends
    # through the plain einsum (models/transformer.py:_attend_plain)
    use_flash: bool = True
    # fuse wq/wk/wv into one head-interleaved w_qkv at engine load
    # (models/init.py:fuse_qkv_params) — one weight stream per layer
    # instead of three on the decode hot path
    fuse_qkv: bool = True

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- HF conversion -----------------------------------------------------

    @staticmethod
    def from_hf(hf_config, n_ctx: Optional[int] = None) -> "ModelConfig":
        """Build from a transformers PretrainedConfig (no network needed)."""
        t = hf_config.model_type
        if t == "gpt_neox":
            head_dim = hf_config.hidden_size // hf_config.num_attention_heads
            return ModelConfig(
                arch="gptneox",
                n_vocab=hf_config.vocab_size,
                n_ctx=n_ctx or hf_config.max_position_embeddings,
                n_embd=hf_config.hidden_size,
                n_head=hf_config.num_attention_heads,
                n_layer=hf_config.num_hidden_layers,
                n_ff=hf_config.intermediate_size,
                n_rot=int(hf_config.rotary_pct * head_dim),
                rotary_interleaved=False,
                rope_base=getattr(hf_config, "rotary_emb_base", 10000.0),
                parallel_residual=getattr(hf_config, "use_parallel_residual", True),
                activation=hf_config.hidden_act,
                ln_eps=hf_config.layer_norm_eps,
            )
        if t == "codegen":
            # CodeGen is GPT-J-architecture (the reference converts it to
            # GPT-J layout, convert_gptj_to_ggml.py:121-211); fused qkv_proj
            # is split by convert/hf.py
            return ModelConfig(
                arch="gptj",
                n_vocab=hf_config.vocab_size,
                n_ctx=n_ctx or hf_config.n_positions,
                n_embd=hf_config.n_embd,
                n_head=hf_config.n_head,
                n_layer=hf_config.n_layer,
                n_ff=hf_config.n_inner or 4 * hf_config.n_embd,
                n_rot=hf_config.rotary_dim or (hf_config.n_embd // hf_config.n_head),
                rotary_interleaved=True,
                parallel_residual=True,
                shared_layernorm=True,
                qkv_bias=False,
                attn_out_bias=False,
                activation=hf_config.activation_function,
                ln_eps=hf_config.layer_norm_epsilon,
                final_logit_bias=True,
            )
        if t == "gptj":
            return ModelConfig(
                arch="gptj",
                n_vocab=hf_config.vocab_size,
                n_ctx=n_ctx or hf_config.n_positions,
                n_embd=hf_config.n_embd,
                n_head=hf_config.n_head,
                n_layer=hf_config.n_layer,
                n_ff=hf_config.n_inner or 4 * hf_config.n_embd,
                n_rot=hf_config.rotary_dim or (hf_config.n_embd // hf_config.n_head),
                rotary_interleaved=True,
                parallel_residual=True,
                shared_layernorm=True,
                qkv_bias=False,
                attn_out_bias=False,
                activation=hf_config.activation_function,
                ln_eps=hf_config.layer_norm_epsilon,
                final_logit_bias=True,
            )
        if t == "bloom":
            return ModelConfig(
                arch="bloom",
                n_vocab=hf_config.vocab_size,
                n_ctx=n_ctx or 2048,
                n_embd=hf_config.hidden_size,
                n_head=hf_config.n_head,
                n_layer=hf_config.n_layer,
                n_ff=4 * hf_config.hidden_size,
                parallel_residual=False,
                alibi=True,
                activation="gelu_tanh",  # BLOOM uses tanh-approx GELU
                ln_eps=hf_config.layer_norm_epsilon,
            )
        if t == "gpt2":
            return ModelConfig(
                arch="gpt2",
                n_vocab=hf_config.vocab_size,
                n_ctx=n_ctx or hf_config.n_positions,
                n_embd=hf_config.n_embd,
                n_head=hf_config.n_head,
                n_layer=hf_config.n_layer,
                n_ff=hf_config.n_inner or 4 * hf_config.n_embd,
                parallel_residual=False,
                learned_pos=True,
                activation=hf_config.activation_function,
                ln_eps=hf_config.layer_norm_epsilon,
            )
        raise ValueError(f"unsupported HF model_type {t!r}")


# Reference model zoo shapes (interface.py:49-143 registry + converter headers)
PRESETS = {
    "pythia-70m": ModelConfig("gptneox", 50304, 2048, 512, 8, 6, 2048, n_rot=16),
    "pythia-410m": ModelConfig("gptneox", 50304, 2048, 1024, 16, 24, 4096, n_rot=16),
    "pythia-12b": ModelConfig("gptneox", 50688, 2048, 5120, 40, 36, 20480, n_rot=32),
    "gpt-j-6b": ModelConfig(
        "gptj", 50400, 2048, 4096, 16, 28, 16384,
        n_rot=64, rotary_interleaved=True, shared_layernorm=True,
        qkv_bias=False, attn_out_bias=False, final_logit_bias=True,
        activation="gelu_tanh",
    ),
    "gpt-neox-20b": ModelConfig(  # togethercomputer/GPT-NeoXT-Chat-Base-20B
        "gptneox", 50432, 2048, 6144, 64, 44, 24576, n_rot=24),
    "stablelm-7b": ModelConfig(  # stabilityai/stablelm-tuned-alpha-7b
        "gptneox", 50432, 4096, 6144, 48, 16, 24576, n_rot=32),
    "codegen-350m": ModelConfig(  # Salesforce/codegen-350M-mono (GPT-J arch)
        "gptj", 51200, 2048, 1024, 16, 20, 4096,
        n_rot=32, rotary_interleaved=True, shared_layernorm=True,
        qkv_bias=False, attn_out_bias=False, final_logit_bias=True,
        activation="gelu_tanh",
    ),
    "codegen-2b": ModelConfig(  # Salesforce/codegen-2B-mono
        "gptj", 51200, 2048, 2560, 32, 32, 10240,
        n_rot=64, rotary_interleaved=True, shared_layernorm=True,
        qkv_bias=False, attn_out_bias=False, final_logit_bias=True,
        activation="gelu_tanh",
    ),
    "codegen-6b": ModelConfig(  # Salesforce/codegen-6B-mono
        "gptj", 51200, 2048, 4096, 16, 33, 16384,
        n_rot=64, rotary_interleaved=True, shared_layernorm=True,
        qkv_bias=False, attn_out_bias=False, final_logit_bias=True,
        activation="gelu_tanh",
    ),
    "codegen-16b": ModelConfig(  # Salesforce/codegen-16B-mono
        "gptj", 51200, 2048, 6144, 24, 34, 24576,
        n_rot=64, rotary_interleaved=True, shared_layernorm=True,
        qkv_bias=False, attn_out_bias=False, final_logit_bias=True,
        activation="gelu_tanh",
    ),
    "bloom-560m": ModelConfig(
        "bloom", 250880, 2048, 1024, 16, 24, 4096,
        parallel_residual=False, alibi=True, activation="gelu_tanh",
    ),
    "bloom-7b1": ModelConfig(
        "bloom", 250880, 2048, 4096, 32, 30, 16384,
        parallel_residual=False, alibi=True, activation="gelu_tanh",
    ),
    "gpt2": ModelConfig(
        "gpt2", 50257, 1024, 768, 12, 12, 3072,
        parallel_residual=False, learned_pos=True, activation="gelu_tanh",
    ),
}
