"""The slice as a whole, port vs JAX package: the stacked-layer engine
(``unroll_layers=False``: K10 for every layer's matmuls, K9 for the lm head)
and the fused-MLP engine under the f32xf math (K11), on a tiny GPT-J (gelu
tanh) and a tiny GPT-NeoX (exact GELU, two layer norms, biases).

On the CPU the JAX model never reaches its Pallas matmul kernels
(``_use_pallas`` and ``mlp()`` both ask for a TPU backend): it dequantizes
and runs XLA's dot.  So the math-dependent roundings are held at module
level (tests/test_torch_q4_layouts.py, tests/test_torch_mlp_fused.py) and
the model level only at f32 compute, where every route's planes are f32:
greedy streams identical, logits within 1e-4 of max|logit|.  The JAX side
runs its decode kernel in interpret mode (``set_decode_kernel("on")``),
which rounds q to bf16 as K3 does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsim_tpu.engine.generate import InferenceEngine as JEngine
from vsim_tpu.engine.sampling import SamplingParams as JSampling
from vsim_tpu.models.config import ModelConfig as JConfig
from vsim_tpu.models.init import init_params as j_init_params
from vsim_tpu.ops.decode_attention import set_decode_kernel
from vsim_tpu_torch.engine.generate import InferenceEngine
from vsim_tpu_torch.engine.sampling import SamplingParams
from vsim_tpu_torch.models import transformer
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.models.from_jax import params_from_numpy
from vsim_tpu_torch.ops import matmul, q4_cuda

CONFIGS = {
    "gptj": dict(arch="gptj", n_vocab=1000, n_ctx=128, n_embd=512, n_head=2,
                 n_layer=2, n_ff=1024, n_rot=64, rotary_interleaved=True,
                 shared_layernorm=True, qkv_bias=False, attn_out_bias=False,
                 final_logit_bias=True, activation="gelu_tanh"),
    "neox": dict(arch="gptneox", n_vocab=1000, n_ctx=128, n_embd=256,
                 n_head=4, n_layer=2, n_ff=1024, n_rot=16,
                 activation="gelu_exact"),
}
PROMPT = [5, 17, 301, 44, 999, 0, 12]  # <= 8 tokens: the prefill fuses too


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    kw = CONFIGS[request.param]
    jc = JConfig(**kw)
    # std 0.05: large enough that greedy streams do not settle on one token
    params = j_init_params(jc, seed=0, quantize=True, std=0.05)
    rng = np.random.default_rng(9)
    if kw["arch"] == "gptneox":  # non-zero biases, so the fused bias adds
        for k in ("b_fc", "b_proj"):
            params["layers"][k] = jnp.asarray(
                rng.standard_normal(params["layers"][k].shape) * 0.05,
                jnp.float32)
    else:
        params["lm_head_b"] = jnp.asarray(
            rng.standard_normal(1000).astype(np.float32))
    jp = jax.tree.map(np.asarray, params)
    cfg = ModelConfig(**kw)
    return jc, jp, cfg, params_from_numpy(cfg, jp, device="cpu")


@pytest.fixture(scope="module")
def jax_ref(model):
    """The JAX engine's greedy stream and prompt logits (f32)."""
    jc, jp, _, _ = model
    set_decode_kernel("on")
    try:
        jeng = JEngine(jc, jax.tree.map(jnp.asarray, jp), kv_dtype="int8",
                       unroll_layers=False, decode_chunk=16)
        stream = jeng.generate(PROMPT, 12, JSampling(greedy=True)).token_ids
        logits = jeng.generate(PROMPT, 1, return_logits=True).logits
    finally:
        set_decode_kernel("auto")
    return stream, logits


def _count(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    return calls


def _check_logits(got, ref):
    assert got.shape == ref.shape == (len(PROMPT), 1000)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_stacked_engine_matches_jax(model, jax_ref, monkeypatch):
    _, _, cfg, params = model
    stacked = _count(monkeypatch, matmul, "q4_matmul_stacked")
    single = _count(monkeypatch, matmul, "q4_matmul_i")
    eng = InferenceEngine(cfg, params, device="cpu", kv_dtype="int8",
                          unroll_layers=False, decode_chunk=5)
    w_qkv = eng.params["layers"][0]["w_qkv"]  # still stacked, "i"
    assert isinstance(w_qkv, matmul.Q4Layer)
    assert w_qkv.stacked.packed.dim() == 3 and w_qkv.stacked.layout == "i"
    assert eng.params["lm_head"].layout == "i"
    stream = eng.generate(PROMPT, 12, SamplingParams(greedy=True)).token_ids
    assert stream == jax_ref[0]
    # every step: qkv, wo, fc, proj per layer through K10, the lm head K9
    steps = 12  # the prefill and 11 decode steps
    assert len(stacked) == 4 * cfg.n_layer * steps
    assert len(single) == steps
    _check_logits(eng.generate(PROMPT, 1, return_logits=True).logits,
                  jax_ref[1])


def test_per_layer_interleaved_engine_matches_jax(model, jax_ref, monkeypatch):
    """unroll_layers=True, plane_split=False: per-layer "i" weights, K9."""
    _, _, cfg, params = model
    single = _count(monkeypatch, matmul, "q4_matmul_i")
    eng = InferenceEngine(cfg, params, device="cpu", kv_dtype="int8",
                          plane_split=False)
    assert eng.params["layers"][0]["w_fc"].layout == "i"
    assert eng.generate(PROMPT, 12, SamplingParams(greedy=True)).token_ids \
        == jax_ref[0]
    assert len(single) == 12 * (4 * cfg.n_layer + 1)


def test_fused_mlp_engine_matches_jax(model, jax_ref, monkeypatch):
    """The default (plane-split) engine under f32xf: every MLP, prefill
    included (7 rows), is one K11 call."""
    _, _, cfg, params = model
    fused = _count(monkeypatch, transformer, "q4_mlp_ps")
    q4_cuda.set_dequant_math("f32xf")
    try:
        eng = InferenceEngine(cfg, params, device="cpu", kv_dtype="int8")
        stream = eng.generate(PROMPT, 12,
                              SamplingParams(greedy=True)).token_ids
        logits = eng.generate(PROMPT, 1, return_logits=True).logits
    finally:
        q4_cuda.set_dequant_math("gi")
    assert stream == jax_ref[0]
    assert len(fused) == cfg.n_layer * (12 + 1)
    _check_logits(logits, jax_ref[1])


def test_forward_hands_each_layer_a_device_index(model, monkeypatch):
    """forward on stacked params gives q4_matmul a Q4Layer whose il is an
    int32 tensor on the weights' device (never a Python int), the contract
    that lets K10 read the layer on the card without a host sync."""
    _, _, cfg, params = model
    seen = _count(monkeypatch, transformer, "q4_matmul")
    transformer.forward(cfg, params, torch.tensor([PROMPT]), None, 0)
    layers = [a[1] for a in seen if isinstance(a[1], matmul.Q4Layer)]
    n_q4 = sum(isinstance(v, type(params["lm_head"]))
               for v in params["layers"].values())
    assert len(layers) == cfg.n_layer * n_q4
    dev = params["layers"]["w_fc"].packed.device
    for i, w in enumerate(layers):
        assert isinstance(w.il, torch.Tensor)
        assert w.il.dtype == torch.int32 and w.il.numel() == 1
        assert w.il.device == dev
        assert int(w.il) == i // n_q4


def test_stacked_engine_builds_its_layer_index_once(model, monkeypatch):
    """The stacked engine's params hold one Q4Layer per layer and weight,
    built at load: every layer's weight shares one stacked tensor, every
    index is an element of one int32 tensor, and a step builds none."""
    _, _, cfg, params = model
    eng = InferenceEngine(cfg, params, device="cpu", kv_dtype="int8",
                          unroll_layers=False)
    layers = eng.params["layers"]
    assert isinstance(layers, list) and len(layers) == cfg.n_layer
    fc = [lp["w_fc"] for lp in layers]
    assert all(w.stacked is fc[0].stacked for w in fc)
    base = fc[0].il.untyped_storage().data_ptr()
    for i, lp in enumerate(layers):
        for w in lp.values():
            if isinstance(w, matmul.Q4Layer):
                assert w.il.dtype == torch.int32 and int(w.il) == i
                assert w.il.untyped_storage().data_ptr() == base
    built = _count(monkeypatch, transformer, "layer_of")
    eng.generate(PROMPT, 3, SamplingParams(greedy=True))
    assert built == []
    # the stacked tensors count once (fusing q/k/v keeps their bytes), and
    # a second engine shares them
    from vsim_tpu_torch.models.init import param_bytes
    assert param_bytes(layers) == param_bytes(params["layers"])
    again = InferenceEngine(cfg, eng.params, device="cpu", kv_dtype="int8")
    shared = again.params["layers"][1]["w_fc"].stacked
    assert shared.packed.data_ptr() == fc[0].stacked.packed.data_ptr()


def test_stacked_engine_needs_a_card_unless_told(model):
    """With no device given, the stacked engine runs on the card, and
    raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, _, cfg, params = model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(cfg, params, unroll_layers=False)
