"""The slice as a whole, port vs JAX package, on a tiny GPT-J-shaped model
(E=512, H=2, D=256, n_rot=64, 2 layers, vocab 1000 padded to 1024 in the
engine).

  * forward logits, same params: f32 compute to rtol/atol 1e-4; bf16 to
    0.01 of max|logit| (every activation rounds to bf16, ~4e-3 relative,
    and the two packages take different kernels: the JAX CPU path
    dequantizes in bf16, the port's n <= 8 route the grouped-integer math);
  * InferenceEngine greedy streams identical at f32 compute with int8 and
    int4 KV.  The JAX side runs its decode kernel (set_decode_kernel("on"),
    interpret mode), which rounds q to bf16 as K3 and its plain version do;
  * return_logits; sampling; entry points refusing to run without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsim_tpu.engine.generate import InferenceEngine as JEngine
from vsim_tpu.engine.sampling import SamplingParams as JSampling
from vsim_tpu.engine.sampling import sample_np as j_sample_np
from vsim_tpu.models.config import ModelConfig as JConfig
from vsim_tpu.models.init import init_params as j_init_params
from vsim_tpu.models.transformer import forward as j_forward
from vsim_tpu.models.transformer import init_cache as j_init_cache
from vsim_tpu.ops.decode_attention import set_decode_kernel
from vsim_tpu_torch.engine.generate import InferenceEngine
from vsim_tpu_torch.engine.sampling import SamplingParams, sample_np, sample_torch
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.models.from_jax import params_from_numpy
from vsim_tpu_torch.models.init import random_q4_params
from vsim_tpu_torch.models.transformer import forward, init_cache

GPTJ_TINY = dict(arch="gptj", n_vocab=1000, n_ctx=128, n_embd=512, n_head=2,
                 n_layer=2, n_ff=1024, n_rot=64, rotary_interleaved=True,
                 shared_layernorm=True, qkv_bias=False, attn_out_bias=False,
                 final_logit_bias=True, activation="gelu_tanh")
PROMPT = [5, 17, 301, 44, 999, 0, 12, 250, 7, 63, 128, 3]


@pytest.fixture(scope="module")
def jax_params():
    jc = JConfig(**GPTJ_TINY)
    # std 0.05: large enough that greedy streams do not settle on one token
    params = j_init_params(jc, seed=0, quantize=True, std=0.05)
    # a non-zero lm-head bias, so the padded-bias path is exercised
    params["lm_head_b"] = jnp.asarray(
        np.random.default_rng(9).standard_normal(1000).astype(np.float32))
    return jax.tree.map(np.asarray, params)


def _port(jax_params, **kw):
    cfg = ModelConfig(**{**GPTJ_TINY, **kw})
    return cfg, params_from_numpy(cfg, jax_params, device="cpu")


def _jax_forward_steps(cfg, params, kv, steps):
    cache = j_init_cache(cfg, 1, dtype=kv)
    ids = jnp.asarray([PROMPT], jnp.int32)
    logits, cache = j_forward(cfg, params, ids, cache, 0, fresh_kv=True)
    outs = [np.asarray(logits)]
    for i, tok in enumerate(steps):
        logits, cache = j_forward(cfg, params, jnp.asarray([[tok]], jnp.int32),
                                  cache, jnp.int32(len(PROMPT) + i),
                                  kv_len=cfg.n_ctx)
        outs.append(np.asarray(logits))
    return outs


def _port_forward_steps(cfg, params, kv, steps):
    cache = init_cache(cfg, 1, dtype=kv, device="cpu")
    ids = torch.tensor([PROMPT])
    logits, cache = forward(cfg, params, ids, cache, 0, fresh_kv=True)
    outs = [logits.numpy()]
    for i, tok in enumerate(steps):
        logits, cache = forward(cfg, params, torch.tensor([[tok]]), cache,
                                len(PROMPT) + i)
        outs.append(logits.numpy())
    return outs


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_forward_logits_match_jax(jax_params, compute_dtype):
    jc = JConfig(**GPTJ_TINY, compute_dtype=compute_dtype)
    cfg, params = _port(jax_params, compute_dtype=compute_dtype)
    steps = [11, 400, 2]
    set_decode_kernel("on")
    try:
        ref = _jax_forward_steps(jc, jax_params, "int8", steps)
    finally:
        set_decode_kernel("auto")
    got = _port_forward_steps(cfg, params, "int8", steps)
    for r, g in zip(ref, got):
        assert g.shape == r.shape and np.isfinite(g).all()
        if compute_dtype == "float32":
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4)
        else:
            assert np.abs(g - r).max() <= 0.01 * np.abs(r).max()


def test_engine_params_match_unfused_forward(jax_params):
    """The engine-load transforms (padded lm head, fused qkv, per-layer
    plane-split weights) leave the f32 logits unchanged."""
    cfg, params = _port(jax_params)
    eng = InferenceEngine(cfg, params, device="cpu", kv_dtype="int8")
    assert eng.params["lm_head"].out_features == 1024
    assert eng.params["layers"][0]["w_qkv"].layout == "ps"
    steps = [11, 400]
    ref = _port_forward_steps(cfg, params, "int8", steps)
    got = _port_forward_steps(cfg, eng.params, "int8", steps)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_greedy_streams_identical_to_jax_engine(jax_params, kv):
    jc = JConfig(**GPTJ_TINY)
    cfg, params = _port(jax_params)
    jparams = jax.tree.map(jnp.asarray, jax_params)
    set_decode_kernel("on")
    try:
        jeng = JEngine(jc, jparams, kv_dtype=kv, decode_chunk=16)
        ref = jeng.generate(PROMPT, 12, JSampling(greedy=True)).token_ids
    finally:
        set_decode_kernel("auto")
    streamed = []
    eng = InferenceEngine(cfg, params, device="cpu", kv_dtype=kv,
                          decode_chunk=5)
    got = eng.generate(PROMPT, 12, SamplingParams(greedy=True),
                       streaming_token_hook=streamed.append)
    assert got.token_ids == ref
    assert streamed == ref
    # a stop token ends the stream where it first appears
    stop = ref[4]
    cut = eng.generate(PROMPT, 12, SamplingParams(greedy=True),
                       stop_tokens=[stop]).token_ids
    assert cut == ref[:ref.index(stop) + 1]


def test_return_logits_match_jax(jax_params):
    jc = JConfig(**GPTJ_TINY)
    cfg, params = _port(jax_params)
    ref = JEngine(jc, jax.tree.map(jnp.asarray, jax_params)).generate(
        PROMPT, 4, return_logits=True).logits
    got = InferenceEngine(cfg, params, device="cpu").generate(
        PROMPT, 4, return_logits=True).logits
    assert got.shape == ref.shape == (len(PROMPT), 1000)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_sample_torch_greedy_and_distribution():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 50)).astype(np.float32) * 3
    last = np.asarray([[1, 2, -1], [4, 4, 4], [-1, -1, -1]])
    got = sample_torch(torch.from_numpy(logits), torch.from_numpy(last), None,
                       greedy=True)
    for b in range(3):
        assert int(got[b]) == j_sample_np(
            logits[b], list(last[b]), JSampling(greedy=True), rng)
    # sampled frequencies against the reference sampler's distribution:
    # 8 tokens, penalty on two of them, top-k 5, top-p 0.9
    lg = np.asarray([[2.0, 1.5, -0.5, 1.0, 0.2, -2.0, 0.8, 1.4]], np.float32)
    window = [0, 2]
    sp = SamplingParams(temperature=0.8, top_k=5, top_p=0.9,
                        repeat_penalty=1.3)
    n = 20000
    gen = torch.Generator().manual_seed(42)
    toks = sample_torch(torch.from_numpy(np.repeat(lg, n, axis=0)),
                        torch.tensor([window] * n), gen, top_k=sp.top_k,
                        top_p=sp.top_p, temperature=sp.temperature,
                        repeat_penalty=sp.repeat_penalty)
    f_torch = np.bincount(toks.numpy(), minlength=8) / n
    nrng = np.random.default_rng(1)
    f_np = np.bincount([sample_np(lg[0], window, sp, nrng)
                        for _ in range(n)], minlength=8) / n
    np.testing.assert_allclose(f_torch, f_np, atol=0.02)
    assert f_torch[5] == 0.0  # outside the top-k


def test_entry_points_need_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = ModelConfig(**GPTJ_TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        random_q4_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(cfg, 1)
    params = random_q4_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(cfg, params)
