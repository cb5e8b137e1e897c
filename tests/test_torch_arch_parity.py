"""Port vs JAX package across head dims, at f32 compute on tiny models (2
layers, H = 2, E = 2 D, vocab 256); BLOOM's and GPT-2's tests, which use
the helpers here, are in test_torch_arch_bloom_gpt2.py.

  * decode-step logits within 1e-5 of max|logit| of the JAX forward at
    D = 64 and 80, int8 and int4 KV, on NeoX and GPT-J shapes, through the
    three one-token routes (an int n_past: the cache write, then K3; a
    device n_past with write_first: K6's one-layer write, then K3; a device
    n_past: K5, then K6's all-layer write).  The JAX side runs
    set_decode_kernel("on"): its decode kernel, which rounds q to bf16,
    where D % 128 == 0, and its f32 einsum elsewhere.  The port's K3 / K5
    take ``round_q = D % 128 == 0`` to match.  At D = 128 both round q to
    bf16, so an f32 q one ulp apart in the two packages (their f32 sums run
    in other orders) can land on neighbouring bf16 values: one element of
    q off by 2^-8 of itself moves a logit by up to ~5e-5 of max|logit|, and
    D = 128 is held to 1e-4 (TOL_ROUNDED_Q).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsim_tpu.models.config import ModelConfig as JConfig
from vsim_tpu.models.init import init_params as j_init_params
from vsim_tpu.models.transformer import forward as j_forward
from vsim_tpu.models.transformer import init_cache as j_init_cache
from vsim_tpu.ops.decode_attention import set_decode_kernel
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.models.from_jax import params_from_numpy
from vsim_tpu_torch.models.transformer import forward, init_cache

ARCHS = {
    "gptneox": dict(arch="gptneox", activation="gelu_exact"),
    "gptj": dict(arch="gptj", rotary_interleaved=True, shared_layernorm=True,
                 qkv_bias=False, attn_out_bias=False, final_logit_bias=True,
                 activation="gelu_tanh"),
    "bloom": dict(arch="bloom", parallel_residual=False, alibi=True,
                  activation="gelu_tanh"),
    "gpt2": dict(arch="gpt2", parallel_residual=False, learned_pos=True,
                 activation="gelu_tanh"),
}
PROMPT = [5, 17, 201, 44, 255, 0, 12, 150, 7, 63]
STEPS = [11, 100, 2, 240]
TOL = 1e-5  # of max|logit|
TOL_ROUNDED_Q = 1e-4  # of max|logit|, where both packages round q to bf16


def _shape(arch, D):  # noqa: N803
    rot = {"gptneox": D // 4, "gptj": D // 2}.get(arch, 0)
    return dict(ARCHS[arch], n_vocab=256, n_ctx=32, n_embd=2 * D, n_head=2,
                n_layer=2, n_ff=4 * D, n_rot=rot)


@pytest.fixture(scope="module")
def models():
    """(config kwargs, numpy params) per (arch, D), built once."""
    cache = {}

    def get(arch, D):  # noqa: N803
        if (arch, D) not in cache:
            kw = _shape(arch, D)
            params = j_init_params(JConfig(**kw), seed=D, quantize=True,
                                   std=0.05)
            cache[arch, D] = kw, jax.tree.map(np.asarray, params)
        return cache[arch, D]
    return get


def _jax_steps(kw, params, kv):
    jc = JConfig(**kw)
    cache = j_init_cache(jc, 1, dtype=kv)
    set_decode_kernel("on")
    try:
        logits, cache = j_forward(jc, params, jnp.asarray([PROMPT], jnp.int32),
                                  cache, 0, fresh_kv=True)
        outs = [np.asarray(logits)]
        for i, tok in enumerate(STEPS):
            logits, cache = j_forward(jc, params,
                                      jnp.asarray([[tok]], jnp.int32), cache,
                                      jnp.int32(len(PROMPT) + i),
                                      kv_len=jc.n_ctx)
            outs.append(np.asarray(logits))
    finally:
        set_decode_kernel("auto")
    return outs


def _port_steps(kw, params, kv):
    cfg = ModelConfig(**kw)
    tp = params_from_numpy(cfg, params, device="cpu")
    cache = init_cache(cfg, 1, dtype=kv, device="cpu")
    logits, cache = forward(cfg, tp, torch.tensor([PROMPT]), cache, 0,
                            fresh_kv=True)
    outs = [logits.numpy()]
    for i, tok in enumerate(STEPS):
        n_past = len(PROMPT) + i
        route = i % 3  # int n_past; device n_past written first; deferred
        logits, cache = forward(
            cfg, tp, torch.tensor([[tok]]), cache,
            n_past if route == 0 else torch.tensor([n_past],
                                                   dtype=torch.int32),
            write_first=route == 1)
        outs.append(logits.numpy())
    return outs


def _assert_close(got, ref, tol=TOL):
    for g, r in zip(got, ref):
        assert g.shape == r.shape and np.isfinite(g).all()
        err = np.abs(g - r).max() / np.abs(r).max()
        assert err <= tol, err


@pytest.mark.parametrize("kv", ["int8", "int4"])
@pytest.mark.parametrize("D", [64, 80, 128])
@pytest.mark.parametrize("arch", ["gptneox", "gptj"])
def test_decode_step_logits_match_jax(models, arch, D, kv):  # noqa: N803
    kw, params = models(arch, D)
    _assert_close(_port_steps(kw, params, kv), _jax_steps(kw, params, kv),
                  TOL_ROUNDED_Q if D % 128 == 0 else TOL)
