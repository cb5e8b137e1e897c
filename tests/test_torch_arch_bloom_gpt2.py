"""Port vs JAX package on BLOOM (ALiBi) and GPT-2 (learned positions), at
f32 compute on tiny models (2 layers, H = 2, E = 2 D, vocab 256) and D = 64
and 128, with test_torch_arch_parity.py's models and helpers:

  * forward logits, the prefill's and the three one-token routes', within
    1e-5 of max|logit| of the JAX forward (int8 and int4 KV); the JAX side
    runs set_decode_kernel("on");
  * InferenceEngine and ServingEngine greedy streams equal to the JAX
    engines' (int8 KV).
"""

import jax
import jax.numpy as jnp
import pytest

from vsim_tpu.engine.generate import InferenceEngine as JEngine
from vsim_tpu.engine.sampling import SamplingParams as JSampling
from vsim_tpu.engine.serving import ServingEngine as JServing
from vsim_tpu.models.config import ModelConfig as JConfig
from vsim_tpu.ops.decode_attention import set_decode_kernel
from vsim_tpu_torch.engine.generate import InferenceEngine
from vsim_tpu_torch.engine.sampling import SamplingParams
from vsim_tpu_torch.engine.serving import ServingEngine
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.models.from_jax import params_from_numpy

from test_torch_arch_parity import (  # noqa: F401 (models: a fixture)
    PROMPT,
    _assert_close,
    _jax_steps,
    _port_steps,
    models,
)


@pytest.mark.parametrize("kv", ["int8", "int4"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("arch", ["bloom", "gpt2"])
def test_forward_logits_match_jax(models, arch, D, kv):  # noqa: N803
    kw, params = models(arch, D)
    _assert_close(_port_steps(kw, params, kv), _jax_steps(kw, params, kv))


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("arch", ["bloom", "gpt2"])
def test_engine_streams_equal_jax(models, arch, D):  # noqa: N803
    kw, params = models(arch, D)
    cfg = ModelConfig(**kw)
    set_decode_kernel("on")
    try:
        jeng = JEngine(JConfig(**kw), jax.tree.map(jnp.asarray, params),
                       kv_dtype="int8", decode_chunk=8)
        ref = jeng.generate(PROMPT, 10, JSampling(greedy=True)).token_ids
    finally:
        set_decode_kernel("auto")
    eng = InferenceEngine(cfg, params_from_numpy(cfg, params, device="cpu"),
                          device="cpu", kv_dtype="int8", decode_chunk=4)
    assert eng.generate(PROMPT, 10, SamplingParams(greedy=True)).token_ids \
        == ref


def _serve(srv, prompts):
    ids = [srv.submit(p, 6, stop_tokens=()) for p in prompts]
    while srv._queue or srv._active:
        srv.step_chunk(3)
    return [srv._results[i].generated for i in ids]


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("arch", ["bloom", "gpt2"])
def test_serving_streams_equal_jax(models, arch, D):  # noqa: N803
    kw, params = models(arch, D)
    prompts = [PROMPT, PROMPT[3:5], PROMPT[::-1][:6]]
    set_decode_kernel("on")
    try:
        jsrv = JServing(JConfig(**kw, kv_dtype="int8"),
                        jax.tree.map(jnp.asarray, params), max_batch=2)
        want = _serve(jsrv, prompts)
    finally:
        set_decode_kernel("auto")
    cfg = ModelConfig(**kw)
    srv = ServingEngine(cfg, params_from_numpy(cfg, params, device="cpu"),
                        max_batch=2, kv_dtype="int8", device="cpu")
    assert _serve(srv, prompts) == want
