"""Port vs JAX package: the continuous-batching ServingEngine on the tiny
GPT-J-shaped model (E=512, H=2, D=256, 2 layers), f32 compute.

  * (d) greedy streams identical to the JAX ServingEngine's with int8, int4
    and float32 KV: more prompts than slots (slot reuse), a mid-flight
    submit, ``step()`` and ``step_chunk()``, a stop token shared by all
    requests (stopped on the device) that frees its slot, the streaming
    hook.  The JAX side runs its fresh-mode decode kernel and row writer
    in interpret mode (set_decode_kernel("on"));
  * (e) the port's serving streams equal its InferenceEngine's;
  * (f) ``warmup`` changes neither the slots nor a seeded sampled stream;
  * (g) the engine refuses to run without a card unless told the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsim_tpu.engine.serving import ServingEngine as JServing
from vsim_tpu.models.config import ModelConfig as JConfig
from vsim_tpu.models.init import init_params as j_init_params
from vsim_tpu.ops.decode_attention import set_decode_kernel
from vsim_tpu_torch.engine.generate import InferenceEngine
from vsim_tpu_torch.engine.sampling import SamplingParams
from vsim_tpu_torch.engine.serving import ServingEngine
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.models.from_jax import params_from_numpy
from vsim_tpu_torch.models.init import random_q4_params

GPTJ_TINY = dict(arch="gptj", n_vocab=1000, n_ctx=64, n_embd=512, n_head=2,
                 n_layer=2, n_ff=1024, n_rot=64, rotary_interleaved=True,
                 shared_layernorm=True, qkv_bias=False, attn_out_bias=False,
                 final_logit_bias=True, activation="gelu_tanh")
PROMPTS = [[5, 17, 301, 44, 999], [9, 8], [4, 5, 6, 7, 100, 200, 3], [11],
           [3, 14, 15, 92]]


@pytest.fixture(scope="module")
def jax_params():
    params = j_init_params(JConfig(**GPTJ_TINY), seed=0, quantize=True,
                           std=0.05)
    params["lm_head_b"] = jnp.asarray(
        np.random.default_rng(9).standard_normal(1000).astype(np.float32))
    return jax.tree.map(np.asarray, params)


def _port_params(jax_params):
    cfg = ModelConfig(**GPTJ_TINY)
    return cfg, params_from_numpy(cfg, jax_params, device="cpu")


def _scenario(srv):
    """Staggered traffic on 2 slots through both step kinds; returns each
    request's stream and what the streaming hook saw."""
    seen = []
    a = srv.submit(PROMPTS[0], 9, stop_tokens=(),
                   streaming_token_hook=seen.append)
    b = srv.submit(PROMPTS[1], 4, stop_tokens=())
    c = srv.submit(PROMPTS[2], 7, stop_tokens=())  # waits for a free slot
    for _ in range(3):
        srv.step()
    d = srv.submit(PROMPTS[3], 6, stop_tokens=())  # mid-flight
    e = srv.submit(PROMPTS[4], 5, stop_tokens=())
    while srv._queue or srv._active:
        srv.step_chunk(3)
    return [srv._results[i].generated for i in (a, b, c, d, e)], seen


@pytest.mark.parametrize("kv", ["int8", "int4", "float32"])
def test_serving_streams_identical_to_jax(jax_params, kv):
    jc = JConfig(**GPTJ_TINY, kv_dtype=kv)
    cfg, params = _port_params(jax_params)
    set_decode_kernel("on")
    try:
        jsrv = JServing(jc, jax.tree.map(jnp.asarray, jax_params), max_batch=2)
        want, want_seen = _scenario(jsrv)
        # a stop id every request shares: the slot stops on the device
        stop = want[2][3]
        jout = jsrv.run(PROMPTS, 8, stop_tokens=(stop,), chunk_steps=4)
    finally:
        set_decode_kernel("auto")
    srv = ServingEngine(cfg, params, max_batch=2, kv_dtype=kv, device="cpu")
    got, seen = _scenario(srv)
    assert got == want
    assert seen == want_seen == want[0]
    assert [len(s) for s in got] == [9, 4, 7, 6, 5]
    # run() returns every request finished since the last run(): the
    # scenario's five (ids 0-4, no stop ids) and these five
    out = srv.run(PROMPTS, 8, stop_tokens=(stop,), chunk_steps=4)
    streams = [out[i].generated for i in sorted(out)]
    assert streams == [jout[i].generated for i in sorted(jout)]
    cut = [g for g in streams[len(PROMPTS):] if stop in g]
    assert cut and all(g[-1] == stop and g.count(stop) == 1 for g in cut)
    assert sorted(srv._free) == [0, 1] and not srv._active


@pytest.mark.parametrize("kv", ["int8", "int4", "float32"])
def test_serving_streams_equal_inference_engine(jax_params, kv):
    cfg, params = _port_params(jax_params)
    eng = InferenceEngine(cfg, params, kv_dtype=kv, device="cpu")
    want = [eng.generate(p, 8, SamplingParams(greedy=True)).token_ids
            for p in PROMPTS]
    srv = ServingEngine(cfg, eng.params, max_batch=3, kv_dtype=kv,
                        device="cpu")
    # an engine's params are shared, not copied
    w = (srv.params["layers"][1]["w_qkv"], eng.params["layers"][1]["w_qkv"])
    assert w[0].packed.data_ptr() == w[1].packed.data_ptr()
    out = srv.run(PROMPTS, 8, stop_tokens=(), chunk_steps=5)
    assert [out[i].generated for i in sorted(out)] == want


def test_warmup_leaves_slots_and_sampled_stream(jax_params):
    cfg, params = _port_params(jax_params)
    sp = SamplingParams(temperature=0.8, top_k=20, top_p=0.95,
                        repeat_penalty=1.1)

    def drive(sampling, warm):
        srv = ServingEngine(cfg, params, max_batch=2, kv_dtype="int8",
                            sampling=sampling, seed=7, device="cpu")
        srv.submit(PROMPTS[0], 10, stop_tokens=())
        srv.step()  # one slot busy, so warmup runs beside a live request
        if warm:
            state = [t.clone() for t in (srv.tokens, srv.n_past,
                                         srv.last_tokens, *srv.cache["k"],
                                         *srv.cache["v"])]
            gen_state = srv.generator.get_state()
            assert srv.warmup() > 0
            after = (srv.tokens, srv.n_past, srv.last_tokens,
                     *srv.cache["k"], *srv.cache["v"])
            assert all(torch.equal(a, b) for a, b in zip(state, after))
            assert torch.equal(gen_state, srv.generator.get_state())
            assert srv._free == [1] and list(srv._active) == [0]
        for p in PROMPTS[1:]:
            srv.submit(p, 10, stop_tokens=())
        while srv._queue or srv._active:
            srv.step_chunk(4)
        return {i: r.generated for i, r in srv._results.items()}

    warm = drive(sp, True)
    assert warm == drive(sp, False)
    # sampled, not greedy: the streams are not the argmax streams
    assert warm != drive(SamplingParams(greedy=True), False)


def test_serving_needs_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = ModelConfig(**GPTJ_TINY)
    params = random_q4_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, params)
    srv = ServingEngine(cfg, params, max_batch=1, device="cpu")
    assert srv.cache["k"].device.type == "cpu"
    with pytest.raises(ValueError, match="exceeds n_ctx"):
        srv.submit([1, 2, 3], cfg.n_ctx)
