"""InferenceEngine's batched internals, port vs JAX package, on tiny
GPT-J- and NeoX-shaped models (2 layers, narrow widths), numpy params from
seed 0, a distinct prompt in every row:

  * ``_prefill`` [B, T] + ``_decode_many`` over B rows give the JAX
    engine's ``_prefill`` + ``_decode_many`` tokens [n_steps, B] exactly at
    f32 compute, B = 3 and 12, int8 / int4 / f32 KV, greedy (the JAX side
    runs its decode kernel in interpret mode, which rounds q to bf16 where
    D % 128 == 0 as K3 and its plain version do);
  * at bf16 compute the prefill logits agree within
    tests/test_torch_engine.py's tolerance (0.01 of max|logit|);
  * at f32 each batched row is the port's own B=1 ``generate`` stream;
  * with a stand-in graph, a step captured for B = 12 is never replayed
    for B = 3, and a cache at other addresses is captured anew.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsim_tpu.engine.generate import InferenceEngine as JEngine
from vsim_tpu.models.config import ModelConfig as JConfig
from vsim_tpu.models.init import init_params as j_init_params
from vsim_tpu.ops.decode_attention import set_decode_kernel
from vsim_tpu_torch.engine import generate as generate_mod
from vsim_tpu_torch.engine.generate import InferenceEngine
from vsim_tpu_torch.engine.sampling import SamplingParams
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.models.from_jax import params_from_numpy

CONFIGS = {
    "gptj": dict(arch="gptj", n_vocab=1000, n_ctx=64, n_embd=512, n_head=2,
                 n_layer=2, n_ff=1024, n_rot=64, rotary_interleaved=True,
                 shared_layernorm=True, qkv_bias=False, attn_out_bias=False,
                 final_logit_bias=True, activation="gelu_tanh"),
    "neox": dict(arch="gptneox", n_vocab=1000, n_ctx=64, n_embd=256,
                 n_head=4, n_layer=2, n_ff=1024, n_rot=16,
                 activation="gelu_exact"),
}
T_PROMPT, N_STEPS, W = 7, 6, 64
GREEDY = dict(top_k=1, top_p=1.0, temperature=1.0, repeat_penalty=1.0,
              greedy=True)


def prompts(B):  # noqa: N803
    rng = np.random.default_rng(100 + B)
    return rng.integers(0, 1000, size=(B, T_PROMPT)).astype(np.int64)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these shapes are tiny, and the test workers
    share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    kw = CONFIGS[request.param]
    # std 0.05: large enough that greedy streams do not settle on one token
    params = jax.tree.map(np.asarray, j_init_params(
        JConfig(**kw), seed=0, quantize=True, std=0.05))
    return kw, params


def jax_batched(kw, params, ids, kv, compute="float32"):
    jc = JConfig(**kw, compute_dtype=compute)
    B = ids.shape[0]  # noqa: N806
    set_decode_kernel("on")
    try:
        eng = JEngine(jc, jax.tree.map(jnp.asarray, params), kv_dtype=kv)
        cache = eng.new_cache(B)
        logits, cache = eng._prefill(eng.params, jnp.asarray(ids, jnp.int32),
                                     cache, 0, kv_len=T_PROMPT)
        tok = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)
        toks, *_ = eng._decode_many(
            eng.params, tok, cache, T_PROMPT, jnp.full((B, W), -1, jnp.int32),
            jax.random.PRNGKey(0), n_steps=N_STEPS,
            kv_len=eng.kv_bucket(T_PROMPT + N_STEPS + 1), **GREEDY)
        return np.asarray(logits), np.asarray(tok), np.asarray(toks)
    finally:
        set_decode_kernel("auto")


def port_batched(eng, ids):
    B = ids.shape[0]  # noqa: N806
    cache = eng.new_cache(B)
    logits, _ = eng._prefill(torch.from_numpy(ids), cache)
    tok = logits[:, -1, :].argmax(-1)
    last = torch.full((B, W), -1, dtype=torch.long)
    toks = eng._decode_many(tok, cache, T_PROMPT, last, N_STEPS,
                            SamplingParams(greedy=True))
    return logits.numpy(), tok.numpy(), toks.numpy(), last


@pytest.mark.parametrize("kv", ["int8", "int4", "float32"])
@pytest.mark.parametrize("B", [3, 12])
def test_batched_tokens_match_jax_engine(model, kv, B):  # noqa: N803
    kw, params = model
    cfg = ModelConfig(**kw)
    ids = prompts(B)
    _, jtok, jtoks = jax_batched(kw, params, ids, kv)
    eng = InferenceEngine(cfg, params_from_numpy(cfg, params, device="cpu"),
                          kv_dtype=kv, device="cpu")
    _, tok, toks, last = port_batched(eng, ids)
    assert toks.shape == (N_STEPS, B) and toks.dtype == np.int64
    np.testing.assert_array_equal(tok, jtok)
    np.testing.assert_array_equal(toks, jtoks)
    # the window, updated in place, ends with the last W - 1 tokens
    np.testing.assert_array_equal(last[:, -N_STEPS:].numpy(), toks.T)
    assert len(set(map(tuple, toks.T))) > 1  # the rows differ


def test_bf16_prefill_logits_within_tolerance(model):
    kw, params = model
    cfg = ModelConfig(**kw, compute_dtype="bfloat16")
    ids = prompts(12)
    ref, _, _ = jax_batched(kw, params, ids, "int8", compute="bfloat16")
    eng = InferenceEngine(cfg, params_from_numpy(cfg, params, device="cpu"),
                          kv_dtype="int8", device="cpu")
    got, _, toks, _ = port_batched(eng, ids)
    assert got.shape == ref.shape == (12, T_PROMPT, 1000)
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 0.01 * np.abs(ref).max()
    assert ((toks >= 0) & (toks < 1000)).all()


@pytest.mark.parametrize("kv", ["int8", "int4", "float32"])
def test_batched_rows_equal_b1_generate(model, kv):
    kw, params = model
    cfg = ModelConfig(**kw)
    ids = prompts(12)
    eng = InferenceEngine(cfg, params_from_numpy(cfg, params, device="cpu"),
                          kv_dtype=kv, device="cpu", decode_chunk=4)
    _, tok, toks, _ = port_batched(eng, ids)
    for b in range(12):
        want = eng.generate(list(ids[b]), N_STEPS + 1,
                            SamplingParams(greedy=True)).token_ids
        assert [int(tok[b])] + list(toks[:, b]) == want


def test_decode_many_continues_where_it_stopped(model):
    """Two calls of 3 steps give one call's 6 tokens: the window and the
    cache carry over, the ring restarts."""
    kw, params = model
    cfg = ModelConfig(**kw)
    ids = prompts(3)
    eng = InferenceEngine(cfg, params_from_numpy(cfg, params, device="cpu"),
                          kv_dtype="int8", device="cpu")
    _, tok, toks, _ = port_batched(eng, ids)
    cache = eng.new_cache(3)
    logits, _ = eng._prefill(torch.from_numpy(ids), cache)
    t0 = logits[:, -1].argmax(-1)
    last = torch.full((3, W), -1, dtype=torch.long)
    sp = SamplingParams(greedy=True)
    a = eng._decode_many(t0, cache, T_PROMPT, last, 3, sp)
    b = eng._decode_many(a[-1], cache, T_PROMPT + 3, last, 3, sp)
    np.testing.assert_array_equal(torch.cat([a, b]).numpy(), toks)
    with pytest.raises(ValueError, match="exceeds n_ctx"):
        eng._decode_many(t0, cache, cfg.n_ctx - 2, last, 3, sp)


class StandInGraph:
    """Records its capture and replays; capture runs the step once."""

    def __init__(self, log, key):
        self.log, self.key = log, key

    def capture(self, fn):
        self.log.append(("capture", self.key))
        fn()

    def replay(self):
        self.log.append(("replay", self.key))


def test_graph_keys_include_batch(model):
    """A step captured for B = 12 is never replayed for B = 3 (nor the
    other way); a cache at other addresses, or a call longer than the
    ring, captures anew."""
    kw, params = model
    cfg = ModelConfig(**kw)
    eng = InferenceEngine(cfg, params_from_numpy(cfg, params, device="cpu"),
                          kv_dtype="int8", device="cpu")
    log, made = [], collections.Counter()

    def make():
        made["graphs"] += 1
        return StandInGraph(log, made["graphs"])

    eng._make_graph = make
    sp = SamplingParams(greedy=True)

    def run(B, cache, n):  # noqa: N803
        log.clear()
        tok = torch.zeros(B, dtype=torch.long)
        last = torch.full((B, W), -1, dtype=torch.long)
        eng._decode_many(tok, cache, T_PROMPT, last, n, sp)
        return list(log)

    c12, c3 = eng.new_cache(12), eng.new_cache(3)
    assert run(12, c12, 3) == [("capture", 1), ("replay", 1), ("replay", 1)]
    assert run(3, c3, 3) == [("capture", 2), ("replay", 2), ("replay", 2)]
    assert run(12, c12, 3) == [("replay", 1)] * 3
    assert run(3, c3, 2) == [("replay", 2)] * 2
    keys = sorted(k[-1] for k in eng._steps)
    assert keys == [3, 12]
    # another cache of 12 rows: its graph is captured anew
    other = eng.new_cache(12)
    assert generate_mod.cache_addresses(other) != \
        generate_mod.cache_addresses(c12)
    assert run(12, other, 3) == [("capture", 3), ("replay", 3),
                                 ("replay", 3)]
    # more steps than the ring holds: a new ring and a new capture
    assert run(12, other, 5)[0] == ("capture", 4)
    assert run(3, c3, 3) == [("replay", 2)] * 3  # B = 3 kept its graph
