"""The one-dispatch decode chunk: the engines' decode steps on static
device buffers, which the card captures once as a CUDA graph and replays
(engine/graph.py).  On the CPU every step runs eagerly, through the
kernels' plain versions.

  * the device-n_past step (``forward(write_first=True)``: a ragged row
    write, then K3) against the int-n_past step: logits and cache bytes
    bit-identical, int8 / int4 / float32 KV, f32 and bf16 compute, a
    NeoX-like and a GPT-J-like config;
  * the engine's step (the ring write, chunks that wrap the ring) against
    a loop of int-n_past forwards and ``sample_torch``: tokens and cache
    bytes identical, greedy and seeded sampling;
  * the graph-ready InferenceEngine against the JAX engine's greedy
    streams, two requests on one engine (its one cache keeps the first
    request's rows past the second prompt);
  * ``pad_stop_ids`` against the JAX engine's ``_pad_stop_ids``; serving
    streams with 1 and 5 shared stop ids (vector widths 4 and 8) against
    the JAX ServingEngine;
  * ``GraphedStep``'s launch counts, its eager step, capture and
    replays, with a stand-in for the graph; BLOOM's ALiBi
    slopes built once per engine.

Marked ``cuda`` (each skips without a card, decided in its fixture): on
the card, replayed graphs against eager steps for both engines, greedy and
seeded-sampled streams token for token, launch counts with replays.  There
JAX is not installed; the tests that need it skip.
"""

import collections
import gc
import weakref

import numpy as np
import pytest
import torch

from vsim_tpu_torch.engine.generate import InferenceEngine, sampling_kw
from vsim_tpu_torch.engine.graph import GraphedStep
from vsim_tpu_torch.engine.sampling import SamplingParams, sample_torch
from vsim_tpu_torch.engine.serving import ServingEngine, pad_stop_ids
from vsim_tpu_torch.models import transformer
from vsim_tpu_torch.models.config import PRESETS, ModelConfig
from vsim_tpu_torch.models.from_jax import params_from_numpy
from vsim_tpu_torch.models.init import random_q4_params
from vsim_tpu_torch.models.transformer import alibi_slopes, forward
from vsim_tpu_torch.ops import _build

try:  # absent on the card's machine, where only the cuda tests run
    import jax
    import jax.numpy as jnp

    from vsim_tpu.engine import serving as j_serving
    from vsim_tpu.engine.generate import InferenceEngine as JEngine
    from vsim_tpu.engine.sampling import SamplingParams as JSampling
    from vsim_tpu.models.config import ModelConfig as JConfig
    from vsim_tpu.models.init import init_params as j_init_params
    from vsim_tpu.ops.decode_attention import set_decode_kernel
except ImportError:
    jax = None

CONFIGS = {
    "gptj": dict(arch="gptj", n_vocab=1000, n_ctx=64, n_embd=512, n_head=2,
                 n_layer=2, n_ff=1024, n_rot=64, rotary_interleaved=True,
                 shared_layernorm=True, qkv_bias=False, attn_out_bias=False,
                 final_logit_bias=True, activation="gelu_tanh"),
    "neox": dict(arch="gptneox", n_vocab=1000, n_ctx=64, n_embd=256,
                 n_head=4, n_layer=2, n_ff=1024, n_rot=16,
                 activation="gelu_exact"),
}
PROMPT = [5, 17, 301, 44, 999, 0, 12, 250, 7, 63]
SAMPLED = SamplingParams(temperature=0.8, top_k=20, top_p=0.95,
                         repeat_penalty=1.1, repeat_last_n=6, seed=11)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these shapes are tiny, and the test workers
    share the host's cores (with a thread each per core, this file ran
    ~25x slower beside the other workers than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(cache):
    """Every tensor of a cache, as raw bytes."""
    out = []
    for side in ("k", "v"):
        t = cache[side]
        for x in (t if isinstance(t, tuple) else (t,)):
            out.append(x.contiguous().view(torch.uint8))
    return out


def _same_bytes(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def port_model(request):
    cfg = ModelConfig(**CONFIGS[request.param])
    return cfg, random_q4_params(cfg, seed=0, device="cpu")


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv", ["int8", "int4", "float32"])
def test_device_n_past_step_is_bit_identical(port_model, kv, compute):
    """Bit-identical (no tolerance): each step's logits and both caches'
    bytes after it."""
    cfg, params = port_model
    cfg = cfg.replace(compute_dtype=compute)
    eng = InferenceEngine(cfg, params, kv_dtype=kv, device="cpu")
    ids = torch.tensor([PROMPT[:7]])
    ca, cb = eng.new_cache(), eng.new_cache()
    for c in (ca, cb):
        forward(cfg, eng.params, ids, c, 0, fresh_kv=True)
    tok = ids[:, -1:]
    for i in range(6):
        n = 7 + i
        la, _ = forward(cfg, eng.params, tok, ca, n)
        lb, _ = forward(cfg, eng.params, tok, cb,
                        torch.tensor([n], dtype=torch.int32),
                        write_first=True)
        assert torch.equal(la, lb), f"step {i}"
        assert _same_bytes(ca, cb), f"step {i}"
        tok = la[:, -1].argmax(-1, keepdim=True)


def _int_route_stream(cfg, params, kv, prompt, n, sp):
    """The stream as a loop of int-n_past forwards and sample_torch, on a
    fresh cache: (tokens, cache)."""
    eng = InferenceEngine(cfg, params, kv_dtype=kv, device="cpu")
    cache = eng.new_cache()
    logits, _ = forward(cfg, eng.params, torch.tensor([prompt]), cache, 0,
                        fresh_kv=True)
    gen = torch.Generator().manual_seed(sp.seed)
    W = max(sp.repeat_last_n, 1)  # noqa: N806
    last = torch.tensor([([-1] * W + prompt)[-W:]])
    toks = []
    for i in range(n):
        if i:
            logits, _ = forward(cfg, eng.params, tok[:, None], cache,
                                len(prompt) + i - 1)
        tok = sample_torch(logits[:, -1], last, gen, **sampling_kw(sp))
        last = torch.cat([last[:, 1:], tok[:, None]], dim=1)
        toks.append(int(tok))
    return toks, cache


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("kv", ["int8", "int4", "float32"])
def test_engine_step_matches_int_route(port_model, kv, sampled):
    """generate() in chunks of 3 (the ring wraps twice) gives the int
    route's tokens and cache bytes exactly."""
    cfg, params = port_model
    sp = SAMPLED if sampled else SamplingParams(greedy=True, seed=0)
    want, cache = _int_route_stream(cfg, params, kv, PROMPT, 8, sp)
    eng = InferenceEngine(cfg, params, kv_dtype=kv, device="cpu",
                          decode_chunk=3)
    seen = []
    got = eng.generate(PROMPT, 8, sp, streaming_token_hook=seen.append)
    assert got.token_ids == seen == want
    assert _same_bytes(eng.cache, cache)
    st = eng._states[(max(sp.repeat_last_n, 1), 1)]
    assert int(st.n_past) == len(PROMPT) + 7 and int(st.pos) == 7 % 3
    assert all(s.graph is None for s in eng._steps.values())  # CPU: eager


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def jax_model(request):
    if jax is None:
        pytest.skip("needs jax")
    kw = CONFIGS[request.param]
    # std 0.05: large enough that greedy streams do not settle on one token
    params = jax.tree.map(np.asarray, j_init_params(
        JConfig(**kw), seed=0, quantize=True, std=0.05))
    cfg = ModelConfig(**kw)
    return kw, params, cfg, params_from_numpy(cfg, params, device="cpu")


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_graph_ready_engine_matches_jax_engine(jax_model, kv):
    """Greedy streams identical to the JAX engine's (f32 compute; the JAX
    side runs its decode kernel in interpret mode): a long request, then a
    short one on the same engine and cache."""
    kw, jp, cfg, params = jax_model
    prompts = (PROMPT, PROMPT[:3])
    set_decode_kernel("on")
    try:
        jeng = JEngine(JConfig(**kw), jax.tree.map(jnp.asarray, jp),
                       kv_dtype=kv, decode_chunk=16)
        want = [jeng.generate(p, 9, JSampling(greedy=True)).token_ids
                for p in prompts]
    finally:
        set_decode_kernel("auto")
    eng = InferenceEngine(cfg, params, device="cpu", kv_dtype=kv,
                          decode_chunk=4)
    got = [eng.generate(p, 9, SamplingParams(greedy=True)).token_ids
           for p in prompts]
    assert got == want


@pytest.mark.parametrize("n", [0, 1, 4, 5, 9])
def test_pad_stop_ids_matches_jax(n):
    if jax is None:
        pytest.skip("needs jax")
    ids = list(range(100, 100 + n))
    want = np.asarray(j_serving._pad_stop_ids(ids)).tolist()
    assert pad_stop_ids(ids) == want
    assert len(want) == {0: 4, 1: 4, 4: 4, 5: 8, 9: 16}[n]


SERVE_PROMPTS = [[5, 17, 301, 44, 999], [9, 8], [4, 5, 6, 7, 100, 200, 3],
                 [11], [3, 14, 15, 92]]


@pytest.mark.parametrize("n_stops", [1, 5])
def test_serving_fixed_width_stops_match_jax(n_stops):
    """Streams equal to the JAX ServingEngine's with stop ids every request
    shares, which stop slots on the device: one id (vector width 4) and
    five (width 8)."""
    if jax is None:
        pytest.skip("needs jax")
    kw = dict(CONFIGS["gptj"])
    jp = jax.tree.map(np.asarray, j_init_params(
        JConfig(**kw), seed=0, quantize=True, std=0.05))
    cfg = ModelConfig(**kw)
    params = params_from_numpy(cfg, jp, device="cpu")
    srv = ServingEngine(cfg, params, max_batch=2, kv_dtype="int8",
                        device="cpu")
    free = srv.run(SERVE_PROMPTS, 8, stop_tokens=(), chunk_steps=4)
    # ids the streams reach mid-way, plus ones they never do
    stops = [free[i].generated[3] for i in sorted(free)][:n_stops]
    stops += [990, 991, 992, 993][:n_stops - len(stops)]
    set_decode_kernel("on")
    try:
        jsrv = j_serving.ServingEngine(JConfig(**kw, kv_dtype="int8"),
                                       jax.tree.map(jnp.asarray, jp),
                                       max_batch=2)
        jout = jsrv.run(SERVE_PROMPTS, 8, stop_tokens=stops, chunk_steps=4)
    finally:
        set_decode_kernel("auto")
    out = srv.run(SERVE_PROMPTS, 8, stop_tokens=stops, chunk_steps=4)
    got = [out[i].generated for i in sorted(out)]
    assert got == [jout[i].generated for i in sorted(jout)]
    assert any(len(g) < 8 for g in got)  # a stop ended a stream early
    assert srv._stop_ids.shape == (len(pad_stop_ids(set(stops))),)


class StandInGraph:
    """A graph that records its capture and replays: capture runs the step
    once, as capturing a real one enqueues (and counts) its launches."""

    def __init__(self, log):
        self.log = log

    def capture(self, fn):
        self.log.append("capture")
        fn()

    def replay(self):
        self.log.append("replay")


@pytest.fixture
def counts():
    saved = collections.Counter(_build.launch_counts)
    _build.reset_launch_counts()
    yield _build.launch_counts
    _build.reset_launch_counts()
    _build.launch_counts.update(saved)


def test_graphed_step_counts_launches_per_replay(counts):
    def step():
        counts["q4_gemv_ps"] += 3
        counts["decode_attention"] += 2

    counts["flash_attention"] = 1  # a prefill before the capture
    g = GraphedStep(step)
    g.capture(StandInGraph([]))
    assert counts == {"flash_attention": 1}  # capture launched nothing
    assert g.launches == {"q4_gemv_ps": 3, "decode_attention": 2}
    for _ in range(4):
        g()
    assert counts == {"flash_attention": 1, "q4_gemv_ps": 12,
                      "decode_attention": 8}

    def broken():
        counts["q4_gemv_ps"] += 1
        raise RuntimeError("capture failed")

    b = GraphedStep(broken)
    with pytest.raises(RuntimeError, match="capture failed"):
        b.capture(StandInGraph([]))
    assert counts["q4_gemv_ps"] == 12 and b.graph is None  # restored


def test_graphed_step_runs_eager_then_captures_then_replays(counts):
    log = []

    def step():
        log.append("step")
        counts["decode_attention"] += 1

    graphed = GraphedStep(step, lambda: StandInGraph(log))
    for _ in range(3):
        graphed()
    assert log == ["step", "capture", "step", "replay", "replay"]
    assert counts["decode_attention"] == 3  # the eager step and 2 replays
    log.clear()
    eager = GraphedStep(step)
    for _ in range(3):
        eager()
    assert log == ["step"] * 3 and eager.graph is None


def test_alibi_slopes_built_once_per_engine(monkeypatch):
    cfg = PRESETS["bloom-560m"].replace(n_vocab=1000, n_ctx=64, n_embd=256,
                                        n_head=4, n_layer=2, n_ff=512)
    params = random_q4_params(cfg, seed=0, device="cpu")
    eng = InferenceEngine(cfg, params, kv_dtype="int8", device="cpu")
    srv = ServingEngine(cfg, eng.params, max_batch=2, kv_dtype="int8",
                        device="cpu")
    for e in (eng, srv):
        assert torch.equal(e.slopes, alibi_slopes(cfg.n_head))
    want = (eng.generate(PROMPT, 5, SamplingParams(greedy=True)).token_ids,
            srv.run([PROMPT], 5, stop_tokens=())[0].generated)

    def refuse(*a, **k):
        raise AssertionError("forward built the slopes")

    monkeypatch.setattr(transformer, "alibi_slopes", refuse)
    got = (eng.generate(PROMPT, 5, SamplingParams(greedy=True)).token_ids,
           srv.run([PROMPT], 5, stop_tokens=())[1].generated)
    assert got == want


def test_dropped_engines_are_freed_at_once():
    """No reference cycle runs through an engine's steps: a dropped engine
    frees its cache (and on the card its graphs) with the cyclic collector
    off; a graph that a collection frees during another graph's capture
    invalidates that capture."""
    cfg = ModelConfig(**CONFIGS["neox"])
    params = random_q4_params(cfg, device="cpu")
    enabled = gc.isenabled()
    gc.disable()
    try:
        eng = InferenceEngine(cfg, params, kv_dtype="int8", device="cpu")
        eng.generate(PROMPT, 4, SamplingParams(greedy=True))
        srv = ServingEngine(cfg, eng.params, max_batch=2, kv_dtype="int8",
                            device="cpu")
        srv.run([PROMPT], 4, stop_tokens=())
        assert eng._steps and srv._steps
        refs = [weakref.ref(x) for x in (eng, eng.cache["k"][0], srv,
                                         srv.cache["k"][0])]
        del eng, srv
        assert all(r() is None for r in refs)
    finally:
        if enabled:
            gc.enable()


def test_cuda_graph_needs_a_card():
    cfg = ModelConfig(**CONFIGS["neox"])
    params = random_q4_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="cuda_graph needs a CUDA device"):
        InferenceEngine(cfg, params, device="cpu", cuda_graph=True)
    with pytest.raises(ValueError, match="cuda_graph needs a CUDA device"):
        ServingEngine(cfg, params, device="cpu", cuda_graph=True)


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_model():
    cfg = ModelConfig(**CONFIGS["gptj"]).replace(compute_dtype="bfloat16",
                                                 n_ctx=128)
    return cfg, random_q4_params(cfg, seed=1, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_inference_replay_equals_eager_on_card(card, kv):
    cfg, params = _card_model()
    graphed = InferenceEngine(cfg, params, kv_dtype=kv, decode_chunk=5)
    eager = InferenceEngine(cfg, graphed.params, kv_dtype=kv,
                            decode_chunk=5, cuda_graph=False)
    greedy = SamplingParams(greedy=True)
    for prompt in (PROMPT, PROMPT[:3]):
        runs = {}
        for name, eng in (("graphed", graphed), ("eager", eager)):
            _build.reset_launch_counts()
            toks = eng.generate(prompt, 12, greedy).token_ids
            runs[name] = (toks, dict(_build.launch_counts))
        assert runs["graphed"] == runs["eager"]
        assert runs["eager"][1]["decode_attention"] == 11 * cfg.n_layer
    a = graphed.generate(PROMPT, 12, SAMPLED).token_ids
    assert a == graphed.generate(PROMPT, 12, SAMPLED).token_ids
    assert a == eager.generate(PROMPT, 12, SAMPLED).token_ids
    assert all(s.graph is not None for s in graphed._steps.values())
    assert all(s.graph is None for s in eager._steps.values())


@pytest.mark.cuda
@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_serving_replay_equals_eager_on_card(card, kv, sampled):
    """Greedy, or sampled from seed 7: warmup() (which captures the step
    and restores the registered generator's state) changes nothing."""
    cfg, params = _card_model()
    sp = SAMPLED if sampled else None
    runs = {}
    for graphed in (True, False):
        srv = ServingEngine(cfg, params, max_batch=2, kv_dtype=kv,
                            sampling=sp, seed=7, cuda_graph=graphed)
        state = [t.clone() for t in (srv.tokens, srv.n_past,
                                     srv.last_tokens)]
        srv.warmup()
        assert all(torch.equal(a, b) for a, b in zip(
            state, (srv.tokens, srv.n_past, srv.last_tokens)))
        assert all((s.graph is not None) == graphed
                   for s in srv._steps.values())
        _build.reset_launch_counts()
        out = srv.run(SERVE_PROMPTS, 8, stop_tokens=(), chunk_steps=4)
        runs[graphed] = ([out[i].generated for i in sorted(out)],
                         dict(_build.launch_counts))
    assert runs[True] == runs[False]
    assert runs[True][1]["scatter_rows"] > 0
