"""Port vs JAX package: speculative decoding (engine/speculative.py) on the
tiny configs of tests/test_speculative.py, f32 compute, params carried
across by models/from_jax.py.

  * the six cases of tests/test_speculative.py (self-draft, a weak draft,
    the n-gram draft, n-gram acceptance on a repetitive stream, the stop
    token trim, gamma = 1): the port's stream equals the JAX
    SpeculativeEngine's and the port's plain greedy InferenceEngine's,
    token for token; ``cycles`` and ``tokens_per_cycle`` equal the JAX
    engine's once the draft cache's prefill is padded as the JAX engine
    pads it (``_jax_padded_draft_prefill``: see there);
  * a D = 128 target with int8 KV, where the plain step's decode kernel
    rounds q to bf16 and the verify's einsum does not (the JAX side runs
    its decode kernel in interpret mode): the port's stream equals the JAX
    engine's;
  * ``NgramDrafter.propose`` against the JAX function on seeded histories:
    ragged n_past, m = 2 and 3, matches near position 0 and near n_past;
  * the cycle captured with a stand-in graph gives the eager cycle's bits.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vsim_tpu_torch.engine.generate import InferenceEngine
from vsim_tpu_torch.engine.sampling import SamplingParams
from vsim_tpu_torch.engine.speculative import (
    ModelDrafter,
    NgramDrafter,
    SpeculativeEngine,
)
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.models.from_jax import params_from_numpy
from vsim_tpu_torch.models.transformer import forward

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vsim_tpu.engine import speculative as j_spec  # noqa: E402
from vsim_tpu.models.config import ModelConfig as JConfig  # noqa: E402
from vsim_tpu.models.init import init_params as j_init_params  # noqa: E402
from vsim_tpu.ops.decode_attention import set_decode_kernel  # noqa: E402

CFG = dict(arch="gptneox", n_vocab=128, n_ctx=128, n_embd=64, n_head=4,
           n_layer=2, n_ff=128, n_rot=8)
DRAFT_CFG = dict(arch="gptneox", n_vocab=128, n_ctx=128, n_embd=32,
                 n_head=2, n_layer=1, n_ff=64, n_rot=8)
# D = 128: the one-token decode kernel's route (q rounded to bf16)
CFG_D128 = dict(arch="gptneox", n_vocab=128, n_ctx=128, n_embd=256,
                n_head=2, n_layer=2, n_ff=256, n_rot=32, kv_dtype="int8")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the shapes are tiny and the test workers share
    the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(kw, jparams):
    """(JAX config, JAX params, port config, port params)."""
    cfg = ModelConfig(**kw)
    tree = jax.tree.map(np.asarray, jparams)
    return JConfig(**kw), jparams, cfg, params_from_numpy(cfg, tree,
                                                         device="cpu")


@pytest.fixture(scope="module")
def target():
    return _both(CFG, j_init_params(JConfig(**CFG), seed=0, quantize=True,
                                    scale_dtype=np.float32))


@pytest.fixture(scope="module")
def weak():
    return _both(DRAFT_CFG, j_init_params(JConfig(**DRAFT_CFG), seed=7,
                                          quantize=False))


@pytest.fixture(scope="module")
def plain(target):
    return InferenceEngine(target[2], target[3], device="cpu")


def _greedy(eng, prompt, n):
    return eng.generate(prompt, n, SamplingParams(greedy=True)).token_ids


# (drafter: "self", "weak" or "ngram", gamma, m, prompt, n_predict, stop
# index into the plain stream or None)
CASES = {
    "self_draft": ("self", 3, None, [1, 2, 3, 4, 5], 16, None),
    "weak_draft": ("weak", 4, None, [9, 8, 7], 12, None),
    "ngram_exact": ("ngram", 4, 2, [5, 6, 7, 5, 6, 7, 5, 6], 16, None),
    "ngram_repetitive": ("ngram", 4, 2, [3, 3, 3, 3], 32, None),
    "eos_trim": ("self", 2, None, [1, 2], 20, 5),
    "gamma_one": ("self", 1, None, [11, 12, 13], 9, None),
}


def _drafters(kind, gamma, m, target, weak):
    """(JAX drafter, port drafter) of one kind."""
    if kind == "ngram":
        return j_spec.NgramDrafter(m=m, gamma=gamma), NgramDrafter(m, gamma)
    jc, jp, cfg, p = target if kind == "self" else weak
    return (j_spec.ModelDrafter(jc, jp, gamma=gamma),
            ModelDrafter(cfg, p, gamma=gamma))


def _jax_padded_draft_prefill(monkeypatch):
    """Prefill a ModelDrafter's cache as the JAX engine does: the prompt
    padded with token 0 to a power of two >= 16.  The engine prefills at
    the prompt's own length, and the streams do not depend on it; the
    acceptance counts do.  After a cycle that accepts every draft, the
    draft cache's row of d_gamma (never fed to the drafter) is attended
    unwritten by the next cycle: zeros in the port, the pad token's k/v in
    the JAX engine when the row lies inside its padded prompt."""
    def prefill(self, state, ids):
        T = 16  # noqa: N806
        while T < ids.shape[1]:
            T *= 2  # noqa: N806
        forward(self.cfg, self.params, F.pad(ids, (0, T - ids.shape[1])),
                state, 0, fresh_kv=True, slopes=self.slopes)

    monkeypatch.setattr(ModelDrafter, "prefill", prefill)


@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_matches_jax_and_plain(case, target, weak, plain,
                                      monkeypatch):
    kind, gamma, m, prompt, n, stop_at = CASES[case]
    jc, jp, cfg, params = target
    jd, pd = _drafters(kind, gamma, m, target, weak)
    want_plain = _greedy(plain, prompt, n)
    stops = () if stop_at is None else (want_plain[stop_at],)
    jres = j_spec.SpeculativeEngine(jc, jp, jd).generate(
        prompt, n_predict=n, stop_tokens=stops)
    eng = SpeculativeEngine(cfg, params, pd, device="cpu")
    res = eng.generate(prompt, n, stop_tokens=stops)
    if stop_at is not None:
        want_plain = want_plain[:want_plain.index(stops[0]) + 1]
    assert res.token_ids == jres.token_ids == want_plain
    assert all(s.graph is None for s in eng._steps.values())  # CPU: eager
    _jax_padded_draft_prefill(monkeypatch)
    padded = eng.generate(prompt, n, stop_tokens=stops)
    assert padded.token_ids == want_plain
    assert (padded.cycles, padded.tokens_per_cycle) == (
        jres.cycles, jres.tokens_per_cycle)
    if case == "self_draft":  # self-draft: most drafts land
        assert res.tokens_per_cycle > gamma * 0.9
    if case == "ngram_repetitive":
        assert len(res.token_ids) == n and res.cycles >= 1
    if kind == "ngram":  # no draft cache: nothing padded
        assert (res.cycles, res.tokens_per_cycle) == (
            jres.cycles, jres.tokens_per_cycle)


def test_d128_int8_matches_jax(monkeypatch):
    """At D = 128 the plain one-token step rounds q to bf16 in its decode
    kernel and the verify's einsum keeps q in f32, in either package: the
    speculative streams must agree across the packages."""
    jc, jp, cfg, params = _both(CFG_D128, j_init_params(
        JConfig(**CFG_D128), seed=0, quantize=True, std=0.05))
    prompt, n = [7, 3, 9, 7, 3, 9, 7, 3], 24
    set_decode_kernel("on")
    try:
        jres = j_spec.SpeculativeEngine(
            jc, jp, j_spec.ModelDrafter(jc, jp, gamma=3)).generate(prompt, n)
    finally:
        set_decode_kernel("auto")
    eng = SpeculativeEngine(cfg, params, ModelDrafter(cfg, params, gamma=3),
                            device="cpu")
    assert eng.generate(prompt, n).token_ids == jres.token_ids
    _jax_padded_draft_prefill(monkeypatch)
    res = eng.generate(prompt, n)
    assert (res.token_ids, res.cycles) == (jres.token_ids, jres.cycles)


NGRAM_CASES = [  # (m, seed, n_past per row)
    (2, 0, [1, 2, 9, 30]),
    (3, 1, [0, 3, 17, 31]),
    (3, 2, [31, 31, 5, 2]),
    (2, 3, [4, 12, 31, 8]),
]


@pytest.mark.parametrize("m,seed,n_past", NGRAM_CASES)
def test_ngram_propose_matches_jax(m, seed, n_past):
    """Small alphabets make matches common: near position 0 (a suffix
    position below 0 reads as -2), near n_past (a proposal past n_past
    repeats cur), and several occurrences (the most recent wins)."""
    rng = np.random.default_rng(seed)
    B, S, gamma = len(n_past), 32, 4  # noqa: N806
    hist = np.full((B, S), -1, np.int32)
    for b, n in enumerate(n_past):
        hist[b, :n] = rng.integers(0, 3, n)
    cur = rng.integers(0, 3, B).astype(np.int32)
    npv = np.asarray(n_past, np.int32)
    want, _ = j_spec.NgramDrafter(m=m, gamma=gamma).propose(
        None, jnp.zeros((), jnp.int32), jnp.asarray(cur), jnp.asarray(hist),
        jnp.asarray(npv), S)
    got = NgramDrafter(m, gamma).propose(
        None, torch.from_numpy(cur).long(), torch.from_numpy(hist),
        torch.from_numpy(npv))
    assert got.tolist() == np.asarray(want).tolist()


class StandInGraph:
    """Capture runs the cycle once (as capturing a real graph enqueues its
    kernels); replay runs the captured function again."""

    def __init__(self, log):
        self.log, self.fn = log, None

    def capture(self, fn):
        self.log.append("capture")
        self.fn = fn

    def replay(self):
        self.log.append("replay")
        self.fn()


@pytest.mark.parametrize("kind", ["self", "ngram"])
def test_captured_cycle_matches_eager(kind, target):
    """The cycle replayed through ``GraphedStep`` (a stand-in graph on the
    CPU) leaves the eager cycle's buffers and caches, bit for bit, and
    counts its launches per replay."""
    _, _, cfg, params = target
    cfg = cfg.replace(kv_dtype="int8")
    prompt = [3, 4, 5, 3, 4, 5, 3]
    runs, log = [], []
    for graphed in (False, True):
        drafter = (NgramDrafter(2, 3) if kind == "ngram"
                   else ModelDrafter(cfg, params, gamma=3))
        eng = SpeculativeEngine(cfg, params, drafter, device="cpu")
        if graphed:
            eng._make_graph = lambda: StandInGraph(log)
        step = eng.start(prompt)
        for _ in range(5):
            step()
        st = eng.state
        runs.append([t.clone() for t in (
            st.cur, st.n_past, st.history, st.ring, st.pos,
            *eng.cache["k"], *eng.cache["v"])])
    assert log == ["capture"] + ["replay"] * 4
    assert all(torch.equal(a, b) for a, b in zip(*runs))

