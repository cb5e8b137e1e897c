"""Port vs JAX package: speculative serving (the ServingEngine drafter hook,
engine/serving.py) on the tiny NeoX config of tests/test_serving.py, f32
compute and KV, params carried across by models/from_jax.py.

  * the two speculative cases of tests/test_serving.py (four prompts on
    four slots; five prompts on two slots, with slot reuse and mid-flight
    admission): streams equal to the JAX speculative ServingEngine's and
    to the port's plain serving streams, and more tokens than target
    forwards (``spec_emitted > spec_cycles``);
  * an int8 cache with a slot near n_ctx: the room check falls back to
    plain one-token steps, and the streams still equal the JAX engine's and
    the port's plain ones;
  * a ModelDrafter, or sampling that is not greedy, is refused;
  * ``warmup()``'s all-inactive speculative step changes no slot.
"""

import numpy as np
import pytest
import torch

from vsim_tpu_torch.engine.sampling import SamplingParams
from vsim_tpu_torch.engine.serving import ServingEngine
from vsim_tpu_torch.engine.speculative import ModelDrafter, NgramDrafter
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.models.from_jax import params_from_numpy

jax = pytest.importorskip("jax")

from vsim_tpu.engine import speculative as j_spec  # noqa: E402
from vsim_tpu.engine.serving import ServingEngine as JServing  # noqa: E402
from vsim_tpu.models.config import ModelConfig as JConfig  # noqa: E402
from vsim_tpu.models.init import init_params as j_init_params  # noqa: E402

CFG = dict(arch="gptneox", n_vocab=160, n_ctx=96, n_embd=64, n_head=4,
           n_layer=2, n_ff=128, n_rot=8, kv_dtype="float32",
           compute_dtype="float32")

# (prompts, n_predict, max_batch, m, gamma, kv dtype, n_ctx)
CASES = {
    "matches_plain": ([[1, 2, 3], [7, 8, 9, 10, 11], [42], [5, 4, 3, 2]],
                      16, 4, 2, 4, "float32", 96),
    "staggered": ([[1, 2, 3], [9, 8, 7], [11, 12], [4], [6, 5, 4, 3]],
                  10, 2, 2, 3, "float32", 96),
    # the third prompt leaves that slot no room for a full gamma + 1
    # advance near its end: plain one-token steps take over
    "room_fallback": ([[1, 2, 3], [7, 8, 9, 10, 11], list(range(30, 74))],
                      20, 3, 2, 4, "int8", 64),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jparams():
    return j_init_params(JConfig(**CFG), seed=3, quantize=True)


def _port(jparams, **kw):
    cfg = ModelConfig(**dict(CFG, **kw))
    return cfg, params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                  device="cpu")


def _streams(out):
    return [r.generated for r in sorted(out.values(),
                                        key=lambda r: r.request_id)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_spec_serving_matches_jax_and_plain(case, jparams):
    prompts, n, B, m, gamma, kv, n_ctx = CASES[case]  # noqa: N806
    jsrv = JServing(JConfig(**dict(CFG, kv_dtype=kv, n_ctx=n_ctx)), jparams,
                    max_batch=B, drafter=j_spec.NgramDrafter(m=m,
                                                             gamma=gamma))
    want = _streams(jsrv.run(prompts, n_predict=n, stop_tokens=()))
    cfg, params = _port(jparams, kv_dtype=kv, n_ctx=n_ctx)
    plain = ServingEngine(cfg, params, max_batch=B, device="cpu")
    want_plain = _streams(plain.run(prompts, n, stop_tokens=()))
    srv = ServingEngine(cfg, plain.params, max_batch=B, device="cpu",
                        drafter=NgramDrafter(m, gamma))
    got = _streams(srv.run(prompts, n, stop_tokens=()))
    assert got == want == want_plain
    assert srv.spec_cycles > 0
    assert srv.spec_emitted > srv.spec_cycles, (srv.spec_emitted,
                                                srv.spec_cycles)
    assert (srv.spec_cycles, srv.spec_emitted) == (jsrv.spec_cycles,
                                                   jsrv.spec_emitted)
    assert sorted(srv._free) == list(range(B)) and not srv._active
    if case == "room_fallback":  # the tight slot took plain steps
        assert srv.spec_emitted < sum(len(g) - 1 for g in got)


def test_step_chunk_takes_one_spec_step(jparams):
    """``step_chunk`` under a drafter is one speculative step: each slot
    gains between 1 and gamma + 1 tokens."""
    cfg, params = _port(jparams)
    srv = ServingEngine(cfg, params, max_batch=2, device="cpu",
                        drafter=NgramDrafter(2, 3))
    a = srv.submit([5, 6, 5, 6, 5], 30, stop_tokens=())
    b = srv.submit([1, 2, 3], 30, stop_tokens=())
    srv.step_chunk(8)  # admission (one token each), then one spec step
    reqs = {r.request_id: r for r in srv._active.values()}
    assert all(2 <= len(reqs[i].generated) <= 5 for i in (a, b))
    assert srv.spec_cycles == 1


def test_drafter_contract(jparams):
    cfg, params = _port(jparams)
    with pytest.raises(ValueError, match="NgramDrafter"):
        ServingEngine(cfg, params, max_batch=2, device="cpu",
                      drafter=ModelDrafter(cfg, params, gamma=2))
    with pytest.raises(ValueError, match="greedy"):
        ServingEngine(cfg, params, max_batch=2, device="cpu",
                      sampling=SamplingParams(), drafter=NgramDrafter())


def test_warmup_spec_step_changes_nothing(jparams):
    cfg, params = _port(jparams, kv_dtype="int8")
    srv = ServingEngine(cfg, params, max_batch=2, device="cpu",
                        drafter=NgramDrafter(2, 3))
    srv.submit([1, 2, 3], 10, stop_tokens=())
    srv.step()  # one slot busy beside the warm-up
    S = srv.n_ctx  # noqa: N806  (column S is the history's write sink)
    state = [t.clone() for t in (srv.tokens, srv.n_past, srv.history[:, :S],
                                 *srv.cache["k"], *srv.cache["v"])]
    srv.warmup()
    after = (srv.tokens, srv.n_past, srv.history[:, :S], *srv.cache["k"],
             *srv.cache["v"])
    assert all(torch.equal(x, y) for x, y in zip(state, after))
    assert srv._spec_steps and srv.spec_cycles == 1
