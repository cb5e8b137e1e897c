"""Port vs JAX package: serving slots over a mesh's data axis, speculative
serving under a mesh, GSPMD's replicate-and-gather where a shard would cut
a Q4 block, and sequence parallelism at any T.  Ranks are processes over
gloo on the CPU (tests/torch_parallel_worker.py); the JAX references run
here on conftest's 8 virtual devices, at the same meshes.

  * ``ServingEngine(mesh=)`` at (2, 1) and (2, 2), int8 and float32 KV, on
    tests/test_serving.py's model (E = 64) and its sharded test's prompts,
    and its staggered-admission / slot-reuse scenario (5 prompts on 2
    slots): every rank's greedy streams equal the JAX
    ``ServingEngine(mesh=)``'s and the port's single-device engine's, and
    each chunk's ring is exchanged over the data axis;
  * a sampled stream from one seed is the same at d = 2 as on one device;
  * speculative serving (``NgramDrafter(2, 4)``, tests/test_serving.py's
    speculative prompts) at (1, 2), (2, 1), (2, 2) and (1, 4): streams,
    ``spec_cycles`` and ``spec_emitted`` equal the JAX engine's;
  * that model at (1, 4), tests/test_serving.py:91's sharded test, where
    ``wo``'s packed bytes split over 4 ranks and its 32-row scale blocks
    do not (held whole, its input gathered): streams equal that test's;
  * forward logits with a plane-split ``wo`` (held whole: its bytes are
    not a K slice) at tp = 2 and 4, and with a vocabulary of 250 (lm head
    and ``wte`` held whole) at tp = 4, within 1e-5 of max|logit| of the
    JAX sharded forward.  The plane-split case is held to the JAX sharded
    forward of the same weights in the interleaved layout: the JAX
    ``shard_params`` refuses a plane-split leaf (its spec tree carries the
    "i" layout), and the JAX stacked forward reads a stacked plane-split
    weight as interleaved (vsim_tpu/ops/matmul.py:119-124 drops the
    layout; ROADMAP.md "Watch items");
  * sequence parallelism at T = 13 and T = 6 over 2 and 4 ranks within
    1e-5 of max|logit| of the JAX ``rules={"seq": "model"}`` forward, and
    a prefill at T = 13 that writes the same cache as one device's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parallel_worker import launch, result, save_tree
from vsim_tpu.engine.serving import ServingEngine as JServing
from vsim_tpu.engine.speculative import NgramDrafter as JNgram
from vsim_tpu.models.config import ModelConfig as JConfig
from vsim_tpu.models.init import init_params as j_init_params
from vsim_tpu.models.transformer import forward as j_forward
from vsim_tpu.parallel import context as jctx
from vsim_tpu.parallel.mesh import make_mesh as j_make_mesh
from vsim_tpu.parallel.sharding import shard_params as j_shard_params
from vsim_tpu.quant.q4 import to_plane_split as j_to_plane_split
from vsim_tpu_torch.engine.sampling import SamplingParams
from vsim_tpu_torch.engine.serving import ServingEngine
from vsim_tpu_torch.engine.speculative import NgramDrafter
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.models.from_jax import params_from_numpy
from vsim_tpu_torch.models.transformer import forward, init_cache

# tests/test_serving.py's model and scenarios
CFG = dict(arch="gptneox", n_vocab=160, n_ctx=96, n_embd=64, n_head=4,
           n_layer=2, n_ff=128, n_rot=8, kv_dtype="float32",
           compute_dtype="float32")
PROMPTS = [[1, 2, 3], [7, 8, 9, 10, 11], [42]]
STAGGER = [[1, 2, 3], [9, 8], [4, 5, 6, 7], [11], [3, 14, 15]]
SPEC = [[1, 2, 3], [7, 8, 9, 10, 11], [42], [5, 4, 3, 2]]
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.95, repeat_penalty=1.1)
KVS = ("int8", "float32")
TOL = 1e-5  # of max|logit|: the two packages' sum orders
AXES = ["data", "model"]

# name -> (mesh, kv, prompts, n, max_batch, drafter, sampled)
SERVE = {
    "d2_int8": ((2, 1), "int8", PROMPTS, 8, 4, None, False),
    "d2_float32": ((2, 1), "float32", PROMPTS, 8, 4, None, False),
    "d22_int8": ((2, 2), "int8", PROMPTS, 8, 4, None, False),
    "d22_float32": ((2, 2), "float32", PROMPTS, 8, 4, None, False),
    "d2_stagger": ((2, 1), "float32", STAGGER, 6, 2, None, False),
    "d22_stagger": ((2, 2), "int8", STAGGER, 6, 2, None, False),
    "e64_tp4": ((1, 4), "float32", PROMPTS, 8, 4, None, False),
    "spec_12": ((1, 2), "float32", SPEC, 16, 4, (2, 4), False),
    "spec_21": ((2, 1), "float32", SPEC, 16, 4, (2, 4), False),
    "spec_22": ((2, 2), "float32", SPEC, 16, 4, (2, 4), False),
    "spec_14": ((1, 4), "float32", SPEC, 16, 4, (2, 4), False),
    "d2_sampled": ((2, 1), "int8", PROMPTS, 10, 4, None, True),
}
# name -> (mesh, T, rules, variant)
FORWARD = {
    "sp2_t13": ((1, 2), 13, {"seq": "model"}, None),
    "sp2_t6": ((1, 2), 6, {"seq": "model"}, None),
    "sp4_t13": ((1, 4), 13, {"seq": "model"}, None),
    "sp4_t6": ((1, 4), 6, {"seq": "model"}, None),
    "ps_tp2": ((1, 2), 8, None, "ps"),
    "ps_tp4": ((1, 4), 8, None, "ps"),
    "vocab_tp4": ((1, 4), 8, None, "vocab"),
}


def _world(shape):
    return shape[0] * shape[1]


def _ids(T):  # noqa: N803
    row = (np.arange(T) * 7 + 3) % CFG["n_vocab"]
    return np.stack([row, row[::-1]]).astype(np.int64)


def _variant_cfg(variant):
    return dict(CFG, n_vocab=250) if variant == "vocab" else CFG


def _jax_params(variant):
    p = j_init_params(JConfig(**_variant_cfg(variant)),
                      seed=5 if variant == "vocab" else 3, quantize=True)
    if variant == "ps":
        p = dict(p, layers=dict(p["layers"],
                                wo=j_to_plane_split(p["layers"]["wo"])))
    return p


def _jax_forward(cfg, params, ids, shape, rules):
    """The JAX sharded forward (cache-free) on the first devices."""
    mesh = j_make_mesh(shape, devices=jax.devices()[:_world(shape)])
    sharded = j_shard_params(params, mesh)
    with jctx.use_mesh(mesh, rules):
        fn = jax.jit(lambda p, t: j_forward(cfg, p, t, None, 0)[0])
        return np.asarray(fn(sharded, jnp.asarray(ids, jnp.int32)))


def _streams(out, n):
    return [out[i].generated for i in range(n)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel_data")
    files = {}
    for variant in (None, "ps", "vocab"):
        files[variant] = str(d / f"params_{variant}.npz")
        save_tree(files[variant], jax.tree.map(np.asarray,
                                               _jax_params(variant)))
    jobs = {2: [], 4: []}
    for name, (shape, kv, prompts, n, mb, drafter, sampled) in SERVE.items():
        jobs[_world(shape)].append(dict(
            name=name, kind="serving", cfg=dict(CFG, kv_dtype=kv),
            params=files[None], mesh=list(shape), axes=AXES, max_batch=mb,
            prompts=prompts, n=n, drafter=drafter, seed=7,
            sampling=dict(SAMPLED) if sampled else None))
    for name, (shape, T, rules, variant) in FORWARD.items():  # noqa: N806
        np.save(d / f"ids_{name}.npy", _ids(T))
        jobs[_world(shape)].append(dict(
            name=name, kind="forward", cfg=_variant_cfg(variant),
            params=files[variant], mesh=list(shape), axes=AXES,
            ids=str(d / f"ids_{name}.npy"), rules=rules,
            unroll=variant == "ps"))
    np.save(d / "ids_fresh.npy", _ids(13))
    jobs[2].append(dict(name="sp2_fresh", kind="forward", cfg=CFG,
                        params=files[None], mesh=[1, 2], axes=AXES,
                        ids=str(d / "ids_fresh.npy"), rules={"seq": "model"},
                        cache=True, fresh=True))
    for world, cases in jobs.items():
        launch({"cases": cases}, world, d, timeout_s=240)

    jparams = {v: _jax_params(v) for v in (None, "ps", "vocab")}
    want = {}
    for name, (shape, kv, prompts, n, mb, drafter, sampled) in SERVE.items():
        cfg = dict(CFG, kv_dtype=kv)
        tree = jax.tree.map(np.asarray, jparams[None])
        port_cfg = ModelConfig(**cfg)
        one = ServingEngine(
            port_cfg, params_from_numpy(port_cfg, tree, device="cpu"),
            max_batch=mb, device="cpu", seed=7,
            sampling=SamplingParams(**SAMPLED) if sampled else None,
            drafter=None if drafter is None else NgramDrafter(*drafter))
        out = one.run(prompts, n, stop_tokens=())
        want[name, "single"] = _streams(out, len(prompts))
        if sampled:  # the JAX engine samples from its own key
            continue
        mesh = j_make_mesh(shape, devices=jax.devices()[:_world(shape)])
        srv = JServing(JConfig(**cfg), jax.tree.map(jnp.asarray,
                                                    jparams[None]),
                       max_batch=mb, mesh=mesh,
                       drafter=None if drafter is None else JNgram(*drafter))
        out = srv.run(prompts, n_predict=n, stop_tokens=())
        want[name, "jax"] = (_streams(out, len(prompts)), srv.spec_cycles,
                             srv.spec_emitted)
    for name, (shape, T, rules, variant) in FORWARD.items():  # noqa: N806
        want[name] = _jax_forward(  # the "ps" weights in the "i" layout
            JConfig(**_variant_cfg(variant)),
            jparams[None if variant == "ps" else variant], _ids(T), shape,
            rules)
    cfg = ModelConfig(**CFG)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams[None]),
                               device="cpu")
    cache = init_cache(cfg, 2, device="cpu")
    want["sp2_fresh"], _ = forward(cfg, params, torch.from_numpy(_ids(13)),
                                   cache, 0, fresh_kv=True)
    want["sp2_fresh_cache"] = cache
    return d, want


def _ranks(d, name, shape):
    return [result(d, name, r) for r in range(_world(shape))]


@pytest.mark.parametrize("name", ["d2_int8", "d2_float32", "d22_int8",
                                  "d22_float32", "d2_stagger", "d22_stagger",
                                  "e64_tp4"])
def test_serving_streams_match_jax_and_single(runs, name):
    """Every rank's greedy streams equal the JAX engine's at the same mesh
    and the port's one-device engine's; a data axis holds its block of
    the slots and exchanges each chunk's ring."""
    d, want = runs
    shape, _, prompts, _, mb, _, _ = SERVE[name]
    jstreams = want[name, "jax"][0]
    assert jstreams == want[name, "single"]
    for rank, got in enumerate(_ranks(d, name, shape)):
        assert got["streams"] == jstreams, (rank, got["streams"], jstreams)
        n_data = shape[0]
        assert got["rows"] == [rank // shape[1] * mb // n_data, mb // n_data]
        assert (got["exchanges"] > 0) == (n_data > 1)


def test_sampled_stream_does_not_depend_on_the_data_split(runs):
    d, want = runs
    ranks = _ranks(d, "d2_sampled", SERVE["d2_sampled"][0])
    assert ranks[0]["streams"] == ranks[1]["streams"]
    assert ranks[0]["streams"] == want["d2_sampled", "single"]
    greedy = want["d2_int8", "single"]
    assert [s[:8] for s in ranks[0]["streams"]] != greedy  # sampled


@pytest.mark.parametrize("name", ["spec_12", "spec_21", "spec_22",
                                  "spec_14"])
def test_speculative_serving_matches_jax(runs, name):
    d, want = runs
    jstreams, cycles, emitted = want[name, "jax"]
    assert jstreams == want[name, "single"]
    assert cycles > 0 and emitted > cycles
    for rank, got in enumerate(_ranks(d, name, SERVE[name][0])):
        assert got["streams"] == jstreams, (rank, got["streams"])
        assert (got["spec_cycles"], got["spec_emitted"]) == (cycles,
                                                             emitted)


@pytest.mark.parametrize("name", sorted(FORWARD))
def test_forward_logits_match_jax(runs, name):
    """Sequence parallelism at T % tp != 0, a plane-split ``wo`` held
    whole, a vocabulary the model axis does not divide: every rank's
    logits within 1e-5 of max|logit| of the JAX sharded forward."""
    d, want = runs
    ref = want[name]
    got = _ranks(d, name, FORWARD[name][0])
    for g in got:
        assert g["logits"].shape == ref.shape
        np.testing.assert_array_equal(g["logits"], got[0]["logits"])
    err = np.abs(got[0]["logits"] - ref).max() / np.abs(ref).max()
    assert err <= TOL, err


def test_sequence_parallel_prefill_writes_the_cache(runs):
    """A prefill at T = 13 over 2 ranks under sequence parallelism: no pad
    row reaches attention or the cache; each rank's cache heads equal one
    device's, its logits within 1e-5 of max|logit|."""
    d, want = runs
    ref, cache = want["sp2_fresh"].numpy(), want["sp2_fresh_cache"]
    for rank, got in enumerate(_ranks(d, "sp2_fresh", (1, 2))):
        err = np.abs(got["logits"] - ref).max() / np.abs(ref).max()
        assert err <= TOL, err
        for side in ("k", "v"):
            full = cache[side][:, :, 2 * rank:2 * rank + 2].numpy()
            np.testing.assert_allclose(got[f"cache_{side}"], full,
                                       rtol=1e-5, atol=1e-6)
            assert not np.any(got[f"cache_{side}"][:, :, :, 13:])
