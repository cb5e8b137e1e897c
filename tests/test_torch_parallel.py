"""Port vs JAX package: parallel/ (mesh, sharding, context, pipeline) and
the tensor-, sequence- and pipeline-parallel forward.

The ranks are processes over gloo on the CPU (tests/torch_parallel_worker.py:
torch and the port only); the JAX references run here, on conftest's 8
virtual devices, with the JAX tests' own setups and tolerances:

  * ``param_pspecs`` / ``cache_pspec`` equal the JAX trees, leaf by leaf,
    on tests/test_sharding.py's CFG at meshes (1, 2), (1, 4) and (2, 2),
    fused q/k/v too;
  * TP forward logits at tp = 2 and 4 within 1e-4 of the JAX TP forward
    (NeoX; BLOOM with ALiBi slopes split per rank at tp = 2); every rank
    holds the same logits;
  * the (2, 2) DP x TP prefill and decode step against the JAX (2, 2) run;
  * sequence parallelism within 1e-4 of the JAX SP forward;
  * ``pipeline_forward_nocache`` at (2 stages, 2 micro) and (4, 3) within
    2e-5 of the JAX pipeline and bit-equal to the port's
    ``forward_nocache`` on each microbatch; ``stage_params`` shapes;
  * the ``ValueError`` where the JAX package cannot place the cache
    either (heads that do not split, ``max_batch`` over ``data``), and the
    leaves held whole where GSPMD gathers: a K split that would cut a Q4
    block, a plane-split K split, a vocabulary that does not divide
    (tests/test_torch_parallel_data.py runs them against the JAX package).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from torch_parallel_worker import launch, result, save_tree
from vsim_tpu.models.config import ModelConfig as JConfig
from vsim_tpu.models.init import fuse_qkv_params as j_fuse
from vsim_tpu.models.init import init_params as j_init_params
from vsim_tpu.models.init import random_q4_params as j_random_q4
from vsim_tpu.models.transformer import forward as j_forward
from vsim_tpu.models.transformer import init_cache as j_init_cache
from vsim_tpu.parallel import context as jctx
from vsim_tpu.parallel.mesh import make_mesh as j_make_mesh
from vsim_tpu.parallel.pipeline import AXIS_PIPE as J_PIPE
from vsim_tpu.parallel.pipeline import pipeline_forward_nocache as j_pipeline
from vsim_tpu.parallel.pipeline import stage_params as j_stage_params
from vsim_tpu.parallel.sharding import cache_pspec as j_cache_pspec
from vsim_tpu.parallel.sharding import param_pspecs as j_param_pspecs
from vsim_tpu.parallel.sharding import shard_cache as j_shard_cache
from vsim_tpu.parallel.sharding import shard_params as j_shard_params
from vsim_tpu_torch.engine.serving import ServingEngine
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.models.from_jax import params_from_numpy
from vsim_tpu_torch.models.init import fuse_qkv_params, random_q4_params
from vsim_tpu_torch.parallel import sharding
from vsim_tpu_torch.parallel.mesh import Mesh
from vsim_tpu_torch.parallel.pipeline import AXIS_PIPE, stage_params
from vsim_tpu_torch.quant.q4 import to_plane_split

# tests/test_sharding.py's CFG, tests/test_pipeline.py's, and a BLOOM one
CFG = dict(arch="gptneox", n_vocab=256, n_ctx=32, n_embd=128, n_head=8,
           n_layer=2, n_ff=256, n_rot=8)
PIPE_CFG = dict(arch="gptneox", n_vocab=128, n_ctx=32, n_embd=64, n_head=4,
                n_layer=4, n_ff=128, n_rot=8, compute_dtype="float32")
BLOOM_CFG = dict(arch="bloom", n_vocab=256, n_ctx=32, n_embd=128, n_head=8,
                 n_layer=2, n_ff=512, parallel_residual=False, alibi=True,
                 activation="gelu_tanh")
AXES = ["data", "model"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_forward(cfg, params, ids, mesh_shape, rules=None, cache=True,
                 decode=False):
    """The JAX package's sharded forward, as tests/test_sharding.py runs
    it: logits (and the decode step's) as numpy."""
    n = mesh_shape[0] * mesh_shape[1]
    mesh = j_make_mesh(mesh_shape, devices=jax.devices()[:n])
    sharded = j_shard_params(params, mesh)
    ids = jnp.asarray(ids, jnp.int32)
    with jctx.use_mesh(mesh, rules):
        if not cache:
            fn = jax.jit(lambda p, t: j_forward(cfg, p, t, None, 0)[0])
            return (np.asarray(fn(sharded, ids)),)
        c = j_shard_cache(j_init_cache(cfg, batch=ids.shape[0]), mesh)
        fn = jax.jit(lambda p, t, c, n: j_forward(cfg, p, t, c, n))
        logits, c = fn(sharded, ids, c, jnp.int32(0))
        if not decode:
            return (np.asarray(logits),)
        logits2, _ = fn(sharded, ids[:, :1], c, jnp.int32(ids.shape[1]))
        return np.asarray(logits), np.asarray(logits2)


def _pipeline_ids(n_micro):
    rng = np.random.default_rng(0)
    return rng.integers(0, PIPE_CFG["n_vocab"], size=(n_micro, 2, 8)).astype(
        np.int64)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Inputs, the JAX references, and the ranks' results of one 2-rank
    and one 4-rank job (every case of a world size in one launch)."""
    d = tmp_path_factory.mktemp("parallel")
    jc, jp, jb = JConfig(**CFG), JConfig(**PIPE_CFG), JConfig(**BLOOM_CFG)
    tp_params = j_init_params(jc, seed=0, quantize=True,
                              scale_dtype=np.float32)
    dp_params = j_random_q4(jc, seed=0)
    sp_params = j_init_params(jc, seed=2, quantize=True,
                              scale_dtype=np.float32)
    pipe_params = j_init_params(jp, seed=11, quantize=True)
    bloom_params = j_init_params(jb, seed=5, quantize=True,
                                 scale_dtype=np.float32)
    files = {}
    for name, tree in (("tp", tp_params), ("dp", dp_params),
                       ("sp", sp_params), ("pipe", pipe_params),
                       ("bloom", bloom_params)):
        files[name] = str(d / f"{name}.npz")
        save_tree(files[name], _np(tree))
    ids = {"tp": np.arange(1, 9)[None, :], "dp": np.ones((2, 8), np.int64),
           "sp": np.arange(1, 9)[None, :].repeat(2, axis=0),
           "bloom": np.array([[3, 200, 17, 5, 99, 1, 250, 42]])}
    for k, v in ids.items():
        np.save(d / f"ids_{k}.npy", v)
    for m in (2, 3):
        np.save(d / f"ids_pipe{m}.npy", _pipeline_ids(m))

    def fwd(name, cfg, params, shape, **kw):
        return dict(name=name, kind="forward", cfg=cfg, params=params,
                    mesh=list(shape), axes=AXES, ids=str(d / f"ids_{kw.pop('ids')}.npy"),
                    **kw)

    jobs = {2: [fwd("tp2", CFG, files["tp"], (1, 2), ids="tp", cache=True),
                fwd("sp2", CFG, files["sp"], (1, 2), ids="sp",
                    rules={"seq": "model"}),
                fwd("bloom2", BLOOM_CFG, files["bloom"], (1, 2), ids="bloom",
                    cache=True),
                dict(name="pipe2", kind="pipeline", cfg=PIPE_CFG,
                     params=files["pipe"], mesh=[2], axes=[AXIS_PIPE],
                     ids=str(d / "ids_pipe2.npy"))],
            4: [fwd("tp4", CFG, files["tp"], (1, 4), ids="tp", cache=True),
                fwd("dp4", CFG, files["dp"], (2, 2), ids="dp", cache=True,
                    decode=True),
                fwd("sp4", CFG, files["sp"], (1, 4), ids="sp",
                    rules={"seq": "model"}),
                dict(name="pipe4", kind="pipeline", cfg=PIPE_CFG,
                     params=files["pipe"], mesh=[4], axes=[AXIS_PIPE],
                     ids=str(d / "ids_pipe3.npy"))]}
    for world, cases in jobs.items():
        launch({"cases": cases}, world, d)
    refs = {
        "tp2": _jax_forward(jc, tp_params, ids["tp"], (1, 2)),
        "tp4": _jax_forward(jc, tp_params, ids["tp"], (1, 4)),
        "dp4": _jax_forward(jc, dp_params, ids["dp"], (2, 2), decode=True),
        "sp2": _jax_forward(jc, sp_params, ids["sp"], (1, 2),
                            rules={"seq": "model"}, cache=False),
        "sp4": _jax_forward(jc, sp_params, ids["sp"], (1, 4),
                            rules={"seq": "model"}, cache=False),
        "bloom2": _jax_forward(jb, bloom_params, ids["bloom"], (1, 2)),
    }
    for name, S, M in (("pipe2", 2, 2), ("pipe4", 4, 3)):
        mesh = JMesh(np.asarray(jax.devices()[:S]), (J_PIPE,))
        staged = j_stage_params(pipe_params, S, mesh)
        refs[name] = (np.asarray(j_pipeline(
            jp, staged, jnp.asarray(_pipeline_ids(M), jnp.int32), mesh)),)
    return d, refs


def _ranks(d, name, world):
    return [result(d, name, r) for r in range(world)]


@pytest.mark.parametrize("name,world", [("tp2", 2), ("tp4", 4),
                                        ("bloom2", 2)])
def test_tp_forward_matches_jax(runs, name, world):
    d, refs = runs
    got = _ranks(d, name, world)
    for g in got[1:]:  # every rank holds the whole logits
        np.testing.assert_array_equal(g["logits"], got[0]["logits"])
    np.testing.assert_allclose(got[0]["logits"], refs[name][0], rtol=1e-4,
                               atol=1e-4)


def test_dp_tp_prefill_and_decode_match_jax(runs):
    """(2 data, 2 model): each data rank holds one batch row."""
    d, refs = runs
    got = _ranks(d, "dp4", 4)  # rank = data * 2 + model
    for key, want in zip(("logits", "logits2"), refs["dp4"]):
        np.testing.assert_array_equal(got[1][key], got[0][key])
        np.testing.assert_array_equal(got[3][key], got[2][key])
        both = np.concatenate([got[0][key], got[2][key]])
        assert both.shape == want.shape and np.all(np.isfinite(both))
        np.testing.assert_allclose(both, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,world", [("sp2", 2), ("sp4", 4)])
def test_sequence_parallel_matches_jax(runs, name, world):
    d, refs = runs
    got = _ranks(d, name, world)
    for g in got[1:]:
        np.testing.assert_array_equal(g["logits"], got[0]["logits"])
    np.testing.assert_allclose(got[0]["logits"], refs[name][0], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("name,world", [("pipe2", 2), ("pipe4", 4)])
def test_pipeline_matches_jax_and_plain(runs, name, world):
    d, refs = runs
    got = _ranks(d, name, world)
    for g in got:  # logits on every rank, equal to the plain forward
        np.testing.assert_array_equal(g["logits"], got[0]["plain"])
    np.testing.assert_allclose(got[0]["logits"], refs[name][0], rtol=2e-5,
                               atol=2e-5)


def test_stage_params_shapes():
    cfg = ModelConfig(**PIPE_CFG)
    params = random_q4_params(cfg, seed=0, device="cpu")
    for stage in range(2):
        mesh = Mesh((AXIS_PIPE,), (2,), coord=(stage,))
        staged = stage_params(params, 2, mesh)
        assert staged["layers"]["ln1_w"].shape == (2, cfg.n_embd)
        assert staged["layers"]["wq"].packed.shape[0] == 2
        assert torch.equal(staged["layers"]["wq"].packed,
                           params["layers"]["wq"].packed[2 * stage:
                                                         2 * stage + 2])
    with pytest.raises(ValueError):
        stage_params(params, 3, Mesh((AXIS_PIPE,), (3,)))


def _spec(s):
    return tuple(s)


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)])
@pytest.mark.parametrize("fused", [False, True])
def test_param_and_cache_specs_match_jax(shape, fused):
    jc = JConfig(**CFG)
    jparams = j_random_q4(jc, seed=0)
    if fused:
        jparams = j_fuse(jc, jparams)
    n = shape[0] * shape[1]
    jmesh = j_make_mesh(shape, devices=jax.devices()[:n])
    want = j_param_pspecs(jparams, jmesh)
    cfg = ModelConfig(**CFG)
    params = params_from_numpy(cfg, _np(j_random_q4(jc, seed=0)),
                               device="cpu")
    if fused:
        params = fuse_qkv_params(cfg, params)
    got = sharding.param_pspecs(params, Mesh(AXES, shape))
    def same(w, g, where):
        if hasattr(w, "packed"):  # the JAX Q4Tensor of two specs
            assert isinstance(g, sharding.Q4Spec), where
            assert (g.packed, g.scales) == (_spec(w.packed),
                                            _spec(w.scales)), where
        else:
            assert g == _spec(w), (where, g, w)

    assert set(got) == set(want) and set(got["layers"]) == set(
        want["layers"])
    for k, w in want.items():
        if k == "layers":
            for lk, lw in w.items():
                same(lw, got[k][lk], lk)
        else:
            same(w, got[k], k)
    for kv in ("float32", "int8"):
        jcache = j_init_cache(JConfig(**CFG, kv_dtype=kv), batch=2)
        wspec = j_cache_pspec(jmesh, jcache)
        gspec = sharding.cache_pspec(Mesh(AXES, shape), {
            "k": (None, None) if kv == "int8" else None})
        assert jax.tree.map(_spec, wspec, is_leaf=lambda x: isinstance(
            x, P)) == gspec


def test_logical_spec_matches_jax():
    from vsim_tpu_torch.parallel import context as tctx

    names = ("batch", "seq", "heads", None, "embed", "vocab", "ffn")
    for rules in (None, {"seq": "model"}):
        with jctx.use_mesh(None, rules), tctx.use_mesh(None, rules):
            assert tctx.logical_spec(*names) == tuple(
                jctx.logical_spec(*names))


def test_shard_shapes():
    """A rank's local tree: Q4 packed and scales split congruently, the
    cache's heads and batch, int8 scales with them."""
    cfg = ModelConfig(**CFG)
    params = fuse_qkv_params(cfg, random_q4_params(cfg, seed=0,
                                                   device="cpu"))
    mesh = Mesh(AXES, (2, 2), coord=(1, 1))
    local = sharding.shard_params(params, mesh)
    lay, full = local["layers"], params["layers"]
    assert lay["w_qkv"].packed.shape == (2, 64, 192)
    assert torch.equal(lay["w_qkv"].scales, full["w_qkv"].scales[..., 192:])
    assert lay["wo"].packed.shape == (2, 32, 128)
    assert torch.equal(lay["wo"].packed, full["wo"].packed[:, 32:])
    assert torch.equal(lay["wo"].scales, full["wo"].scales[:, 2:])
    assert lay["ln1_w"] is full["ln1_w"]
    assert local["lm_head"].packed.shape == (64, 128)
    from vsim_tpu_torch.models.transformer import init_cache

    cache = init_cache(cfg.replace(kv_dtype="int8"), 4, device="cpu")
    lc = sharding.shard_cache(cache, mesh)
    assert lc["k"][0].shape == (2, 2, 4, 32, 16)
    assert lc["k"][1].shape == (2, 2, 4, 32)


def test_unsplittable_raises():
    """What the JAX package cannot place raises: heads that do not split
    into whole heads, cache rows (``max_batch``) that do not split over
    ``data``.  Where GSPMD would gather, the leaf is held whole on every
    rank, both its arrays: a K split that would cut a 32-row block, a K
    split of a plane-split weight, a vocabulary that does not divide; the
    leaves that do split are this rank's shares."""
    cfg = ModelConfig(**CFG)
    mesh = Mesh(AXES, (1, 4))
    with pytest.raises(ValueError, match="whole heads"):
        sharding.check_heads(6, mesh)
    with pytest.raises(ValueError, match="whole heads"):
        ServingEngine(cfg.replace(n_head=6), random_q4_params(
            cfg.replace(n_head=6), device="cpu"), device="cpu", mesh=mesh)
    from vsim_tpu_torch.models.transformer import init_cache

    with pytest.raises(ValueError, match="do not split over 2 ranks on "
                       "'data'"):
        sharding.shard_cache(init_cache(cfg, 3, device="cpu"),
                             Mesh(AXES, (2, 1)))
    with pytest.raises(ValueError, match="max_batch"):
        ServingEngine(cfg, random_q4_params(cfg, device="cpu"), max_batch=3,
                      device="cpu", mesh=Mesh(AXES, (2, 1)))
    # wo: K 64 over 4 ranks, 16 rows a rank: held whole, now no raise
    assert sharding.check_heads(4, mesh) is None
    params = random_q4_params(cfg, seed=0, device="cpu")
    ps = dict(params, layers=dict(params["layers"]))
    wo = ps["layers"]["wo"]
    ps["layers"]["wo"] = to_plane_split(wo.layer(0))
    ps["layers"]["wo"].packed = ps["layers"]["wo"].packed[None]
    ps["layers"]["wo"].scales = ps["layers"]["wo"].scales[None]
    local = sharding.shard_params(ps, Mesh(AXES, (1, 2), coord=(0, 1)))
    assert local["layers"]["wo"] is ps["layers"]["wo"]
    assert torch.equal(local["layers"]["w_proj"].packed,
                       params["layers"]["w_proj"].packed[:, 64:])
    # K = 128: 4 blocks of 32 rows; packed splits 8 ways, scales do not
    local = sharding.shard_params(params, Mesh(AXES, (1, 8), coord=(0, 3)))
    assert local["layers"]["wo"] is params["layers"]["wo"]
    assert torch.equal(local["layers"]["wq"].packed,
                       params["layers"]["wq"].packed[..., 48:64])
    odd = random_q4_params(cfg.replace(n_vocab=250), seed=0, device="cpu")
    local = sharding.shard_params(odd, mesh)
    assert local["lm_head"] is odd["lm_head"] and local["wte"] is odd["wte"]
    assert local["layers"]["wo"].packed.shape == (2, 16, 128)


def test_graphed_tp_engine_on_gloo_raises(tmp_path):
    """``cuda_graph=True`` over a gloo group raises before anything runs
    (gloo's collectives go through the host; a graph cannot capture
    them); mesh= with a drafter, and with a data axis > 1 (this rank's
    block of the slots), builds."""
    import datetime

    import torch.distributed as dist

    from vsim_tpu_torch.engine.speculative import NgramDrafter

    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=30))
    try:
        world = dist.group.WORLD
        cfg = ModelConfig(**CFG)
        params = random_q4_params(cfg, device="cpu")
        mesh = Mesh(AXES, (1, 2), groups=(world, world))
        with pytest.raises(ValueError, match="gloo"):
            ServingEngine(cfg, params, mesh=mesh, cuda_graph=True)
        srv = ServingEngine(cfg, params, mesh=mesh, drafter=NgramDrafter(2, 3))
        assert srv.drafter is not None and srv._make_graph is None
        srv = ServingEngine(cfg, params, max_batch=8, mesh=Mesh(
            AXES, (2, 1), coord=(1, 0), groups=(world, world)))
        assert (srv.first, srv.rows) == (4, 4)
        assert srv.cache["k"].shape[1] == 4 and srv.tokens.shape == (4,)
    finally:
        dist.destroy_process_group()
