"""Port vs JAX package: tensor-parallel serving and the multi-process
runtime, ranks as processes over gloo on the CPU
(tests/torch_parallel_worker.py).

  * ``ServingEngine(mesh=...)`` at (1, 2) and (1, 4), int8 and float32 KV,
    on the prompts of tests/test_serving.py's sharded test (:91) and its
    model at twice the width and a vocabulary of 1500 (E = 128, F = 256:
    every weight splits; tests/test_torch_parallel_data.py runs the E = 64
    model, whose ``wo`` is held whole at tp = 4): every rank's greedy
    streams equal the JAX ``ServingEngine(mesh=...)``'s and the port's
    single-device engine's;
  * ``distributed.initialize`` from the ``VSIM_*`` variables,
    ``global_mesh((1, -1))``, a cross-process sum, a tensor-parallel Q4
    matmul equal to the whole weight's, ``barrier`` (the counterpart of
    tests/test_distributed.py's workers, kept in tier-1 at a size that
    takes seconds), and a rank that never reaches the barrier making the
    other raise within the barrier's timeout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_parallel_worker import launch, result, save_tree
from vsim_tpu.engine.serving import ServingEngine as JServing
from vsim_tpu.models.config import ModelConfig as JConfig
from vsim_tpu.models.init import init_params as j_init_params
from vsim_tpu.parallel.mesh import make_mesh as j_make_mesh
from vsim_tpu_torch.engine.serving import ServingEngine
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.models.from_jax import params_from_numpy

# tests/test_serving.py's model at twice its width, its sharded test's
# prompts; a vocabulary of 1500 (the lm head padded to 2048) puts real
# rows on every rank at tp = 4, each rank's 512 rows short of the 1024
# the engine pads a whole head to
SERVE_CFG = dict(arch="gptneox", n_vocab=1500, n_ctx=96, n_embd=128,
                 n_head=4, n_layer=2, n_ff=256, n_rot=8,
                 kv_dtype="float32", compute_dtype="float32")
PROMPTS = [[1, 2, 3], [7, 8, 9, 10, 11], [42]]
N_PREDICT = 8
KVS = ("int8", "float32")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel_serving")
    jparams = j_init_params(JConfig(**SERVE_CFG), seed=3, quantize=True)
    tree = jax.tree.map(np.asarray, jparams)
    save_tree(d / "params.npz", tree)

    def serve(world, kv):
        return dict(name=f"serve{world}_{kv}", kind="serving",
                    cfg=dict(SERVE_CFG, kv_dtype=kv),
                    params=str(d / "params.npz"), mesh=[1, world],
                    axes=["data", "model"], max_batch=4, prompts=PROMPTS,
                    n=N_PREDICT)

    launch({"cases": [serve(2, kv) for kv in KVS] + [
        dict(name="runtime", kind="runtime", mesh=[1, 2],
             axes=["data", "model"]),
        dict(name="dead", kind="dead_rank", mesh=[1, 2],
             axes=["data", "model"], timeout_s=3)]}, 2, d)
    launch({"cases": [serve(4, kv) for kv in KVS]}, 4, d)
    want = {}
    for kv in KVS:
        jc = JConfig(**dict(SERVE_CFG, kv_dtype=kv))
        for world in (2, 4):
            mesh = j_make_mesh((1, world), devices=jax.devices()[:world])
            srv = JServing(jc, jax.tree.map(jnp.asarray, jparams),
                           max_batch=4, mesh=mesh)
            out = srv.run(PROMPTS, n_predict=N_PREDICT, stop_tokens=())
            want[world, kv] = [out[i].generated for i in range(len(PROMPTS))]
        cfg = ModelConfig(**dict(SERVE_CFG, kv_dtype=kv))
        one = ServingEngine(cfg, params_from_numpy(cfg, tree, device="cpu"),
                            max_batch=4, device="cpu")
        out = one.run(PROMPTS, n_predict=N_PREDICT, stop_tokens=())
        want["single", kv] = [out[i].generated for i in range(len(PROMPTS))]
    return d, want


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kv", KVS)
def test_tp_serving_streams_match_jax_and_single(runs, world, kv):
    d, want = runs
    for rank in range(world):
        got = result(d, f"serve{world}_{kv}", rank)["streams"]
        assert got == want[world, kv], (rank, got, want[world, kv])
        assert got == want["single", kv]


def test_multiprocess_runtime(runs):
    d, _ = runs
    for rank in range(2):
        got = result(d, "runtime", rank)
        assert int(got["count"]) == 2
        np.testing.assert_array_equal(got["sum"], [1.0])
        np.testing.assert_allclose(got["tp"], got["plain"], rtol=1e-6,
                                   atol=1e-6)


def test_dead_rank_trips_the_barrier(runs):
    d, _ = runs
    got = result(d, "dead", 0)
    assert got["raised"], got
