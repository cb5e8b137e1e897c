"""One rank of the port's multi-process tests (tests/test_torch_parallel*.py).

Run by those tests as ``python tests/torch_parallel_worker.py JOB.json``
in one process per rank, with ``VSIM_COORDINATOR``, ``VSIM_NUM_PROCESSES``
and ``VSIM_PROCESS_ID`` set: the ranks join one gloo group on the CPU
(``vsim_tpu_torch.parallel.distributed.initialize``) and run the job's
cases in order.  Imports only torch, numpy and the port, never JAX: the
JAX references are computed by the test process and the params come in
``.npz`` files it wrote.  Each rank writes ``<case>_rank<r>.npz`` (arrays)
or ``.json`` (streams, flags) into the job's directory.
"""

import json
import os
import sys
import types

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from vsim_tpu_torch.engine.sampling import SamplingParams  # noqa: E402
from vsim_tpu_torch.engine.serving import ServingEngine  # noqa: E402
from vsim_tpu_torch.engine.speculative import NgramDrafter  # noqa: E402
from vsim_tpu_torch.models.config import ModelConfig  # noqa: E402
from vsim_tpu_torch.models.from_jax import params_from_numpy  # noqa: E402
from vsim_tpu_torch.models.init import layer_of  # noqa: E402
from vsim_tpu_torch.models.transformer import (  # noqa: E402
    forward,
    forward_nocache,
    init_cache,
)
from vsim_tpu_torch.ops.matmul import q4_matmul  # noqa: E402
from vsim_tpu_torch.parallel import context as pctx  # noqa: E402
from vsim_tpu_torch.parallel import distributed  # noqa: E402
from vsim_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from vsim_tpu_torch.parallel.pipeline import (  # noqa: E402
    pipeline_forward_nocache,
    stage_params,
)
from vsim_tpu_torch.parallel.sharding import (  # noqa: E402
    shard_cache,
    shard_params,
)
from vsim_tpu_torch.quant.q4 import Q4Tensor  # noqa: E402


def load_tree(path):
    """A params tree saved flat by the test ("a/b/packed" keys; a Q4
    weight's layout under ".../layout"), Q4 leaves duck-typed for
    ``params_from_numpy``."""
    flat = np.load(path)
    tree = {}
    for key in flat.files:
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = flat[key]

    def fix(node):
        if isinstance(node, dict):
            if "packed" in node:
                return types.SimpleNamespace(packed=node["packed"],
                                             scales=node["scales"],
                                             layout=str(node["layout"]))
            return {k: fix(v) for k, v in node.items()}
        return node

    return fix(tree)


def case_forward(case, cfg, params, mesh):
    """A prefill (``cache``; with ``fresh``, over its own k/v, which
    sequence parallelism splits, the cache returned) or a cache-free
    forward of the case's ids on this rank's shard (``unroll``: its layers
    per layer), under the case's rules; with ``decode``, one more step of the ids' first column at
    n_past T.  Ids and cache are the rank's batch rows (the data axis)."""
    ids = torch.from_numpy(np.load(case["ids"])).long()
    B, T = ids.shape  # noqa: N806
    n_data, di = mesh.size("data"), mesh.index("data")
    rows = ids[di * (B // n_data):(di + 1) * (B // n_data)]
    local = shard_params(params, mesh)
    if case.get("unroll"):  # per-layer weights (a stacked one is K10's,
        # which takes the interleaved layout only)
        local = dict(local, layers=[
            {k: layer_of(v, il) for k, v in local["layers"].items()}
            for il in range(cfg.n_layer)])
    out = {}
    with pctx.use_mesh(mesh, case.get("rules")):
        if case.get("cache"):
            cache = shard_cache(init_cache(cfg, B, device="cpu"), mesh)
            out["logits"], cache = forward(cfg, local, rows, cache, 0,
                                           fresh_kv=bool(case.get("fresh")))
            if case.get("fresh"):
                out["cache_k"], out["cache_v"] = cache["k"], cache["v"]
            if case.get("decode"):
                out["logits2"], _ = forward(cfg, local, rows[:, :1], cache, T)
        else:
            out["logits"], _ = forward(cfg, local, rows, None, 0)
    return {k: v.numpy() for k, v in out.items()}


def case_pipeline(case, cfg, params, mesh):
    ids = torch.from_numpy(np.load(case["ids"])).long()
    staged = stage_params(params, mesh.size("pipe"), mesh)
    got = pipeline_forward_nocache(cfg, staged, ids, mesh)
    plain = torch.stack([forward_nocache(cfg, params, i) for i in ids])
    return {"logits": got.numpy(), "plain": plain.numpy()}


def case_serving(case, cfg, params, mesh):
    """``ServingEngine(mesh=)`` over the case's prompts (greedy, or the
    case's ``sampling`` from ``seed``; with ``drafter`` (m, gamma) an
    ``NgramDrafter``): the streams, the speculative counts, and how many
    exchanges over the data axis the run made."""
    from vsim_tpu_torch import monitor

    drafter = case.get("drafter")
    sampling = case.get("sampling")
    srv = ServingEngine(cfg, params, max_batch=case["max_batch"],
                        device="cpu", mesh=mesh, seed=case.get("seed", 0),
                        sampling=None if sampling is None
                        else SamplingParams(**sampling),
                        drafter=None if drafter is None
                        else NgramDrafter(*drafter))
    monitor.reset()
    out = srv.run(case["prompts"], case["n"], stop_tokens=(),
                  chunk_steps=case.get("chunk_steps", 8))
    spans = [st for st in monitor.stats().values()
             if st.name == "serve/exchange"]
    return dict(streams=[out[i].generated
                         for i in range(len(case["prompts"]))],
                spec_cycles=srv.spec_cycles, spec_emitted=srv.spec_emitted,
                exchanges=sum(st.calls for st in spans),
                rows=[srv.first, srv.rows])


def case_runtime(case, cfg, params, mesh):
    """The JAX multi-process test's checks: a cross-process sum, a
    tensor-parallel Q4 matmul (output rows split over the ranks, the
    logits gathered) against the whole weight on this rank, a barrier."""
    ax = pctx.Axis(mesh.size("model"), mesh.index("model"),
                   mesh.group("model"))
    total = pctx.all_reduce(torch.tensor([float(ax.index)]), ax)
    w = Q4Tensor.from_dense_np(
        np.random.default_rng(0).standard_normal((256, 128)).astype(
            np.float32), scale_dtype=torch.float32, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 128)).astype(np.float32))
    shard = shard_params({"lm_head": w}, mesh)["lm_head"]
    got = pctx.gather(q4_matmul(x, shard), -1, ax)
    distributed.barrier("runtime", timeout_s=30)
    return {"sum": total.numpy(), "tp": got.numpy(),
            "plain": q4_matmul(x, w).numpy(),
            "count": np.array(distributed.process_count())}


def case_dead_rank(case, cfg, params, mesh):
    """Rank 1 leaves without reaching the barrier: the others must raise
    within its timeout, not hang.  The group is unusable afterwards, so
    this case comes last."""
    if distributed.process_index() == 1:
        return {"raised": False}
    try:
        distributed.barrier("dead rank", timeout_s=case["timeout_s"])
    except RuntimeError as e:
        return {"raised": True, "error": str(e)[:200]}
    return {"raised": False}


CASES = {"forward": case_forward, "pipeline": case_pipeline,
         "serving": case_serving, "runtime": case_runtime,
         "dead_rank": case_dead_rank}


def main():
    with open(sys.argv[1]) as f:
        job = json.load(f)
    distributed.initialize(device="cpu", timeout_s=job.get("timeout_s", 60))
    rank = distributed.process_index()
    for case in job["cases"]:
        cfg = ModelConfig(**case["cfg"]) if "cfg" in case else None
        params = (params_from_numpy(cfg, load_tree(case["params"]),
                                    device="cpu")
                  if "params" in case else None)
        mesh = make_mesh(case["mesh"], axis_names=case["axes"],
                         device="cpu")
        result = CASES[case["kind"]](case, cfg, params, mesh)
        path = os.path.join(job["dir"], f"{case['name']}_rank{rank}")
        if isinstance(result, dict) and all(
                isinstance(v, np.ndarray) for v in result.values()):
            np.savez(path + ".npz", **result)
        else:
            with open(path + ".json", "w") as f:
                json.dump(result, f)
    if job["cases"][-1]["kind"] != "dead_rank":
        distributed.barrier("end", timeout_s=60)
    distributed.shutdown()


if __name__ == "__main__":
    main()


# ---------------------------------------------------------------------------
# the test process's side: write inputs, start the ranks, wait for them


def save_tree(path, tree) -> None:
    """Write a params tree (numpy or JAX leaves; Q4 weights duck-typed)
    flat into an .npz, bf16 arrays as their uint16 bits."""
    flat = {}

    def arr(x):
        a = np.asarray(x)
        return a.view(np.uint16) if a.dtype.name == "bfloat16" else a

    def walk(prefix, node):
        if hasattr(node, "packed"):
            flat[prefix + "/packed"] = arr(node.packed)
            flat[prefix + "/scales"] = arr(node.scales)
            flat[prefix + "/layout"] = np.array(node.layout)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else k, v)
        else:
            flat[prefix] = arr(node)

    walk("", tree)
    np.savez(path, **flat)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(job: dict, world: int, directory, timeout_s: float = 120):
    """Run ``job`` on ``world`` ranks, one process each, and wait at most
    ``timeout_s`` for them all.  A rank that fails or outlives the
    timeout fails the call; every rank still running is killed."""
    import subprocess
    import time

    job = dict(job, dir=str(directory))
    path = os.path.join(str(directory), "job.json")
    with open(path, "w") as f:
        json.dump(job, f)
    port = free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, VSIM_COORDINATOR=f"localhost:{port}",
                   VSIM_NUM_PROCESSES=str(world), VSIM_PROCESS_ID=str(r),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), path], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout_s
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                               1))
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"a rank ran past {timeout_s} s") from None
    bad = [(r, p.returncode, o[-3000:]) for r, (p, o) in
           enumerate(zip(procs, outs)) if p.returncode != 0]
    if bad:
        raise AssertionError(f"ranks failed: {bad}")


def result(directory, name: str, rank: int):
    base = os.path.join(str(directory), f"{name}_rank{rank}")
    if os.path.exists(base + ".npz"):
        return dict(np.load(base + ".npz"))
    with open(base + ".json") as f:
        return json.load(f)
