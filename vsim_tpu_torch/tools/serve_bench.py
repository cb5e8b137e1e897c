"""Continuous-batching serving benchmark of the port's ServingEngine (port
of tools/serve_bench.py): a mixed workload of staggered arrivals, mixed
prompt lengths and a token budget a request; prints ONE JSON line with
the decoded tokens/s, time to first token (p50, p99), the step's ms
(p50), the warm-up and priming seconds and the mean active slots.

    python -m vsim_tpu_torch.tools.serve_bench [--model gpt-j-6b]
        [--max-batch 16] [--requests 32] [--tokens 48] [--kv int8]
        [--n-ctx 512] [--spec [--gamma 4]] [--prompt-style random|repeat]
        [--chunk-steps 8] [--arrival-ms 0] [--ckpt DIR] [--tp N]
        [--device cpu]

Random Q4 weights from seed 0 (bf16 compute), or ``--ckpt``: a trained
dense checkpoint in the store format (vsim_tpu_torch/tools/train_small.py
writes one), quantized by its ``quantize_params``.  ``warmup()`` builds
the kernels and captures the step before the clock starts (the port's
serving engine has no prompt buckets to pre-build), then two requests
prime the path; both are reported apart.  ``--tp N`` serves under the
port's multi-process runtime (parallel/distributed.py): this program
starts N ranks of itself, one process each with the ``VSIM_*`` variables
set, over a (1, N) mesh; rank 0 prints the line.  Runs on the card;
``--device cpu`` runs the kernels' plain versions (and ranks over gloo).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from vsim_tpu_torch.device import card_label, resolve_device
from vsim_tpu_torch.models.config import PRESETS

RANK_FLAG = "--as-rank"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="gpt-j-6b", choices=sorted(PRESETS))
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=48)
    ap.add_argument("--kv", default="int8",
                    choices=["bfloat16", "float32", "int8", "int4"])
    ap.add_argument("--n-ctx", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tp", type=int, default=0,
                    help="tensor-parallel degree: that many ranks over a "
                         "(1, tp) mesh (ServingEngine mesh=)")
    ap.add_argument("--spec", action="store_true",
                    help="speculative serving: NgramDrafter in the step")
    ap.add_argument("--gamma", type=int, default=4)
    ap.add_argument("--prompt-style", default="random",
                    choices=["random", "repeat"])
    ap.add_argument("--chunk-steps", type=int, default=8,
                    help="serving steps per host round trip (step_chunk); "
                         "1 = the per-step path")
    ap.add_argument("--arrival-ms", type=float, default=0.0,
                    help="fixed inter-arrival spacing; 0 = every request "
                         "submitted up front")
    ap.add_argument("--ckpt", default=None,
                    help="a trained dense checkpoint dir (store format): "
                         "quantized and served")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the kernels' "
                         "plain versions")
    ap.add_argument(RANK_FLAG, dest="as_rank", action="store_true",
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def make_prompts(args, cfg):
    """The JAX tool's prompts, from numpy's generator at ``args.seed``."""
    rng = np.random.default_rng(args.seed)
    if args.prompt_style == "repeat" and args.ckpt:
        # the byte-level model continues code idioms: repeat them
        phrases = [b"for i in range(10):\n    print(i)\n",
                   b"    def get(self, key):\n        return self.key\n",
                   b"x = x + 1\nx = x + 1\nx = x + 1\n",
                   b"import os\nimport sys\nimport os\nimport sys\n"]
        return [list((phrases[i % len(phrases)] * 6)[:120])
                for i in range(args.requests)]
    if args.prompt_style == "repeat":
        prompts = []
        for _ in range(args.requests):
            base = list(rng.integers(1, min(cfg.n_vocab, 1000),
                                     size=int(rng.integers(3, 8))))
            reps = int(rng.integers(3, 9))
            prompts.append([int(t) for t in (base * reps)[:64]])
        return prompts
    return [[int(t) for t in rng.integers(1, min(cfg.n_vocab, 1000),
                                           size=int(rng.integers(4, 65)))]
            for _ in range(args.requests)]


def load_model(args, dev):
    """(cfg, params): the checkpoint quantized, or random Q4 from seed 0
    (drawn on the card there)."""
    if args.ckpt:
        from vsim_tpu_torch.convert.store import load_params
        from vsim_tpu_torch.tools.train_small import quantize_params

        cfg, dense = load_params(args.ckpt, device=dev)
        cfg = cfg.replace(n_ctx=args.n_ctx, compute_dtype="bfloat16",
                          kv_dtype=args.kv)
        return cfg, quantize_params(dense)
    from vsim_tpu_torch.models.init import random_q4_params

    cfg = PRESETS[args.model].replace(n_ctx=args.n_ctx,
                                      compute_dtype="bfloat16",
                                      kv_dtype=args.kv)
    return cfg, random_q4_params(
        cfg, seed=0, device=dev,
        rng="device" if dev.type == "cuda" else "numpy")


def serve(args, mesh=None) -> dict:
    """The benchmark on this process's device (or its rank of ``mesh``):
    the JSON line's object."""
    from vsim_tpu_torch.engine.sampling import SamplingParams
    from vsim_tpu_torch.engine.serving import ServingEngine

    dev = mesh.device if mesh is not None else resolve_device(args.device)
    cfg, params = load_model(args, dev)
    prompts = make_prompts(args, cfg)
    drafter = None
    if args.spec:
        from vsim_tpu_torch.engine.speculative import NgramDrafter

        drafter = NgramDrafter(m=3, gamma=args.gamma)
    eng = ServingEngine(cfg, params, max_batch=args.max_batch,
                        n_ctx=args.n_ctx, sampling=SamplingParams(greedy=True),
                        seed=args.seed, device=dev, drafter=drafter,
                        mesh=mesh)
    del params
    build_s = eng.warmup()
    t_prime0 = time.perf_counter()
    eng.run(prompts[:2], n_predict=4, stop_tokens=())
    prime_s = time.perf_counter() - t_prime0

    t0 = time.perf_counter()
    arrivals = [i * args.arrival_ms / 1e3 for i in range(len(prompts))]
    next_up = 0
    step_times, occupancy = [], []
    chunked = args.chunk_steps > 1 and not args.spec
    while next_up < len(prompts) or eng._queue or eng._active:
        now = time.perf_counter() - t0
        while next_up < len(prompts) and arrivals[next_up] <= now:
            eng.submit(prompts[next_up], args.tokens, stop_tokens=())
            next_up += 1
        if not (eng._queue or eng._active):
            time.sleep(max(arrivals[next_up] - now, 0.0))
            continue
        # active slots entering the step (tokens/s = occupancy x steps/s)
        occupancy.append(len(eng._active) + min(len(eng._queue),
                                                len(eng._free)))
        t1 = time.perf_counter()
        if chunked:
            eng.step_chunk(args.chunk_steps)
        else:
            eng.step()
        step_times.append((time.perf_counter() - t1)
                          / (args.chunk_steps if chunked else 1))
    wall = time.perf_counter() - t0

    reqs = list(eng._results.values())
    n_tok = sum(len(r.generated) for r in reqs)
    ttft = sorted(r.first_token_s - r.submitted_s for r in reqs)
    result = {
        "metric": f"serving_tokens_per_s_{args.model.replace('-', '_')}",
        "value": round(n_tok / wall, 3),
        "unit": "tokens/s/chip",
        "extra": {
            "model": args.model,
            "kv_dtype": args.kv,
            "max_batch": args.max_batch,
            "requests": args.requests,
            "tokens_per_request": args.tokens,
            "total_tokens": n_tok,
            "wall_s": round(wall, 3),
            "ttft_p50_s": round(ttft[len(ttft) // 2], 4),
            "ttft_p99_s": round(ttft[min(len(ttft) - 1,
                                         int(len(ttft) * 0.99))], 4),
            "step_ms_p50": round(1e3 * float(np.median(step_times)), 3),
            "prebuild_s": round(build_s, 2),
            "prime_s": round(prime_s, 2),
            "avg_active_slots": round(float(np.mean(occupancy)), 2)
            if occupancy else 0.0,
            "tp": args.tp or 1,
            "chunk_steps": args.chunk_steps if chunked else 1,
            "device": card_label() if dev.type == "cuda" else "cpu",
        },
    }
    if args.spec:
        # a plain batched step also gives one token a slot a forward: the
        # speculative win is tokens a slot a forward above 1
        per_slot = eng.spec_emitted / max(eng.spec_cycles, 1) / max(
            min(args.max_batch, args.requests), 1)
        result["extra"]["spec"] = {
            "gamma": args.gamma,
            "cycles": eng.spec_cycles,
            "emitted": eng.spec_emitted,
            "tokens_per_forward_per_slot": round(per_slot, 3),
        }
    return result


def run_rank(args) -> int:
    """One rank under the ``VSIM_*`` variables: serve over the (1, tp)
    mesh; rank 0 prints the line."""
    from vsim_tpu_torch.parallel import distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.initialize(device=args.device)
    try:
        mesh = distributed.global_mesh((1, args.tp))
        result = serve(args, mesh)
        if distributed.process_index() == 0:
            print(json.dumps(result), flush=True)
        distributed.barrier("serve_bench done", timeout_s=600)
    finally:
        distributed.shutdown()
    return 0


def launch_ranks(argv, tp: int, timeout_s: float = 3000) -> int:
    """Start ``tp`` ranks of this program (one process each, the
    ``VSIM_*`` variables set, rank 0's output passed through); returns the
    first failing rank's exit code, else 0.  A failed rank stops the
    others."""
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    procs = []
    for r in range(tp):
        env = dict(os.environ, VSIM_COORDINATOR=f"localhost:{port}",
                   VSIM_NUM_PROCESSES=str(tp), VSIM_PROCESS_ID=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "vsim_tpu_torch.tools.serve_bench",
             *argv, RANK_FLAG], env=env,
            stdout=None if r == 0 else subprocess.DEVNULL))
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return next((p.returncode for p in procs if p.returncode != 0), 0)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    if args.as_rank:
        return run_rank(args)
    if args.tp > 1:
        return launch_ranks(argv, args.tp)
    print(json.dumps(serve(args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
