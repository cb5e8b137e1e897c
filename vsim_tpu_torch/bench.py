"""Decode benchmark of the port (port of bench.py): prints ONE JSON line
with the headline metric, batched decode tokens/s.

    python -m vsim_tpu_torch.bench [--model gpt-j-6b] [--batch 128]
        [--tokens 192] [--prompt-len 8] [--n-ctx 512] [--kv int4]
        [--math gi] [--unroll auto|on|off] [--decode-chunk 96] [--quick]
        [--verbose] [--device cpu]

Random Q4 weights from seed 0, bf16 compute.  The step's time is the JAX
bench's: every row holds the same prompt, ``InferenceEngine._prefill``
fills a cache from ``new_cache(B)`` (each rep's cache freed before the
next is made), and ``_decode_many`` runs ``decode_chunk`` and
``max(tokens, 2 * decode_chunk)`` steps (greedy), each loop three times;
the step is the difference of the two loops' median seconds over the
difference of their lengths, which cancels what a call costs beside its
steps (the prefill's wait, the one read of the tokens).  The difference is
guarded (``timing.differenced``): unless every long rep took longer than
every short rep, the pair is measured again with the long loop doubled (at
most up to n_ctx), and if it is still unresolved the bench exits non-zero
with each rep's seconds and prints no line.  On the card the
step replays one CUDA graph (engine/generate.py), captured in the loops
run once before the timed ones; the line says how many captures fell in
the timed loops (0 unless a cache came back at other addresses).

``vs_baseline`` is the batched tokens/s over the speed of light of one
stream: the card's memory rate (vsim_tpu_torch/device.py:PEAKS) over the
Q4 weight bytes a token reads.  B=1 extras follow: the same loop pair at
B=1, and a warm ``generate`` of ``tokens`` tokens.  ``--verbose`` adds the
step's attribution (``_phase_attribution``: each Q4 group's matmuls over
the layers, the lm head, attention + KV, sampling and the rest, each by
``monitor.chain_time``), printed to stderr and kept under
``extra.phase_ms``.

The JAX bench's ``--impl`` (an ``xla`` impl would put the plain versions
on the card) and its halve-on-OOM ladder (it would quietly measure a
smaller batch) are left out: an OOM raises.  Runs on the card; ``--device
cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from vsim_tpu_torch import monitor
from vsim_tpu_torch.device import card_label, card_peaks, resolve_device
from vsim_tpu_torch.engine.generate import InferenceEngine
from vsim_tpu_torch.engine.sampling import SamplingParams, sample_torch
from vsim_tpu_torch.models.config import PRESETS
from vsim_tpu_torch.models.init import param_bytes, random_q4_params
from vsim_tpu_torch.ops import q4_cuda
from vsim_tpu_torch.timing import UnresolvedDifference, differenced

KV_DTYPES = ("bfloat16", "float32", "int8", "int4")
WINDOW = 64  # the repeat window of the timed loops, as the JAX bench's
GREEDY = SamplingParams(greedy=True)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="gpt-j-6b", choices=sorted(PRESETS))
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--tokens", type=int, default=192)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--n-ctx", type=int, default=512)
    ap.add_argument("--kv", default="int4", choices=KV_DTYPES)
    ap.add_argument("--math", default=None, choices=q4_cuda.MATHS,
                    help="the Q4 dequant math (ops/q4_cuda.py:"
                         "set_dequant_math); default gi")
    ap.add_argument("--unroll", default="auto", choices=["auto", "on", "off"],
                    help="per-layer plane-split weights (auto, on) or the "
                         "stacked interleaved ones (off: K10, K9)")
    ap.add_argument("--decode-chunk", type=int, default=96)
    ap.add_argument("--quick", action="store_true",
                    help="pythia-70m, 16 tokens")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the kernels' "
                         "plain versions")
    args = ap.parse_args(argv)
    if args.quick:
        args.model, args.tokens = "pythia-70m", 16
    return args


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_loop(engine: InferenceEngine, prompt: List[int], B: int,  # noqa: N803
               n_steps: int, reps: int) -> List[float]:
    """Seconds of ``_decode_many(n_steps)`` after a B-row prefill of
    ``prompt``, once per rep, each rep on a cache of its own (the last
    one freed first)."""
    dev = engine.device
    ids = torch.tensor([prompt] * B, dtype=torch.long, device=dev)
    times = []
    for _ in range(reps):
        cache = None  # the last rep's cache goes before the next is made
        cache = engine.new_cache(B)
        logits, _ = engine._prefill(ids, cache)
        tok = logits[:, len(prompt) - 1, :].argmax(-1)
        del logits
        last = torch.full((B, WINDOW), -1, dtype=torch.long, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        engine._decode_many(tok, cache, len(prompt), last, n_steps, GREEDY)
        times.append(time.perf_counter() - t0)  # the tokens were read
    return times


def steady(engine: InferenceEngine, prompt: List[int], B: int,  # noqa: N803
           n_short: int, n_long: int, reps: int = 3) -> Dict:
    """The step's seconds at batch B from the loop pair, guarded by
    ``timing.differenced`` (the long loop grown up to the cache's n_ctx
    while a long rep takes no longer than a short one; raises
    ``UnresolvedDifference`` if that never resolves): {"step_s",
    "short_s", "long_s" (each rep's seconds), "steps" (the loops' lengths),
    "step_s_range" (the smallest and largest difference any two reps give;
    the smallest is > 0), "tries", "captures_in_timed_reps"}.  Each loop
    length runs once untimed first (its ring's capture)."""
    captures, timing_reps, warmed = [0], [False], set()
    make = engine._make_graph

    def run(n):
        if n not in warmed:
            timed_loop(engine, prompt, B, n, 1)  # capture at this ring
            warmed.add(n)
        timing_reps[0] = True
        try:
            return timed_loop(engine, prompt, B, n, reps)
        finally:
            timing_reps[0] = False

    if make is not None:
        def counting():
            if timing_reps[0]:
                captures[0] += 1
            return make()

        engine._make_graph = counting
    try:
        d = differenced(run, n_short, n_long, engine.n_ctx - len(prompt),
                        what=f"the decode step at B={B}")
    finally:
        engine._make_graph = make
    short, long_ = d["short_s"], d["long_s"]
    dn = d["n_long"] - d["n_short"]
    step_s = (float(np.median(long_)) - float(np.median(short))) / dn
    return dict(step_s=step_s, short_s=short, long_s=long_,
                steps=[d["n_short"], d["n_long"]],
                step_s_range=[(min(long_) - max(short)) / dn,
                              (max(long_) - min(short)) / dn],
                tries=d["tries"], captures_in_timed_reps=captures[0])


def build(args: argparse.Namespace, params=None):
    """(cfg, engine, weight bytes) for ``args``: random Q4 params from seed
    0 (drawn on the card there) unless ``params`` are given."""
    dev = resolve_device(args.device)
    cfg = PRESETS[args.model].replace(n_ctx=args.n_ctx,
                                      compute_dtype="bfloat16",
                                      kv_dtype=args.kv)
    if params is None:
        params = random_q4_params(
            cfg, seed=0, device=dev,
            rng="device" if dev.type == "cuda" else "numpy")
    wbytes = param_bytes(params)
    engine = InferenceEngine(cfg, params, device=dev,
                             decode_chunk=args.decode_chunk,
                             unroll_layers=args.unroll != "off")
    return cfg, engine, wbytes


def measure(args: argparse.Namespace, cfg, engine: InferenceEngine,
            wbytes: int, reps: int = 3, extras: bool = True) -> Dict:
    """The benchmark on a built engine: the headline (batch ``args.batch``)
    first, then the B=1 extras (``extras``); returns the JSON line's
    object."""
    dev = engine.device
    prompt = list(range(1, args.prompt_len + 1))
    n_short = args.decode_chunk
    n_long = max(args.tokens, 2 * n_short)
    batch = args.batch
    run = steady(engine, prompt, batch, n_short, n_long, reps)
    step_bn_s = run["step_s"]
    steady_tps = batch / step_bn_s

    p50_ms = tps = prefill_s = None
    wall = 0.0
    if extras:
        p50_ms = (steady(engine, prompt, 1, n_short, n_long, reps)["step_s"]
                  * 1e3 if batch > 1 else step_bn_s * 1e3)
        engine.generate(prompt, n_predict=args.tokens, sampling=GREEDY)
        t0 = time.perf_counter()
        res = engine.generate(prompt, n_predict=args.tokens, sampling=GREEDY)
        wall = time.perf_counter() - t0
        tps = res.timings["tokens_per_s"]
        prefill_s = res.timings["prefill_s"]

    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
        sol_tps = card_peaks(name)[0] / wbytes
        device = card_label()
    else:
        sol_tps, device = None, "cpu"
    return {
        "metric": f"decode_tokens_per_s_{args.model.replace('-', '_')}_int4",
        "value": round(steady_tps, 3),
        "unit": "tokens/s/chip",
        # batched tokens/s over one stream's speed of light (the memory
        # rate over the Q4 weight bytes a token reads)
        "vs_baseline": (round(steady_tps / sol_tps, 4) if sol_tps else None),
        "extra": {
            "model": args.model,
            "impl": "cuda" if dev.type == "cuda" else "plain",
            "batch": batch,
            "kv_dtype": args.kv,
            "weight_bytes": wbytes,
            "speed_of_light_tokens_per_s_b1": (round(sol_tps, 2)
                                               if sol_tps else None),
            "decode_p50_ms_b1": round(p50_ms, 3) if p50_ms else None,
            "decode_step_ms_batch": round(step_bn_s * 1e3, 3),
            "decode_step_ms_batch_range": [round(x * 1e3, 3)
                                           for x in run["step_s_range"]],
            "reps_s": {"short": [round(x, 5) for x in run["short_s"]],
                       "long": [round(x, 5) for x in run["long_s"]],
                       "steps": run["steps"], "tries": run["tries"]},
            "captures_in_timed_reps": run["captures_in_timed_reps"],
            "e2e_tokens_per_s_b1": (round(tps, 3)
                                    if tps is not None and tps == tps
                                    else None),
            "prefill_s": round(prefill_s, 4) if prefill_s else None,
            "backend": dev.type,
            "device": device,
            "math": q4_cuda.get_dequant_math(),
            "wall_s": round(wall, 2),
        },
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    math_was = q4_cuda.get_dequant_math()
    if args.math:
        q4_cuda.set_dequant_math(args.math)
    try:
        cfg, engine, wbytes = build(args)
        result = measure(args, cfg, engine, wbytes)
        if args.verbose:
            n_long = result["extra"]["reps_s"]["steps"][1]
            monitor.reset()
            phases = _phase_attribution(
                cfg, engine.params, args.batch, args.prompt_len + n_long + 1,
                result["extra"]["decode_step_ms_batch"] / 1e3, engine.device)
            result["extra"]["phase_ms"] = {k: round(v * 1e3, 4)
                                           for k, v in phases.items()}
            print(monitor.report(), file=sys.stderr)
            print(json.dumps(result, indent=2), file=sys.stderr)
    except UnresolvedDifference as e:
        print(f"bench: {e}", file=sys.stderr, flush=True)
        return 1
    finally:
        q4_cuda.set_dequant_math(math_was)
    print(json.dumps(result), flush=True)
    return 0


def _is_q4(w) -> bool:
    from vsim_tpu_torch.ops.matmul import Q4Layer
    from vsim_tpu_torch.quant.q4 import Q4Tensor

    return isinstance(w, (Q4Tensor, Q4Layer))


def _phase_attribution(cfg, params, B: int, kv_len: int,  # noqa: N803
                       t_full_s: float,
                       device: Optional[torch.device] = None) -> Dict:
    """The decode step's time by phase (the reference's show_time_sep,
    monitor.c:196-262), each phase a chain timed by ``monitor.chain_time``
    and recorded in the monitor's table: every Q4 group's matmuls over the
    layers, the lm head, the attention + KV path (the row written by K6's
    one-layer instance, then K3, layer by layer), greedy sampling over the
    padded vocabulary, and the rest of the step.  Returns {phase:
    seconds}."""
    import math

    from vsim_tpu_torch.models.transformer import _quantized_row, init_cache
    from vsim_tpu_torch.ops.decode_attention import (
        decode_attention_q, scatter_rows)
    from vsim_tpu_torch.ops.matmul import q4_matmul

    dev = device or torch.device("cuda")
    bf16 = torch.bfloat16
    L, E = cfg.n_layer, cfg.n_embd  # noqa: N806
    H, D = cfg.n_head, cfg.head_dim  # noqa: N806
    layers = params["layers"]
    out = {"full_step": t_full_s}
    monitor.record("phase/full_step", t_full_s)

    groups = [g for g in ("w_qkv", "wq", "wk", "wv", "wo", "w_fc", "w_proj")
              if g in layers[0] and _is_q4(layers[0][g])]
    t_sum = 0.0
    for g in groups:
        K = layers[0][g].in_features  # noqa: N806

        def mm_step(p, carry, g=g):
            (h,) = carry
            for il in range(L):
                y = q4_matmul(h, p[il][g], compute_dtype=bf16)
                h = h + (y[..., :1] * 1e-9).to(bf16)  # a dependency chain
            return (h,)

        x0 = torch.ones((B, 1, K), dtype=bf16, device=dev)
        t = monitor.chain_time(mm_step, layers, (x0,), reps=4)
        monitor.record(f"phase/q4[{g}]", t, depth=1)
        out[f"q4[{g}]"] = t
        t_sum += t

    V = cfg.n_vocab  # noqa: N806
    if _is_q4(params.get("lm_head")):
        V = params["lm_head"].out_features  # noqa: N806

        def lm_step(p, carry):
            (x,) = carry
            y = q4_matmul(x, p, compute_dtype=bf16)
            return (x + (y[..., :1] * 1e-9).to(bf16),)

        t = monitor.chain_time(lm_step, params["lm_head"],
                               (torch.ones((B, 1, E), dtype=bf16,
                                           device=dev),), reps=4)
        monitor.record("phase/q4[lm_head]", t, depth=1)
        out["q4[lm_head]"] = t
        t_sum += t

    cache = init_cache(cfg, B, n_ctx=max(kv_len, 16), device=dev)
    n_past = torch.full((B,), 8, dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(D)

    def attn_step(p, carry):
        (q,) = carry
        k_all, v_all = cache["k"], cache["v"]
        for il in range(L):
            if isinstance(k_all, tuple):
                scatter_rows(k_all, v_all, _quantized_row(k_all, q, q),
                             n_past, il)
                ctx = decode_attention_q(q[:, 0], k_all, v_all, il, n_past,
                                         scale=scale, round_q=D % 128 == 0)
            else:  # a float cache: the einsum over every row, masked
                k_all[il, :, :, 8] = q[:, 0].to(k_all.dtype)
                v_all[il, :, :, 8] = q[:, 0].to(v_all.dtype)
                s = torch.einsum("bhd,bhsd->bhs", q[:, 0].float(),
                                 k_all[il].float()) * scale
                s[..., 9:] = float("-inf")
                ctx = torch.einsum("bhs,bhsd->bhd", s.softmax(-1),
                                   v_all[il].float())
            q = ctx.to(bf16).view(B, 1, H, D)
        return (q,)

    t = monitor.chain_time(
        attn_step, None,
        (torch.ones((B, 1, H, D), dtype=bf16, device=dev),), reps=4)
    monitor.record("phase/attention_kv", t, depth=1)
    out["attention_kv"] = t
    t_sum += t

    def sample_step(p, carry):
        logits, window = carry
        nxt = sample_torch(logits, window, None, top_k=1, top_p=1.0,
                           temperature=1.0, repeat_penalty=1.0, greedy=True)
        window = torch.cat([window[:, 1:], nxt[:, None]], dim=1)
        return logits + nxt[:, None].to(torch.float32) * 1e-9, window

    t = monitor.chain_time(
        sample_step, None,
        (torch.ones((B, V), dtype=torch.float32, device=dev),
         torch.full((B, WINDOW), -1, dtype=torch.long, device=dev)), reps=4)
    monitor.record("phase/sampling", t, depth=1)
    out["sampling"] = t
    t_sum += t
    out["other"] = max(t_full_s - t_sum, 0.0)
    monitor.record("phase/other(ln,rope,glue)", out["other"], depth=1)
    return out


if __name__ == "__main__":
    sys.exit(main())
