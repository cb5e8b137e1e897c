"""Prefill attention on the card: K4 (the flash kernel) against the einsum
(port of tools/flash_bench.py), in three parts:

  1. the attention stack alone: one L-layer prefill attention pass (no
     matmuls), the einsum (models/transformer.py:_attend_plain, what a
     prefill runs with ``use_flash=False``) against K4, T in {1024, 2048},
     each a chain timed by ``monitor.chain_time``;
  2. the whole-model prefill with ``use_flash`` False and True, T in
     {128, 256, 512, 1024, 2048}: seconds of the forward (best of 3,
     synchronized) and tokens/s;
  3. one long-context decode line: the B=1 step over an n_ctx 2048 int4
     cache nearly full (a 1920-token prompt, then 24-step
     ``_decode_many`` calls; the median ms a step of three).

    python -m vsim_tpu_torch.tools.flash_bench [--model gpt-j-6b]
        [--out build/flash_bench.json] [--skip-model] [--device cpu]

Random Q4 weights from seed 0 (the engines' plane-split params), bf16
compute, int4 KV.  Writes the JSON under build/ (the repo's
FLASH_BENCH.json is the TPU's record) and prints it.  Runs on the card;
``--device cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Dict

import numpy as np
import torch

from vsim_tpu_torch import monitor
from vsim_tpu_torch.device import card_label, resolve_device
from vsim_tpu_torch.models.config import PRESETS, ModelConfig
from vsim_tpu_torch.timing import UnresolvedDifference

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MICRO_T = (1024, 2048)
PREFILL_T = (128, 256, 512, 1024, 2048)
LONG_PROMPT, LONG_STEPS = 1920, 24


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           use_flash: bool) -> torch.Tensor:
    """Causal attention of q [B, T, H, D] over k/v [B, H, T, D] in q's
    dtype, by K4 or by the einsum a prefill runs without it."""
    from vsim_tpu_torch.models.transformer import _attend_plain
    from vsim_tpu_torch.ops.attention import flash_attention

    B, T, H, D = q.shape  # noqa: N806
    if use_flash:
        out = flash_attention(q.transpose(1, 2), k, v, n_past=0,
                              scale=1.0 / math.sqrt(D))
        return out.transpose(1, 2).to(q.dtype)
    return _attend_plain(q, k, v, 0, None, q.dtype)


def attn_micro(cfg: ModelConfig, T: int, use_flash: bool,  # noqa: N803
               device) -> float:
    """Seconds of one L-layer prefill attention stack at [1, T]."""
    H, D, L = cfg.n_head, cfg.head_dim, cfg.n_layer  # noqa: N806
    g = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=device).to(
        torch.bfloat16) for shape in ((1, T, H, D), (1, H, T, D),
                                      (1, H, T, D)))

    def step(params, carry):
        q, k, v = carry
        x = q
        for _ in range(L):
            x = attend(x, k, v, use_flash) + q * 1e-6
        return x, k, v

    return monitor.chain_time(step, None, (q, k, v), reps=3, n_short=2,
                              n_long=6)


def model_prefill(cfg: ModelConfig, params, T: int, use_flash: bool,  # noqa: N803
                  device) -> float:
    """Best of 3 seconds of a [1, T] prefill (``fresh_kv``) with
    ``use_flash``, synchronized."""
    from vsim_tpu_torch.models.transformer import forward, init_cache

    cfg = cfg.replace(use_flash=use_flash)
    ids = torch.zeros((1, T), dtype=torch.long, device=device)
    cache = init_cache(cfg, 1, n_ctx=T, device=device)

    def run():
        logits, _ = forward(cfg, params, ids, cache, 0, fresh_kv=True)
        float(logits[0, 0, 0])  # a read: the forward has ended

    run()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return best


def long_decode(cfg: ModelConfig, params, device) -> Dict:
    """The B=1 step's ms over a nearly full n_ctx-2048 cache."""
    from vsim_tpu_torch.engine.generate import InferenceEngine
    from vsim_tpu_torch.engine.sampling import SamplingParams

    eng = InferenceEngine(cfg, params, device=device)
    cache = eng.new_cache(1)
    ids = torch.arange(1, LONG_PROMPT + 1, device=device)[None] % cfg.n_vocab
    logits, _ = eng._prefill(ids, cache)
    tok = logits[:, -1, :].argmax(-1)
    last = torch.full((1, 64), -1, dtype=torch.long, device=device)
    greedy = SamplingParams(greedy=True)
    n_past, times = LONG_PROMPT, []
    for record in (False, False, True, True, True):
        t0 = time.perf_counter()
        toks = eng._decode_many(tok, cache, n_past, last, LONG_STEPS, greedy)
        if record:
            times.append((time.perf_counter() - t0) / LONG_STEPS)
        tok = toks[-1].to(device)
        n_past += LONG_STEPS
    return {"n_ctx": cfg.n_ctx, "n_past_final": n_past,
            "step_ms_b1": round(float(np.median(times)) * 1e3, 3),
            "note": "B=1 decode over the n_ctx 2048 int4 cache nearly full "
                    "(K3 reads the rows up to n_past)"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="gpt-j-6b", choices=sorted(PRESETS))
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "flash_bench.json"))
    ap.add_argument("--skip-model", action="store_true",
                    help="the attention stack alone (no weights)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the kernels' "
                         "plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = PRESETS[args.model].replace(compute_dtype="bfloat16",
                                      kv_dtype="int4", n_ctx=2048)
    device = card_label() if dev.type == "cuda" else "cpu"
    print(f"device={device} model={args.model}", flush=True)
    try:
        result = {"model": args.model, "device": device, "micro": {},
                  "prefill": {}, "long_decode": {}}
        for T in MICRO_T:  # noqa: N806
            row = {}
            for name, fl in (("einsum", False), ("flash", True)):
                t = attn_micro(cfg, T, fl, dev)
                row[name + "_ms"] = round(t * 1e3, 3)
                print(f"micro T={T} {name}: {t * 1e3:.3f} ms "
                      f"({cfg.n_layer} layers)", flush=True)
            row["flash_speedup"] = round(row["einsum_ms"] / row["flash_ms"], 3)
            result["micro"][str(T)] = row

        if not args.skip_model:
            from vsim_tpu_torch.engine.generate import engine_params
            from vsim_tpu_torch.models.init import random_q4_params

            params = engine_params(cfg, random_q4_params(
                cfg, seed=0, device=dev,
                rng="device" if dev.type == "cuda" else "numpy"), dev)
            for T in PREFILL_T:  # noqa: N806
                row = {}
                for name, fl in (("einsum", False), ("flash", True)):
                    t = model_prefill(cfg, params, T, fl, dev)
                    row[name + "_s"] = round(t, 4)
                    row[name + "_tok_per_s"] = round(T / t, 1)
                    print(f"prefill T={T} {name}: {t * 1e3:.1f} ms = "
                          f"{T / t:.0f} tok/s", flush=True)
                row["flash_speedup"] = round(row["einsum_s"]
                                             / row["flash_s"], 3)
                result["prefill"][str(T)] = row
            result["long_decode"] = long_decode(cfg, params, dev)
            print(f"long-context decode: {result['long_decode']['step_ms_b1']}"
                  " ms/step", flush=True)

    except UnresolvedDifference as e:
        print(f"flash_bench: {e}", file=sys.stderr, flush=True)
        return 1
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
