"""Where the serving step's time goes beside the plain decode step (port of
tools/serve_profile.py): the SAME batched forward at B=64 under each
serving ingredient apart, each a chain of steps timed at two lengths and
differenced (``monitor.chain_time``: on the card one CUDA graph a chain,
its replays timed with CUDA events):

  uniform      an int n_past, every row at one length: the row written by
               slicing, then K3 (the engine's plain batched step);
  ragged       n_past an int32 [B] device tensor, all rows equal: the
               serving step's deferred route (K5 over the quantized fresh
               row, then one all-layer K6 write after the layer loop);
  ragged+mask  adds the serving step's bookkeeping: active mask, token
               budget and shared stop ids (engine/serving.py:_serve_step).

    python -m vsim_tpu_torch.tools.serve_profile [--model gpt-j-6b]
        [--batch 64] [--kv int8] [--n-ctx 512] [--device cpu]

Random Q4 weights from seed 0, bf16 compute, a zero cache at n_past 8 (as
the JAX tool's), row b's first token b (the JAX tool's are all 0).  The
JAX tool's ``--kv-len`` has no counterpart: K3 and K5 read the rows up to
n_past.  Prints the ms a step of each mode, then one JSON line.  Runs on
the card; ``--device cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Tuple

import torch

from vsim_tpu_torch import monitor
from vsim_tpu_torch.device import card_label, resolve_device
from vsim_tpu_torch.engine.sampling import sample_torch
from vsim_tpu_torch.models.config import PRESETS, ModelConfig
from vsim_tpu_torch.models.transformer import forward, init_cache
from vsim_tpu_torch.timing import UnresolvedDifference

MODES = ("uniform", "ragged", "ragged+mask")
N_PAST0 = 8
WINDOW = 64


def make_step(mode: str, cfg: ModelConfig, n_ctx: int, cache):
    """(step_fn(params, carry) -> carry, initial carry) of ``mode`` over
    ``cache``'s B rows; carry[0] is the tokens [B] a step emits."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; known: {MODES}")
    k = cache["k"]
    B = (k[0] if isinstance(k, tuple) else k).shape[1]  # noqa: N806
    dev = (k[0] if isinstance(k, tuple) else k).device
    greedy = dict(top_k=0, top_p=1.0, temperature=1.0, repeat_penalty=1.0,
                  greedy=True)
    stop_ids = torch.full((4,), -1, dtype=torch.long, device=dev)  # none

    def step(params, carry):
        tok, nps, npv, active, remaining, last = carry
        if mode == "uniform":
            logits, _ = forward(cfg, params, tok[:, None], cache, nps)
        else:
            np_eff = (torch.where(active, npv, n_ctx)
                      if mode == "ragged+mask" else npv)
            logits, _ = forward(cfg, params, tok[:, None], cache, np_eff)
        nxt = sample_torch(logits[:, -1, :], last, None, **greedy)
        if mode == "ragged+mask":
            nxt = torch.where(active, nxt, tok)
            last = torch.where(active[:, None],
                               torch.cat([last[:, 1:], nxt[:, None]], 1),
                               last)
            npv = torch.where(active, npv + 1, npv)
            remaining = torch.where(active, remaining - 1, remaining)
            hit = (nxt[:, None] == stop_ids[None, :]).any(dim=1)
            active = active & ~hit & (remaining > 0)
        else:
            last = torch.cat([last[:, 1:], nxt[:, None]], dim=1)
            npv = npv + 1
        return nxt, nps + 1, npv, active, remaining, last

    init = (torch.arange(B, device=dev) % cfg.n_vocab, N_PAST0,
            torch.full((B,), N_PAST0, dtype=torch.int32, device=dev),
            torch.ones(B, dtype=torch.bool, device=dev),
            torch.full((B,), 10 ** 6, dtype=torch.int32, device=dev),
            torch.full((B, WINDOW), -1, dtype=torch.long, device=dev))
    return step, init


def mode_tokens(mode: str, cfg: ModelConfig, params, B: int,  # noqa: N803
                n_ctx: int, n_steps: int, device) -> torch.Tensor:
    """The tokens [n_steps, B] of ``n_steps`` eager steps of ``mode`` on a
    fresh zero cache."""
    cache = init_cache(cfg, B, n_ctx=n_ctx, device=device)
    step, carry = make_step(mode, cfg, n_ctx, cache)
    out = []
    for _ in range(n_steps):
        carry = step(params, carry)
        out.append(carry[0])
    return torch.stack(out).cpu()


def profile(cfg: ModelConfig, params, B: int, n_ctx: int,  # noqa: N803
            device, reps: int = 3) -> Dict[str, float]:
    """{mode: ms a step}, each from a chain of 4 and of 20 steps (the long
    chain grown, if it must be, only as far as the cache holds)."""
    out = {}
    for mode in MODES:
        cache = init_cache(cfg, B, n_ctx=n_ctx, device=device)
        step, init = make_step(mode, cfg, n_ctx, cache)
        out[mode] = monitor.chain_time(step, params, init, reps=reps,
                                       n_short=4, n_long=20,
                                       n_max=n_ctx - N_PAST0) * 1e3
        del cache
    return out


def build(model: str, kv: str, n_ctx: int, device) -> Tuple:
    """(cfg, the engines' params on ``device``): random Q4 from seed 0."""
    from vsim_tpu_torch.engine.generate import engine_params
    from vsim_tpu_torch.models.init import random_q4_params

    cfg = PRESETS[model].replace(n_ctx=n_ctx, kv_dtype=kv,
                                 compute_dtype="bfloat16")
    params = random_q4_params(cfg, seed=0, device=device,
                              rng="device" if device.type == "cuda"
                              else "numpy")
    return cfg, engine_params(cfg, params, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="gpt-j-6b", choices=sorted(PRESETS))
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--kv", default="int8",
                    choices=["bfloat16", "float32", "int8", "int4"])
    ap.add_argument("--n-ctx", type=int, default=512)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the kernels' "
                         "plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg, params = build(args.model, args.kv, args.n_ctx, dev)
    try:
        ms = profile(cfg, params, args.batch, args.n_ctx, dev)
    except UnresolvedDifference as e:
        print(f"serve_profile: {e}", file=sys.stderr, flush=True)
        return 1
    for mode in MODES:
        print(f"{mode:12s} step = {ms[mode]:7.3f} ms  (B={args.batch}, "
              f"kv={args.kv})", flush=True)
    print(json.dumps({"model": args.model, "batch": args.batch,
                      "kv_dtype": args.kv, "n_ctx": args.n_ctx,
                      "step_ms": {k: round(v, 4) for k, v in ms.items()},
                      "device": card_label() if dev.type == "cuda"
                      else "cpu"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
