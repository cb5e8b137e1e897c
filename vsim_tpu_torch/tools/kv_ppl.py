"""KV-cache quantization quality: teacher-forced perplexity through the
decode path (port of tools/kv_ppl.py).

Q4_0 weights (``train_small.quantize_params`` of the trained checkpoint),
f32 compute, and the tokens fed one at a time through the cache: each step
attends over the cache entries of all earlier positions, as production
decode does, for kv_dtype in float32, bfloat16, int8 and int4.  W windows
of T bytes are spaced evenly (``linspace``) over the whole held-out set.
Position 0 seeds the cache (a one-token step at n_past 0); every later
position is one forward step at batch W, replayed from a CUDA graph on the
card (``kv_nll``).

On the card each step runs K10 (``q4_matmul_stacked``, the stacked layer
weights) and K9 (``q4_matmul_i``, the lm head) at n = W; over the int8 and
int4 caches K6's one-layer write (``scatter_rows``) and K3
(``decode_attention_q``), over the float ones the einsum of
``models/transformer.py:_attend_plain``, as the JAX package does.

Updates ``ppl.json`` in the checkpoint's directory (or ``--out``) with the
kv rows and their deltas against float32, and writes ``kv_ppl.json`` beside
it (each dtype's summed NLL, positions and seconds).

Usage:
  python -m vsim_tpu_torch.tools.kv_ppl [--ckpt build/minipythia]
      [--windows 64] [--win-len 512] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F  # noqa: N812

from vsim_tpu_torch.convert.store import load_params
from vsim_tpu_torch.device import resolve_device
from vsim_tpu_torch.engine.generate import graph_maker
from vsim_tpu_torch.engine.graph import GraphedStep
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.models.transformer import forward, init_cache
from vsim_tpu_torch.tools.train_small import (DEFAULT_OUT, build_corpus,
                                              device_name, quantize_params)

KV_DTYPES = ("float32", "bfloat16", "int8", "int4")


def eval_windows(eval_bytes: np.ndarray, windows: int, win_len: int
                 ) -> np.ndarray:
    """[windows, win_len] int64 token ids: windows strided evenly over the
    whole eval set (the first eval files alone read about twice the
    corpus-wide ppl)."""
    if len(eval_bytes) < windows * win_len:
        raise ValueError(f"{len(eval_bytes)} eval bytes hold fewer than "
                         f"{windows} x {win_len}")
    starts = np.linspace(0, len(eval_bytes) - win_len, windows).astype(
        np.int64)
    return np.stack([np.asarray(eval_bytes[s: s + win_len], np.int64)
                     for s in starts])


def kv_nll(cfg: ModelConfig, qparams, ids: torch.Tensor, kv_dtype: str
           ) -> Tuple[float, int]:
    """(summed NLL, positions) of ids [W, T] (on the params' device),
    teacher-forced through a ``kv_dtype`` cache at f32 compute: T - 1
    one-token steps, the first seeding the cache with position 0.

    A step reads its tokens and writes its cache row at an int32 n_past
    [W] that lives on the device (``forward``'s ``write_first`` route:
    the same cache bytes and logits as a scalar n_past), and adds its
    summed NLL in f32 into an f64 total there.  So the step makes no host
    sync, and on the card ``GraphedStep`` replays it from a CUDA graph
    after its first, eager, call; the CPU runs every step eagerly."""
    cfg = cfg.replace(compute_dtype="float32", kv_dtype=kv_dtype)
    W, T = ids.shape  # noqa: N806
    dev = ids.device
    cache = init_cache(cfg, W, n_ctx=T, device=dev)
    n_past = torch.zeros(W, dtype=torch.int32, device=dev)
    total = torch.zeros((), dtype=torch.float64, device=dev)

    def step() -> None:
        at = n_past.long()[:, None]
        logits, _ = forward(cfg, qparams, ids.gather(1, at), cache, n_past,
                            write_first=True)
        total.add_(F.cross_entropy(logits[:, 0], ids.gather(1, at + 1)[:, 0],
                                   reduction="sum").double())
        n_past.add_(1)

    run = GraphedStep(step, graph_maker(dev, None, None))
    with torch.no_grad():
        for _ in range(T - 1):
            run()
    return float(total), W * (T - 1)


def kv_rows(cfg: ModelConfig, qparams, ids: torch.Tensor,
            log: Optional[Callable[[str], None]] = print
            ) -> Dict[str, Dict[str, float]]:
    """``kv_nll`` for each of KV_DTYPES: {dtype: {"nll", "positions",
    "ppl", "seconds"}}."""
    rows = {}
    for kv in KV_DTYPES:
        if ids.device.type == "cuda":
            torch.cuda.synchronize(ids.device)
        t0 = time.perf_counter()
        nll, n = kv_nll(cfg, qparams, ids, kv)
        rows[kv] = dict(nll=nll, positions=n, ppl=float(np.exp(nll / n)),
                        seconds=time.perf_counter() - t0)
        if log:
            log(f"kv={kv}: ppl {rows[kv]['ppl']:.4f} ({n} positions, "
                f"{rows[kv]['seconds']:.0f}s)")
    return rows


def kv_table(rows: Dict[str, Dict[str, float]]) -> Dict[str, float]:
    """The JAX tool's rows: ``kv_<dtype>`` ppl and ``delta_kv_<dtype>_vs_f32``,
    to 4 places."""
    table = {f"kv_{kv}": round(r["ppl"], 4) for kv, r in rows.items()}
    base = table["kv_float32"]
    for kv in rows:
        if kv != "float32":
            table[f"delta_kv_{kv}_vs_f32"] = round(table[f"kv_{kv}"] - base,
                                                   4)
    return table


def main(argv=None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", default=DEFAULT_OUT)
    ap.add_argument("--windows", type=int, default=64)
    ap.add_argument("--win-len", type=int, default=512)
    ap.add_argument("--out", default=None,
                    help="the ppl.json to update (default: the checkpoint's)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the kernels' "
                         "plain versions")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    print(f"device={device_name(dev)}", flush=True)
    cfg, params = load_params(args.ckpt, device=dev)
    qparams = quantize_params(params)
    del params
    _, eval_bytes = build_corpus()
    ids = torch.from_numpy(eval_windows(eval_bytes, args.windows,
                                        args.win_len)).to(dev)
    rows = kv_rows(cfg, qparams, ids, log=lambda s: print(s, flush=True))
    table = kv_table(rows)

    out = args.out or os.path.join(args.ckpt, "ppl.json")
    existing = {}
    if os.path.exists(out):
        with open(out) as f:
            existing = json.load(f)
    existing.update(table)
    with open(out, "w") as f:
        json.dump(existing, f, indent=1)
    with open(os.path.join(os.path.dirname(out) or ".", "kv_ppl.json"),
              "w") as f:
        json.dump(dict(device=device_name(dev), windows=args.windows,
                       win_len=args.win_len, rows=rows), f, indent=1)
    print(f"updated {out}: {json.dumps(table)}", flush=True)
    return table


if __name__ == "__main__":
    main()
