"""Decode tokens/s on the mini-Pythia checkpoint (port of
tools/mini_tpu_bench.py): the 25M byte-level model that
``vsim_tpu_torch.tools.train_small`` trains, its weights Q4_0-quantized
by that tool's ``quantize_params``, bf16 compute, int8 KV, B=1 greedy.

    python -m vsim_tpu_torch.tools.mini_tpu_bench [--ckpt build/minipythia]
        [--tokens 256] [--out build/mini_tpu_bench.json] [--device cpu]

The step is the JAX tool's: ``_prefill`` of an 8-byte prompt, then
``_decode_many`` of 32 and of ``--tokens`` steps, the best of three runs
each, differenced over the difference of their lengths.  The difference
is guarded (``timing.differenced``): unless every long run took longer
than every short run, both are measured again with the long loop doubled
(at most up to n_ctx), and if it is still unresolved the tool exits
non-zero with each run's seconds and writes no row.  One cache serves
every run (a prefill rewrites its first rows; a step reads the rows up to
its n_past).  Where REF_BASELINE.json holds the reference binary's row
(``perf.q4_0_t1``: the C program on a CPU, on the same trained model) it is
printed beside this one's, read only.  Writes the rows under build/ and
prints this one's as a JSON line.  Runs on the card; ``--device cpu`` runs
the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional

import torch

from vsim_tpu_torch.device import card_label, resolve_device
from vsim_tpu_torch.timing import UnresolvedDifference, differenced

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PROMPT = [65, 66, 67, 68, 69, 70, 71, 72]
SHORT = 32


def measure(ckpt: str, tokens: int, device) -> Dict:
    """This port's row on ``device``."""
    from vsim_tpu_torch.convert.store import load_params
    from vsim_tpu_torch.engine.generate import InferenceEngine
    from vsim_tpu_torch.engine.sampling import SamplingParams
    from vsim_tpu_torch.tools.train_small import quantize_params

    if tokens <= SHORT:
        raise ValueError(f"--tokens must exceed {SHORT}")
    cfg, params = load_params(ckpt, device=device)
    cfg = cfg.replace(compute_dtype="bfloat16", kv_dtype="int8")
    eng = InferenceEngine(cfg, quantize_params(params), device=device)
    del params
    cache = eng.new_cache(1)
    ids = torch.tensor([PROMPT], device=device)
    greedy = SamplingParams(greedy=True)

    def timed(n_steps):
        logits, _ = eng._prefill(ids, cache)
        tok = logits[:, -1, :].argmax(-1)
        last = torch.full((1, 64), -1, dtype=torch.long, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        eng._decode_many(tok, cache, len(PROMPT), last, n_steps, greedy)
        return time.perf_counter() - t0

    warmed = set()

    def runs(n_steps):
        if n_steps not in warmed:
            timed(n_steps)  # the ring's capture at this length
            warmed.add(n_steps)
        return [timed(n_steps) for _ in range(3)]

    d = differenced(runs, SHORT, tokens, eng.n_ctx - len(PROMPT),
                    what="mini_tpu_bench's decode step")
    per_tok = ((min(d["long_s"]) - min(d["short_s"]))
               / (d["n_long"] - d["n_short"]))
    return {"tokens_per_s": round(1.0 / per_tok, 1),
            "ms_per_token": round(per_tok * 1e3, 4),
            "device": card_label() if device.type == "cuda" else "cpu",
            "kv_dtype": "int8",
            "note": "the trained 25M model, Q4_0 weights; B=1 greedy, "
                    "two _decode_many lengths differenced"}


def reference_row(path: str) -> Optional[Dict]:
    """REF_BASELINE.json's reference-binary row, if the file holds one."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f).get("perf", {}).get("q4_0_t1")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", default=os.path.join(ROOT, "build",
                                                   "minipythia"))
    ap.add_argument("--tokens", type=int, default=256)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "mini_tpu_bench.json"))
    ap.add_argument("--reference", default=os.path.join(ROOT,
                                                        "REF_BASELINE.json"))
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the kernels' "
                         "plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    try:
        row = measure(args.ckpt, args.tokens, dev)
    except UnresolvedDifference as e:
        print(f"mini_tpu_bench: {e}", file=sys.stderr, flush=True)
        return 1
    doc = {"ours_q4_0_b1": row}
    ref = reference_row(args.reference)
    if ref:
        doc["reference_q4_0_t1"] = ref
        if ref.get("tokens_per_s"):
            doc["speedup_vs_reference_q4_t1"] = round(
                row["tokens_per_s"] / ref["tokens_per_s"], 1)
        print(f"reference binary (REF_BASELINE.json, q4_0_t1): "
              f"{ref.get('tokens_per_s')} tokens/s, "
              f"{ref.get('ms_per_token')} ms/token", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
