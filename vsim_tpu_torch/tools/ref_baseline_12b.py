"""The reference binary's decode rate at Pythia-12B's shapes (port of
tools/ref_baseline_12b.py).

    python -m vsim_tpu_torch.tools.ref_baseline_12b [--n-predict 16]
        [--model build/ref12b/pythia12b-q4.bin] [--threads 1]
        [--reference-tree DIR] [--out build/ref_baseline.json]

The golden config is oasst-pythia-12b (Makefile-ubuntu:26).  For decode
speed the weights' values do not matter (the binary streams the same bytes
and does the same arithmetic), so ``write_random_12b`` streams a random
Pythia-12B-shaped Q4_0 ggml file (n_vocab 50288, E 5120, H 40, L 36, F
20480, n_rot 32: the geometry the reference's own notes record), with the
JAX tool's ``CFG``, seed and draw order: the same bytes.  The binary then
runs the golden prompt (``ref_baseline.perf_run``), and the row goes into
``build/ref_baseline.json`` as ``perf.q4_0_t1_12b`` (never the root
REF_BASELINE.json).  The file is about 7.4 GB, so this never runs in
chip_smoke.py.  Without the reference tree the tool stops before the
binary's build, with a message naming the missing tree (exit 2).  Host
CPU only: no card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from vsim_tpu_torch.tools.ref_baseline import (OUT, REF, ROOT,
                                               MissingReference,
                                               build_binary, perf_run)

# the reference's recorded Pythia-12B geometry (vsim.cpp's hparams order)
CFG = dict(n_vocab=50288, n_embd=5120, n_head=40, n_layer=36, n_ff=20480,
           n_rot=32, parallel_residual=1)
GOLDEN_PROMPT = [50278, 12092, 2, 0, 50281]  # Makefile-ubuntu:26
MODEL = os.path.join(ROOT, "build", "ref12b", "pythia12b-q4.bin")


def write_random_12b(path: str, seed: int = 0) -> int:
    """Stream a random Pythia-12B-shaped Q4_0 ggml file to ``path`` (the
    JAX tool's draws, in its order); returns its size in bytes."""
    from vsim_tpu_torch.convert.ggml_file import (FTYPE_F32, FTYPE_Q4_0,
                                                  GGML_NAME_MAPS, GGMLTensor,
                                                  write_ggml)
    from vsim_tpu_torch.quant.q4 import quantize_q4_0_np, to_ggml_q4_0_bytes

    rng = np.random.default_rng(seed)
    names = GGML_NAME_MAPS["gptneox"]
    E, F = CFG["n_embd"], CFG["n_ff"]  # noqa: N806
    V, L = CFG["n_vocab"], CFG["n_layer"]  # noqa: N806

    def q4(shape):
        data = rng.standard_normal(shape, dtype=np.float32) * 0.02
        packed, scales = quantize_q4_0_np(data, scale_dtype=torch.float32)
        return FTYPE_Q4_0, to_ggml_q4_0_bytes(packed, scales), shape

    def f32(shape):
        data = rng.standard_normal(shape, dtype=np.float32) * 0.02
        return (FTYPE_F32,
                np.ascontiguousarray(data).view(np.uint8).reshape(-1), shape)

    tensors = []

    def add(slot, kind, i=None):
        ftype, raw, shape = kind
        tensors.append(GGMLTensor(names[slot].format(i=i), shape, ftype, raw))

    t0 = time.time()
    add("wte", q4((V, E)))
    for i in range(L):
        add("ln1_w", f32((E,)), i)
        add("ln1_b", f32((E,)), i)
        add("wq", q4((E, E)), i)
        add("bq", f32((E,)), i)
        add("wk", q4((E, E)), i)
        add("bk", f32((E,)), i)
        add("wv", q4((E, E)), i)
        add("bv", f32((E,)), i)
        add("wo", q4((E, E)), i)
        add("bo", f32((E,)), i)
        add("ln2_w", f32((E,)), i)
        add("ln2_b", f32((E,)), i)
        add("w_fc", q4((F, E)), i)
        add("b_fc", f32((F,)), i)
        add("w_proj", q4((E, F)), i)
        add("b_proj", f32((E,)), i)
        if i % 6 == 0:
            print(f"  layer {i}/{L} ({time.time() - t0:.0f}s)", flush=True)
    add("ln_f_w", f32((E,)))
    add("ln_f_b", f32((E,)))
    add("lm_head", q4((V, E)))

    hp = dict(n_vocab=V, n_embd=E, n_head=CFG["n_head"], n_layer=L,
              n_rot=CFG["n_rot"],
              use_parallel_residual=CFG["parallel_residual"], ftype=2)
    vocab = [f"<t{i}>".encode() for i in range(V)]
    write_ggml(path, "gptneox", hp, vocab, tensors)
    return os.path.getsize(path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-predict", type=int, default=16)
    ap.add_argument("--model", default=MODEL)
    ap.add_argument("--threads", type=int, default=1)  # the golden value
    ap.add_argument("--reference-tree", default=REF)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    if os.path.abspath(args.out) == os.path.join(ROOT, "REF_BASELINE.json"):
        raise SystemExit("the root REF_BASELINE.json is the TPU tools' "
                         "record: write under build/")
    try:
        binary = build_binary(args.reference_tree)
    except MissingReference as e:
        print(f"ref_baseline_12b: {e}", file=sys.stderr, flush=True)
        return 2
    os.makedirs(os.path.dirname(os.path.abspath(args.model)), exist_ok=True)
    if not os.path.exists(args.model):
        print("writing a random Pythia-12B Q4_0 ggml file ...", flush=True)
        size = write_random_12b(args.model)
        print(f"wrote {args.model}: {size / 1e9:.2f} GB", flush=True)
    row = perf_run(binary, args.model, GOLDEN_PROMPT, args.n_predict,
                   args.threads)
    row["model"] = "pythia-12b-shaped random Q4_0 (identical bytes/compute)"
    row["file_gb"] = round(os.path.getsize(args.model) / 1e9, 2)
    print(json.dumps(row, indent=1), flush=True)
    doc = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            doc = json.load(f)
    doc.setdefault("perf", {})["q4_0_t1_12b"] = row
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"updated {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
