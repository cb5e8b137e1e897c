"""HF checkpoint → Q4 checkpoint directory (port of
vsim_tpu/convert/quantize.py), in place of the reference's two-stage
convert_*_to_ggml.py + quantize_{gptj,bloom,gptneox,gpt2}.cpp pipeline:

    python -m vsim_tpu_torch.convert.quantize <hf-model-or-path> <out-dir>
        [--dense] [--scale-dtype bfloat16|float16|float32] [--n-ctx N]

Reads an HF checkpoint (a local directory is read from disk alone),
converts it and Q4_0-quantizes every eligible 2-D weight (the ``.*weight``
rule of quantize_gptneox.cpp:171-185) on the host, and writes a store
directory (``convert/store.py``) that either package loads.  Prints the
16-bin nibble histogram of the run, as the reference quantizers do
(quantize_gptneox.cpp:295-327).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from vsim_tpu_torch.quant.q4 import Q4Tensor


def q4_leaves(tree):
    """Every Q4Tensor of a params tree, in order, a shared one as often as
    it appears (as ``jax.tree.leaves`` walks the JAX package's tree)."""
    if isinstance(tree, Q4Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from q4_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from q4_leaves(v)


def nibble_histogram(params) -> np.ndarray:
    """The 16-bin count of every nibble of every Q4 leaf."""
    hist = np.zeros(16, np.int64)
    for leaf in q4_leaves(params):
        p = leaf.packed.cpu().numpy()
        hist += np.bincount((p & 0x0F).ravel(), minlength=16)
        hist += np.bincount((p >> 4).ravel(), minlength=16)
    return hist


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("model", help="HF model name or local checkpoint path")
    ap.add_argument("out", help="output checkpoint directory")
    ap.add_argument("--dense", action="store_true",
                    help="skip quantization (fp32 reference checkpoint)")
    ap.add_argument("--scale-dtype", default="bfloat16",
                    choices=["bfloat16", "float16", "float32"])
    ap.add_argument("--n-ctx", type=int, default=None)
    args = ap.parse_args(argv)

    from transformers import AutoModelForCausalLM

    from vsim_tpu_torch.convert.hf import convert_hf_model
    from vsim_tpu_torch.convert.store import save_params

    print(f"loading {args.model} ...", flush=True)
    model = AutoModelForCausalLM.from_pretrained(
        args.model, local_files_only=os.path.isdir(args.model))
    cfg, params = convert_hf_model(
        model, quantize=not args.dense, n_ctx=args.n_ctx,
        scale_dtype=args.scale_dtype, device="cpu")
    if not args.dense:
        hist = nibble_histogram(params)
        total = hist.sum()
        print("nibble histogram:",
              " ".join(f"{v / max(total, 1):5.3f}" for v in hist))
    save_params(args.out, cfg, params)
    print(f"wrote {args.out} ({cfg.arch}, quantized={not args.dense})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
