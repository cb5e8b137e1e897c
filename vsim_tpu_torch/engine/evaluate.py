"""Perplexity and logit-quality evaluation (port of
vsim_tpu/engine/evaluate.py).

  * ``perplexity(cfg, params, tokens)``: teacher-forced NLL over a token
    stream in non-overlapping windows of ``window`` (default n_ctx) tokens,
    cache-free forward; the first token of each window has no context.
  * ``logit_delta(...)``: max/mean abs logit difference of two
    parameterizations of one model on one prompt.

Both run on the device the params live on.  ``cfg.act_quant`` gives the
reference's matched-bit treatment (activations Q4_0-quantized before each
weight matmul).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.models.init import iter_tensors
from vsim_tpu_torch.models.transformer import forward_nocache


def params_device(params) -> torch.device:
    return next(iter_tensors(params)).device


def perplexity(cfg: ModelConfig, params, tokens: Sequence[int], *,
               window: int = 0) -> Dict[str, float]:
    """{"nll": summed NLL, "tokens": targets counted, "ppl"}.  The last
    window is padded to ``window`` tokens and its pad targets are left out
    of the sum, as in the JAX package, so every window runs one shape."""
    W = window or cfg.n_ctx  # noqa: N806
    toks = np.asarray(list(tokens), np.int64)
    if toks.size < 2:
        raise ValueError("need at least 2 tokens")
    dev = params_device(params)
    total_nll, total_cnt = 0.0, 0
    with torch.no_grad():
        for s in range(0, toks.size - 1, W - 1):
            chunk = toks[s: s + W]
            if chunk.size < 2:
                break
            n = chunk.size - 1
            ids = torch.from_numpy(np.pad(chunk, (0, W - chunk.size)))
            ids = ids[None].to(dev)
            logits = forward_nocache(cfg, params, ids)
            nll = F.cross_entropy(logits[0, :n], ids[0, 1: n + 1],
                                  reduction="sum")
            total_nll += float(nll)
            total_cnt += n
    ppl = float(np.exp(total_nll / max(total_cnt, 1)))
    return {"nll": total_nll, "tokens": total_cnt, "ppl": ppl}


def logit_delta(cfg_a: ModelConfig, params_a, cfg_b: ModelConfig, params_b,
                tokens: Sequence[int]) -> Dict[str, float]:
    """Max/mean abs logit difference of two parameterizations on the same
    prompt, and the share of positions whose argmax agrees."""
    ids = torch.tensor([list(tokens)], dtype=torch.int64)
    with torch.no_grad():
        la, lb = (forward_nocache(c, p, ids.to(params_device(p))).cpu()
                  for c, p in ((cfg_a, params_a), (cfg_b, params_b)))
    d = (la - lb).abs()
    return {"max_abs": float(d.max()), "mean_abs": float(d.mean()),
            "argmax_match": float((la.argmax(-1) == lb.argmax(-1))
                                  .float().mean())}
