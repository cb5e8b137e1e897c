"""Token sampling (port of vsim_tpu/engine/sampling.py).

Reference math (utils.cpp:339-422): scale by 1/temperature; CTRL repeat
penalty on tokens of the last-n window (negative logits multiplied by the
penalty, positive ones divided); top-k; softmax; top-p keeps the shortest
prefix whose cumulative probability reaches p; draw.

``sample_np`` is the host mirror; ``sample_torch`` runs on the logits'
device with a ``torch.Generator``.  The two give the same distribution but
different streams for one seed; greedy mode is exact in both.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class SamplingParams:
    """Defaults match gpt_params (utils.h:15-34)."""

    temperature: float = 0.9
    top_k: int = 40
    top_p: float = 0.9
    repeat_penalty: float = 1.3
    repeat_last_n: int = 64
    greedy: bool = False
    seed: int = -1  # -1 → time-based


def sample_np(logits: np.ndarray, last_n_tokens: Sequence[int],
              params: SamplingParams, rng: np.random.Generator) -> int:
    """Host-side sampler, a direct functional mirror of utils.cpp:339-422."""
    logits = np.asarray(logits, dtype=np.float64)
    n = logits.shape[-1]
    if params.greedy:
        return int(np.argmax(logits))
    scaled = logits / params.temperature
    if params.repeat_penalty != 1.0 and len(last_n_tokens) > 0:
        idx = np.asarray([t for t in set(last_n_tokens) if 0 <= t < n],
                         dtype=np.int64)
        if idx.size:
            vals = scaled[idx]
            scaled[idx] = np.where(logits[idx] < 0.0,
                                   vals * params.repeat_penalty,
                                   vals / params.repeat_penalty)
    top_k = min(params.top_k, n) if params.top_k > 0 else n
    order = np.argsort(-scaled, kind="stable")[:top_k]
    kept = scaled[order]
    probs = np.exp(kept - kept.max())
    probs /= probs.sum()
    if params.top_p < 1.0:
        cum = np.cumsum(probs)
        cut = int(np.searchsorted(cum, params.top_p) + 1)
        probs = probs[:cut] / cum[cut - 1]
        order = order[:cut]
    choice = rng.choice(len(probs), p=probs)
    return int(order[choice])


def sample_torch(logits: torch.Tensor, last_tokens: torch.Tensor,
                 generator: Optional[torch.Generator], *, top_k: int = 40,
                 top_p: float = 0.9, temperature: float = 0.9,
                 repeat_penalty: float = 1.3, greedy: bool = False,
                 uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits [B, V] f32, last_tokens [B, W] int64 (-1 padded) → [B] int64,
    on the logits' device with no host round trip.  Row b is drawn at
    ``uniform[b]`` in [0, 1) of its kept probabilities' CDF; ``uniform``
    defaults to one draw a row from ``generator`` (the serving engine
    draws one for every slot and passes its own rows', so a stream does
    not depend on which rank holds it)."""
    if greedy:
        return torch.argmax(logits, dim=-1)
    B, V = logits.shape  # noqa: N806
    scaled = logits / temperature
    seen = torch.zeros((B, V + 1), dtype=torch.bool, device=logits.device)
    seen.scatter_(1, torch.where(last_tokens < 0, V, last_tokens), True)
    penalized = torch.where(logits < 0.0, scaled * repeat_penalty,
                            scaled / repeat_penalty)
    scaled = torch.where(seen[:, :V], penalized, scaled)
    k = min(top_k, V) if top_k > 0 else V
    vals, idx = torch.topk(scaled, k, dim=-1)  # sorted, descending
    probs = torch.softmax(vals, dim=-1)
    if top_p < 1.0:
        cum = torch.cumsum(probs, dim=-1)
        probs = torch.where(cum - probs < top_p, probs, 0.0)
        probs = probs / probs.sum(dim=-1, keepdim=True)
    if uniform is None:
        uniform = torch.rand(B, generator=generator, device=logits.device)
    # the first kept entry whose CDF passes u (scaled to the sum)
    cum = torch.cumsum(probs, dim=-1)
    choice = (cum < uniform[:, None] * cum[:, -1:]).sum(dim=-1, keepdim=True)
    return torch.gather(idx, 1, choice)[:, 0]
