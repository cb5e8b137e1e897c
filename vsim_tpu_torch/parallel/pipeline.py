"""Pipeline parallelism: GPipe layer stages over a mesh axis (port of
vsim_tpu/parallel/pipeline.py).

The layers split into S contiguous stages, one a rank along the ``pipe``
axis; microbatches stream through the stages in the classic GPipe
fill-steady-drain loop (S - 1 bubble steps).  The JAX package rotates
activations stage to stage with ``ppermute`` inside ``shard_map`` and ends
with a ``psum``; here each rank runs its own stage, and every tick ends in
one hand-off: each rank's output in its slot of a zero buffer
[S, mB, T, E], summed over the axis (an all-reduce, which gloo and NCCL
both take on CUDA tensors; exact, as one rank fills each slot).  Stage s
then takes slot s - 1, and every rank banks the last stage's slot, so the
logits come out on every rank with no final sum.  There is no cross-rank
sum in the maths: the result equals ``forward_nocache`` on each
microbatch bit for bit.

Intended use: whole-sequence evaluation or training of models too deep for
one card.  Decode serving uses tensor parallelism (sharding.py): pipeline
bubbles are hostile to latency-bound decode.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from vsim_tpu_torch.device import torch_dtype
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.models.transformer import (
    alibi_slopes,
    decoder_layer,
    embed_inputs,
    head_logits,
    per_layer,
)
from vsim_tpu_torch.parallel import context as pctx
from vsim_tpu_torch.parallel.mesh import Mesh
from vsim_tpu_torch.quant.q4 import Q4Tensor

AXIS_PIPE = "pipe"


def _layer_range(x, lo: int, hi: int):
    if isinstance(x, Q4Tensor):
        return Q4Tensor(x.packed[lo:hi], x.scales[lo:hi], x.layout)
    return x[lo:hi]


def stage_params(params: Dict[str, Any], n_stages: int,
                 mesh: Mesh) -> Dict[str, Any]:
    """This rank's stage: the stacked layer params [L, ...] cut to its
    contiguous L/S layers (views); embedding and head params are kept
    whole (replicated)."""
    if mesh.size(AXIS_PIPE) != n_stages:
        raise ValueError(f"{n_stages} stages on a mesh with "
                         f"{mesh.size(AXIS_PIPE)} ranks on {AXIS_PIPE!r}")
    layers = params["layers"]
    first = next(iter(layers.values()))
    L = (first.packed if isinstance(first, Q4Tensor) else first).shape[0]  # noqa: N806
    if L % n_stages:
        raise ValueError(f"n_layer {L} % n_stages {n_stages} != 0")
    per = L // n_stages
    lo = mesh.index(AXIS_PIPE) * per
    return dict(params, layers={k: _layer_range(v, lo, lo + per)
                                for k, v in layers.items()})


def pipeline_forward_nocache(cfg: ModelConfig, staged_params: Dict[str, Any],
                             token_ids: torch.Tensor,  # [M, mB, T]
                             mesh: Mesh) -> torch.Tensor:
    """Cache-free forward over microbatches, layer stages pipelined on the
    ``pipe`` axis.  Returns logits [M, mB, T, V] on every rank.

    Schedule: for t in range(M + S - 1), stage s applies its layers to
    microbatch t - s when 0 <= t - s < M (stage 0 embeds it, the others
    take what stage s - 1 handed off last tick), then every rank hands off
    its output; from t = S - 1 on, the last stage's is microbatch
    t - (S - 1)'s, which every rank banks."""
    S = mesh.size(AXIS_PIPE)  # noqa: N806
    stage = mesh.index(AXIS_PIPE)
    ax = pctx.Axis(S, stage, mesh.group(AXIS_PIPE))
    if S > 1 and ax.group is None:
        raise ValueError(f"{S} pipeline stages need a process group")
    M, mB, T = token_ids.shape  # noqa: N806
    dev = token_ids.device
    cdt = torch_dtype(cfg.compute_dtype)
    positions = torch.arange(T, device=dev)[None, :].expand(mB, T)
    slopes = alibi_slopes(cfg.n_head, dev) if cfg.alibi else None
    layers = per_layer(staged_params["layers"], cfg.n_layer // S)

    def apply_stage(h):
        for lp in layers:
            h = decoder_layer(cfg, lp, h, None, None, 0, positions, 0, None,
                              slopes)
        return h

    # An activation handed off takes the memory layout the residual stream
    # has in one process (the embedding's, which the layers keep): the CPU
    # reductions of the layer norms depend on it, and the result is to
    # equal forward_nocache's bit for bit.
    like = embed_inputs(cfg, staged_params, token_ids[0], positions, cdt)

    def received(a):
        return torch.empty_like(like).copy_(a)

    buf, outs = None, []
    for t in range(M + S - 1):
        m = t - stage  # the microbatch this stage holds this tick
        hand = torch.zeros((S, mB, T, cfg.n_embd), dtype=torch.float32,
                           device=dev)
        if 0 <= m < M:
            x = embed_inputs(cfg, staged_params, token_ids[m], positions,
                             cdt) if stage == 0 else buf
            hand[stage] = apply_stage(x)
        if S > 1:
            pctx.all_reduce(hand, ax)
        buf = received(hand[stage - 1]) if stage > 0 else None
        if t >= S - 1:
            outs.append(received(hand[S - 1]))
    return torch.stack([head_logits(cfg, staged_params, x, cdt)
                        for x in outs])
