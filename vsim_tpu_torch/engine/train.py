"""Training step over the dense-weight model (port of
vsim_tpu/engine/train.py).

The loss runs the cache-free forward, so attention goes through
``ops/attention.py:flash_attention``: K4 forward and K7/K8 backward on the
card.  Float leaves of the params tree train; Q4 leaves stay frozen.
``step_fn`` updates the params in place (torch tensors are mutable; the JAX
package returns new arrays) and hands back the same tree.

The default optimizer is the JAX package's ``optax.adamw(1e-4)``: lr 1e-4,
betas (0.9, 0.999), eps 1e-8 and decoupled weight decay 1e-4 on every leaf
(optax's ``mask=None``; torch's own default decay is 1e-2).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.models.transformer import forward
from vsim_tpu_torch.quant.q4 import Q4Tensor

OptimizerFactory = Callable[[List[torch.Tensor]], torch.optim.Optimizer]


def cross_entropy_loss(cfg: ModelConfig, params, token_ids: torch.Tensor
                       ) -> torch.Tensor:
    """Next-token cross entropy over a [B, T] batch (cache-free forward)."""
    logits, _ = forward(cfg, params, token_ids[:, :-1], None, 0)
    targets = token_ids[:, 1:]
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1).long())


def float_leaves(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The trainable leaves of a params tree by path ("layers/wq"): every
    floating-point tensor (Q4 weights are skipped)."""
    if isinstance(tree, Q4Tensor):
        return {}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree} if tree.is_floating_point() else {}
    out: Dict[str, torch.Tensor] = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        out.update(float_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def adamw(leaves: List[torch.Tensor]) -> torch.optim.Optimizer:
    """``optax.adamw(1e-4)`` as torch's AdamW."""
    return torch.optim.AdamW(leaves, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def make_train_step(cfg: ModelConfig,
                    optimizer: Optional[OptimizerFactory] = None):
    """Returns (init_fn, step_fn).  ``optimizer`` builds a torch optimizer
    from the list of trainable leaves (default: ``adamw``).

    ``init_fn(params)`` marks the float leaves as requiring grad and returns
    the optimizer (the optimizer state); ``step_fn(params, opt_state,
    token_ids)`` takes one step in place and returns (params, opt_state,
    loss) with the loss detached.  The leaves' ``.grad`` hold the step's
    gradients until the next step."""
    make_opt = optimizer or adamw

    def init_fn(params) -> torch.optim.Optimizer:
        leaves = list(float_leaves(params).values())
        for t in leaves:
            t.requires_grad_(True)
        return make_opt(leaves)

    def step_fn(params, opt_state: torch.optim.Optimizer,
                token_ids: torch.Tensor) -> Tuple[Any, Any, torch.Tensor]:
        opt_state.zero_grad(set_to_none=True)
        loss = cross_entropy_loss(cfg, params, token_ids)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return init_fn, step_fn


def perplexity(cfg: ModelConfig, params, token_ids: torch.Tensor) -> float:
    """Whole-sequence perplexity of a [B, T] batch."""
    with torch.no_grad():
        return float(torch.exp(cross_entropy_loss(cfg, params, token_ids)))
