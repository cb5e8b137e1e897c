"""Elementwise / normalization building blocks (port of vsim_tpu/ops/layers.py).

LayerNorm computes in f32 and returns the input's dtype; GELU comes in the
tanh approximation (ggml.c:143-146) and the exact erf form (HF default).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, f32 internals (ggml_norm + mul/add)."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * weight.to(torch.float32) + bias.to(torch.float32)
    return y.to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-approx GELU: 0.5x(1+tanh(sqrt(2/pi)(x+0.044715x^3)))."""
    return F.gelu(x, approximate="tanh")


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """erf GELU."""
    return F.gelu(x)


ACTIVATIONS = {
    "gelu_tanh": gelu_tanh,
    "gelu_exact": gelu_exact,
    "gelu": gelu_exact,
    "gelu_new": gelu_tanh,
    "gelu_fast": gelu_tanh,
    "relu": F.relu,
    "silu": F.silu,
}


def get_activation(name: str):
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown activation {name!r}; known: {sorted(ACTIVATIONS)}"
        ) from None
