"""Rotary position embeddings, NeoX (rotate-half) and GPT-J (interleaved).
Port of vsim_tpu/ops/rope.py.

For position p and pair i among the first ``n_rot`` head dims,
theta_i = base^(-2i/n_rot).  NeoX pairs (x[i], x[i + n_rot/2]); GPT-J pairs
adjacent dims (x[2i], x[2i+1]).  Dims beyond ``n_rot`` pass through.  The
rotation runs in f32 and returns the input dtype.
"""

from __future__ import annotations

import torch


def rope_angles(positions: torch.Tensor, n_rot: int, base: float = 10000.0):
    """(cos, sin), each [..., n_rot // 2] f32, for int positions [...]."""
    half = n_rot // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    inv_freq = base ** (-2.0 * idx / n_rot)
    ang = positions.to(torch.float32)[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope_neox(x: torch.Tensor, positions: torch.Tensor, n_rot: int,
                    base: float = 10000.0) -> torch.Tensor:
    """x [..., T, H, D]; positions [..., T]."""
    half = n_rot // 2
    cos, sin = rope_angles(positions, n_rot, base)
    cos, sin = cos[..., None, :], sin[..., None, :]  # broadcast over heads
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:n_rot].to(torch.float32)
    r1 = (cos * x1 - sin * x2).to(x.dtype)
    r2 = (cos * x2 + sin * x1).to(x.dtype)
    return torch.cat([r1, r2, x[..., n_rot:]], dim=-1)


def apply_rope_gptj(x: torch.Tensor, positions: torch.Tensor, n_rot: int,
                    base: float = 10000.0) -> torch.Tensor:
    """Interleaved-pair RoPE (GPT-J / CodeGen): pairs (2i, 2i+1)."""
    half = n_rot // 2
    cos, sin = rope_angles(positions, n_rot, base)
    cos, sin = cos[..., None, :], sin[..., None, :]
    xr = x[..., :n_rot]
    lead = xr.shape[:-1]
    pairs = xr.reshape(*lead, half, 2).to(torch.float32)
    x1, x2 = pairs[..., 0], pairs[..., 1]
    r1 = cos * x1 - sin * x2
    r2 = cos * x2 + sin * x1
    out = torch.stack([r1, r2], dim=-1).reshape(*lead, n_rot).to(x.dtype)
    return torch.cat([out, x[..., n_rot:]], dim=-1)


def apply_rope(x, positions, n_rot, *, interleaved: bool,
               base: float = 10000.0):
    if n_rot <= 0:
        return x
    fn = apply_rope_gptj if interleaved else apply_rope_neox
    return fn(x, positions, n_rot, base)
