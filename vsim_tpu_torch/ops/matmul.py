"""Quantized matmul routing (port of vsim_tpu/ops/matmul.py).

``q4_matmul(x, w)`` computes ``x @ dequant(w).T (+ bias)`` for ``w`` of
logical shape [O, K], in f32.  Routes, by the rows n of x:

  * plane-split weight, bf16 x, n <= 8       → K1 ``q4_gemv_ps``
  * plane-split weight, otherwise n <= 128   → K2 ``q4_matmul_ps``
  * n > 128                                  → dequantize_km + torch.matmul
    with f32 accumulation (the JAX package leaves this case to XLA)
  * interleaved weight on the CPU            → dequantize_km + torch.matmul

On CPU tensors K1 and K2 run their plain versions; a CUDA tensor no kernel
takes (an interleaved weight at n <= 128, a bad shape or dtype) raises.
Dense (non-Q4) weights use torch.matmul.  The bias is added in the kernels'
epilogue, as the Pallas kernels fold it into their output init.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from vsim_tpu_torch.device import torch_dtype
from vsim_tpu_torch.ops.q4_cuda import (
    GEMV_MAX_ROWS,
    MATMUL_MAX_ROWS,
    q4_gemv_ps,
    q4_matmul_ps,
)
from vsim_tpu_torch.quant.q4 import Q4Tensor, dequantize_km

Weight = Union[Q4Tensor, torch.Tensor]


def _f32_bias(bias: Optional[torch.Tensor], width: int):
    if bias is None:
        return None
    b = bias.to(torch.float32)
    if b.shape[-1] != width:  # padded lm head
        b = F.pad(b, (0, width - b.shape[-1]))
    return b.contiguous()


def _dequant_matmul(x: torch.Tensor, w: Q4Tensor, cdt: torch.dtype,
                    bias: Optional[torch.Tensor]) -> torch.Tensor:
    wd = dequantize_km(w, torch.float32)
    if cdt != torch.float32:  # the JAX package dequantizes in compute dtype
        wd = wd.to(cdt).to(torch.float32)
    y = torch.matmul(x.to(torch.float32), wd)
    return y if bias is None else y + bias


def q4_matmul(x: torch.Tensor, w: Weight, *,
              bias: Optional[torch.Tensor] = None,
              compute_dtype=torch.float32) -> torch.Tensor:
    """``x [..., K] @ w.T (+ bias) → [..., O]`` in f32."""
    cdt = torch_dtype(compute_dtype)
    lead, K = x.shape[:-1], x.shape[-1]  # noqa: N806
    x2 = x.reshape(-1, K).to(cdt).contiguous()
    n = x2.shape[0]
    if not isinstance(w, Q4Tensor):  # dense [O, K]
        y = torch.matmul(x2.to(torch.float32),
                         w.to(cdt).to(torch.float32).T)
        b = _f32_bias(bias, y.shape[-1])
        return (y if b is None else y + b).reshape(*lead, -1)
    b = _f32_bias(bias, w.out_features)
    if n > MATMUL_MAX_ROWS:
        y = _dequant_matmul(x2, w, cdt, b)
    elif w.layout == "ps":
        kernel = (q4_gemv_ps if cdt == torch.bfloat16 and n <= GEMV_MAX_ROWS
                  else q4_matmul_ps)
        y = kernel(x2, w.packed, w.scales, b)
    elif x2.device.type == "cpu":
        y = _dequant_matmul(x2, w, cdt, b)
    else:
        raise ValueError(
            f"no CUDA kernel takes a {w.layout!r}-layout Q4 weight at n={n} "
            "rows: plane-split it first (quant/q4.py:to_plane_split)")
    return y.reshape(*lead, -1)
