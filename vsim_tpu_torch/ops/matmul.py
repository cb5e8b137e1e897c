"""Quantized matmul routing (port of vsim_tpu/ops/matmul.py).

``q4_matmul(x, w)`` computes ``x @ dequant(w).T (+ bias)`` for ``w`` of
logical shape [O, K] (a Q4Tensor, one layer of a stacked one as a
``Q4Layer``, or dense), in f32.  Routes, by the rows n of x and the dequant
math (ops/q4_cuda.py:set_dequant_math):

  * n > 128, any Q4 weight                   → dequantize + torch.matmul with
    f32 accumulation (the JAX package leaves this case to XLA); a Q4Layer's
    layer is copied out first
  * plane-split, bf16 x, n <= 8, math "gi"   → K1 ``q4_gemv_ps``
  * plane-split, otherwise                   → K2 ``q4_matmul_ps``, planes
    and x in bf16 or f32 as ``ps_round_planes`` says
  * interleaved ("i") weight                 → K9 ``q4_matmul_i``, f32 planes
  * ``Q4Layer`` (stacked "i" weight)         → K10 ``q4_matmul_stacked``,
    which reads the layer index on the device; bf16 planes and x under
    i32/f32x, f32 under f32xf/gi (``stacked_round_planes``).  K9 and K10
    are one kernel (csrc/q4_matmul_i.cu), one launch a call at every n

``q4_matmul_act_quant`` first Q4_0 quantize-dequantizes x along K (the
reference's matmul INIT phase) and always takes dequantize + torch.matmul,
as the JAX package forces ``impl="xla"`` there.

The plane contracts are decided here, from the math, and handed to the
kernels as a flag.  On CPU tensors the kernels run their plain versions; a
CUDA tensor no kernel takes (a bad shape or dtype) raises, and so does one
that needs a gradient: the kernels have no backward.  Dense (non-Q4)
weights use torch.matmul.  The bias is added in the kernels' epilogue.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
import torch.nn.functional as F

from vsim_tpu_torch.device import torch_dtype
from vsim_tpu_torch.ops.q4_cuda import (
    GEMV_MAX_ROWS,
    MATMUL_MAX_ROWS,
    get_dequant_math,
    q4_gemv_ps,
    q4_matmul_i,
    q4_matmul_ps,
    q4_matmul_stacked,
    stacked_layer,
)
from vsim_tpu_torch.quant.q4 import Q4Tensor, dequantize_km, fake_quantize


@dataclasses.dataclass
class Q4Layer:
    """Layer ``il`` of a stacked Q4 weight.  ``il`` is an int32 tensor on
    the weight's device, never a Python int, so K10 reads it on the card
    and a step makes no host sync (vsim_tpu/ops/matmul.py:Q4Layer)."""

    stacked: Q4Tensor  # packed [L, K/2, O]
    il: torch.Tensor  # int32, one element

    @property
    def out_features(self) -> int:
        return self.stacked.out_features

    def layer(self) -> Q4Tensor:
        """The selected layer as a Q4Tensor of its own (a copy)."""
        return Q4Tensor(stacked_layer(self.stacked.packed, self.il),
                        stacked_layer(self.stacked.scales, self.il),
                        self.stacked.layout)


Weight = Union[Q4Tensor, Q4Layer, torch.Tensor]


def ps_round_planes(n: int, x_dtype: torch.dtype, math_name: str) -> bool:
    """K2's plane contract (pallas_q4.py:541-547, 206-220): bf16 planes and
    x under i32/f32x whatever x's dtype (``pallas_q4_matmul_ps`` passes
    acc_dtype bf16), and under gi for bf16 x at n > 8; f32 otherwise."""
    return math_name in ("i32", "f32x") or (
        math_name == "gi" and n > GEMV_MAX_ROWS and x_dtype == torch.bfloat16)


def stacked_round_planes(math_name: str) -> bool:
    """K10's contract (``pallas_q4_matmul_stacked``, acc_dtype bf16): bf16
    planes and x under i32/f32x, f32 under f32xf and gi."""
    return math_name in ("i32", "f32x")


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
    if not isinstance(w, (Q4Tensor, Q4Layer)):  # dense [O, K]
        y = torch.matmul(x2.to(torch.float32),
                         w.to(cdt).to(torch.float32).T)
        b = _f32_bias(bias, y.shape[-1])
        return (y if b is None else y + b).reshape(*lead, -1)
    b = _f32_bias(bias, w.out_features)
    if n > MATMUL_MAX_ROWS:
        y = _dequant_matmul(x2, w.layer() if isinstance(w, Q4Layer) else w,
                            cdt, b)
        return y.reshape(*lead, -1)
    math_name = get_dequant_math()
    if isinstance(w, Q4Layer):
        if w.stacked.layout != "i":
            raise ValueError("K10 takes stacked interleaved weights, got "
                             f"layout {w.stacked.layout!r}")
        y = q4_matmul_stacked(x2, w.stacked.packed, w.stacked.scales, w.il,
                              b, stacked_round_planes(math_name))
    elif w.layout == "i":
        y = q4_matmul_i(x2, w.packed, w.scales, b)
    elif (cdt == torch.bfloat16 and n <= GEMV_MAX_ROWS
          and math_name == "gi"):
        y = q4_gemv_ps(x2, w.packed, w.scales, b)
    else:
        y = q4_matmul_ps(x2, w.packed, w.scales, b,
                         ps_round_planes(n, x2.dtype, math_name))
    return y.reshape(*lead, -1)


def q4_matmul_act_quant(x: torch.Tensor, w: Weight, *,
                        compute_dtype=torch.float32) -> torch.Tensor:
    """Reference-parity mode: ``x`` Q4_0-quantized along K before the dot,
    then ``x @ dequant(w).T`` in f32 (no bias: the caller adds it)."""
    cdt = torch_dtype(compute_dtype)
    lead, K = x.shape[:-1], x.shape[-1]  # noqa: N806
    xq = fake_quantize(x.reshape(-1, K)).to(cdt)
    if isinstance(w, Q4Layer):
        w = w.layer()
    if not isinstance(w, Q4Tensor):
        return q4_matmul(xq, w, compute_dtype=cdt).reshape(*lead, -1)
    return _dequant_matmul(xq, w, cdt, None).reshape(*lead, -1)
