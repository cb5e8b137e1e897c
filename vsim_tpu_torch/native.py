"""Bulk host transforms of the model-loading path: Q4 quantize / dequantize,
the ggml stream ↔ K-major repack and f16 widening (the port's own copy of
what vsim_tpu/native/__init__.py:87-177 gives the JAX package).

The JAX package runs these in a multithreaded C++ library; here they are
vectorised numpy and CPU torch (torch's copies of permuted tensors use every
host core), with the same bytes out.  ``ggml_to_kmajor`` is the hot one: one
pass over a multi-GB weight payload at load.  bf16 arrays are carried as
their uint16 bits, as in ``quant/q4.py``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from vsim_tpu_torch.quant.q4 import (
    DEFAULT_SCALE_DTYPE,
    GGML_BLOCK_BYTES,
    QK,
    _cast_scales_np,
    dequantize_q4_0_np,
    quantize_q4_0_np,
    quantize_q4_0_with_hist_np,
    scales_f32_np,
)


def q4_quantize(w: np.ndarray, with_hist: bool = False):
    """f32 [O, K] → (packed u8 [O, K/2], scales f32 [O, K/32][, hist i64
    [16]]): d = amax/7, q = round-half-away(v/d) + 8 (ggml.c:209-250), the
    histogram as utils.cpp:425-482 counts it."""
    w = np.ascontiguousarray(w, np.float32)
    if with_hist:
        return quantize_q4_0_with_hist_np(w, scale_dtype=torch.float32)
    return quantize_q4_0_np(w, scale_dtype=torch.float32)


def q4_dequantize(packed: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """(packed u8 [O, K/2], scales [O, K/32]) → f32 [O, K]."""
    return dequantize_q4_0_np(np.ascontiguousarray(packed, np.uint8),
                              scales_f32_np(scales))


def ggml_to_kmajor(raw: np.ndarray, O: int, K: int,  # noqa: N803
                   scale_dtype=DEFAULT_SCALE_DTYPE
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """ggml 20-byte-block stream → (packed u8 [K/2, O], scales [K/32, O]),
    scales rounded to ``scale_dtype`` (bf16, the default, as uint16 bits;
    round to nearest even)."""
    nb = K // QK
    flat = np.ascontiguousarray(np.asarray(raw).view(np.uint8).reshape(-1))
    if flat.size != O * nb * GGML_BLOCK_BYTES:
        raise ValueError(f"{flat.size} bytes is not a Q4_0 [{O}, {K}] stream")
    rec = torch.from_numpy(flat).view(O, nb, GGML_BLOCK_BYTES)
    # nibble byte j of block b of row o → packed row 16 b + j, column o
    packed = rec[:, :, 4:].permute(1, 2, 0).contiguous().view(K // 2, O)
    scales = rec[:, :, :4].contiguous().view(torch.float32).view(O, nb)
    return packed.numpy(), _cast_scales_np(scales.t().contiguous().numpy(),
                                           scale_dtype)


def kmajor_to_ggml(packed_km: np.ndarray, scales_km: np.ndarray
                   ) -> np.ndarray:
    """(packed u8 [K/2, O], scales [K/32, O]) → the ggml byte stream, each
    scale widened to the stream's f32."""
    half_k, O = packed_km.shape  # noqa: N806
    nb = half_k // (QK // 2)
    packed = torch.from_numpy(np.ascontiguousarray(packed_km, np.uint8))
    scales = torch.from_numpy(np.ascontiguousarray(scales_f32_np(scales_km)))
    rec = torch.empty((O, nb, GGML_BLOCK_BYTES), dtype=torch.uint8)
    rec[:, :, :4] = scales.t().contiguous().reshape(-1).view(
        torch.uint8).view(O, nb, 4)
    rec[:, :, 4:] = packed.view(nb, QK // 2, O).permute(2, 0, 1)
    return rec.numpy().reshape(-1)


def f16_to_f32(buf: np.ndarray) -> np.ndarray:
    """f16 payload (any dtype holding its bits) → f32, exact."""
    a = np.ascontiguousarray(buf)
    return a.view(np.float16).astype(np.float32).reshape(a.shape)
