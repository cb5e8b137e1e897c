"""Q4_0 block quantization over torch tensors (port of vsim_tpu/quant/q4.py).

Byte formats are kept exactly, so the two packages' weights compare byte
for byte:

  ``packed``  uint8          [..., K//2,  O]   K-major
  ``scales``  bf16/f32/f16   [..., K//32, O]   one scale per 32-block

Layouts of a packed byte c (``layout``):
  "i"  (ggml order)   elements 2c | 2c+1 (low | high nibble)
  "ps" (plane-split)  elements c | c + K/2, so the two activation planes are
       the contiguous halves of x; the block of element c is c//32 for the
       low nibble and K/64 + c//32 for the high nibble.

Quantization follows ggml.c:209-250: d = amax/7, q = round(v/d) + 8 with C
``round`` (half away from zero).

NumPy has no bfloat16, so the numpy functions here carry a bf16 array as its
uint16 bit pattern; ``tensor_from_np`` turns it back into a bf16 tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from vsim_tpu_torch.device import DeviceLike, resolve_device, torch_dtype

QK = 32  # block size along K (ggml.c:204)
DEFAULT_SCALE_DTYPE = torch.bfloat16


def f32_to_bf16_bits(a: np.ndarray) -> np.ndarray:
    """Round f32 to bf16 (round to nearest even) → uint16 bit pattern."""
    t = torch.from_numpy(np.array(a, dtype=np.float32, copy=True))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _cast_scales_np(d: np.ndarray, scale_dtype) -> np.ndarray:
    dt = torch_dtype(scale_dtype)
    if dt == torch.bfloat16:
        return f32_to_bf16_bits(d)
    if dt == torch.float16:
        return d.astype(np.float16)
    if dt == torch.float32:
        return d.astype(np.float32)
    raise ValueError(f"unsupported scale dtype {scale_dtype!r}")


def tensor_from_np(a: np.ndarray, device: DeviceLike = "cpu") -> torch.Tensor:
    """numpy → torch on ``device``; a uint16 array (or a numpy array of
    dtype name "bfloat16", read through its bits) becomes a bfloat16 tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
    if a.dtype == np.uint16:
        t = torch.from_numpy(np.array(a, copy=True).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _round_half_away_np(v: np.ndarray) -> np.ndarray:
    """C round(): half away from zero (numpy rounds half to even)."""
    return np.floor(np.abs(v) + 0.5) * np.sign(v)


def _round_half_away(v: torch.Tensor) -> torch.Tensor:
    return torch.floor(torch.abs(v) + 0.5) * torch.sign(v)


@dataclasses.dataclass
class Q4Tensor:
    """A weight matrix of logical shape (O, K) stored Q4_0, K-major.
    Leading axes (a stacked layer dim) pass through."""

    packed: torch.Tensor  # uint8 [..., K//2, O]
    scales: torch.Tensor  # [..., K//QK, O]
    layout: str = "i"

    @property
    def shape(self) -> Tuple[int, ...]:
        return (*self.packed.shape[:-2], self.packed.shape[-1],
                self.packed.shape[-2] * 2)

    @property
    def out_features(self) -> int:
        return self.packed.shape[-1]

    @property
    def in_features(self) -> int:
        return self.packed.shape[-2] * 2

    @property
    def device(self) -> torch.device:
        return self.packed.device

    @property
    def nbytes(self) -> int:
        return (self.packed.numel()
                + self.scales.numel() * self.scales.element_size())

    def to(self, device: DeviceLike) -> "Q4Tensor":
        return Q4Tensor(self.packed.to(device), self.scales.to(device),
                        self.layout)

    def layer(self, il: int) -> "Q4Tensor":
        """Layer ``il`` of a stacked [L, K/2, O] weight (a view, no copy)."""
        return Q4Tensor(self.packed[il], self.scales[il], self.layout)

    @classmethod
    def from_dense_np(cls, w: np.ndarray, scale_dtype=DEFAULT_SCALE_DTYPE,
                      device: DeviceLike = None) -> "Q4Tensor":
        """Quantize a dense [..., O, K] numpy weight (row-major view)."""
        dev = resolve_device(device)
        lead = w.shape[:-2]
        O, K = w.shape[-2:]  # noqa: N806
        packed, scales = quantize_q4_0_np(
            np.ascontiguousarray(w, np.float32).reshape(-1, K), scale_dtype)
        packed = packed.reshape(*lead, O, K // 2)
        scales = scales.reshape(*lead, O, K // QK)
        return cls(
            packed=tensor_from_np(np.swapaxes(packed, -1, -2), dev),
            scales=tensor_from_np(np.swapaxes(scales, -1, -2), dev),
        )

    def pad_out(self, multiple: int = 256) -> "Q4Tensor":
        """Zero-pad the output dim to a multiple; padded columns carry scale
        0 and dequantize to exactly 0."""
        pad = (-self.out_features) % multiple
        if pad == 0:
            return self
        return Q4Tensor(
            packed=torch.nn.functional.pad(self.packed, (0, pad)),
            scales=torch.nn.functional.pad(self.scales, (0, pad)),
            layout=self.layout,
        )


def quantize_q4_0_np(w: np.ndarray, scale_dtype=DEFAULT_SCALE_DTYPE
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Quantize fp weights [O, K] → (packed uint8 [O, K//2], scales
    [O, K//QK]); bf16 scales come back as uint16 bits."""
    if w.ndim != 2:
        raise ValueError(f"Q4_0 quantization needs a 2-D matrix, got {w.shape}")
    O, K = w.shape  # noqa: N806
    if K % QK != 0:
        raise ValueError(f"K={K} not a multiple of QK={QK}")
    blocks = np.ascontiguousarray(w, dtype=np.float32).reshape(O, K // QK, QK)
    amax = np.max(np.abs(blocks), axis=-1)
    d = (amax / 7.0).astype(np.float32)
    with np.errstate(divide="ignore"):
        inv = np.where(d != 0.0, np.float32(1.0) / d,
                       np.float32(0.0)).astype(np.float32)
    q = _round_half_away_np(blocks * inv[..., None])
    q = np.clip(q, -8, 7).astype(np.int8) + np.int8(8)
    q = q.astype(np.uint8).reshape(O, K // 2, 2)
    packed = (q[..., 0] | (q[..., 1] << 4)).astype(np.uint8)
    return packed, _cast_scales_np(d, scale_dtype)


def quantize_q4_0(w: torch.Tensor, scale_dtype=DEFAULT_SCALE_DTYPE
                  ) -> Q4Tensor:
    """Q4_0 quantization of an [O, K] tensor on its own device."""
    O, K = w.shape  # noqa: N806
    if K % QK != 0:
        raise ValueError(f"K={K} not a multiple of QK={QK}")
    blocks = w.to(torch.float32).reshape(O, K // QK, QK)
    d = blocks.abs().amax(dim=-1) / 7.0
    inv = torch.where(d != 0.0, 1.0 / torch.where(d != 0.0, d, 1.0),
                      torch.zeros_like(d))
    q = _round_half_away(blocks * inv[..., None]).clamp(-8, 7)
    q = (q.to(torch.int16) + 8).to(torch.uint8).reshape(O, K // 2, 2)
    packed = q[..., 0] | (q[..., 1] << 4)
    return Q4Tensor(packed=packed.T.contiguous(),
                    scales=d.to(torch_dtype(scale_dtype)).T.contiguous())


def to_plane_split(w: Q4Tensor) -> Q4Tensor:
    """Repack an interleaved Q4Tensor to the plane-split layout (scales
    unchanged).  Needs K % 64 == 0 so each plane holds whole 32-blocks."""
    if w.layout == "ps":
        return w
    half_k, O = w.packed.shape[-2:]  # noqa: N806
    if half_k % QK:
        raise ValueError(f"plane-split needs K % 64 == 0, got K={2 * half_k}")
    lead = w.packed.shape[:-2]
    el = torch.stack([w.packed & 0x0F, w.packed >> 4], dim=-2)
    el = el.reshape(*lead, 2 * half_k, O)
    new = el[..., :half_k, :] | (el[..., half_k:, :] << 4)
    return Q4Tensor(packed=new.contiguous(), scales=w.scales, layout="ps")


def unpack_nibbles(packed: torch.Tensor, layout: str) -> torch.Tensor:
    """uint8 [..., K/2, O] → signed int values (v - 8) [..., K, O], int8."""
    lo = (packed & 0x0F).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    if layout == "ps":
        return torch.cat([lo, hi], dim=-2)
    lead = packed.shape[:-2]
    half_k, O = packed.shape[-2:]  # noqa: N806
    return torch.stack([lo, hi], dim=-2).reshape(*lead, 2 * half_k, O)


def dequantize_km(w: Q4Tensor, dtype=torch.float32) -> torch.Tensor:
    """Dequantize, K-major result [..., K, O] (matmul-ready)."""
    q = unpack_nibbles(w.packed, w.layout)
    s = w.scales.to(dtype).repeat_interleave(QK, dim=-2)
    return q.to(dtype) * s


def fake_quantize(w: torch.Tensor, scale_dtype=torch.float32) -> torch.Tensor:
    """Q4_0 quantize-dequantize round trip of an [O, K] tensor, f32 out:
    d = amax/7 per 32-block, q = round(v/d) (half away from zero) clipped
    to [-8, 7], v' = q·d with d cast through ``scale_dtype``.  The
    reference's activation treatment in the matmul INIT phase
    (ggml.c:5030-5038)."""
    O, K = w.shape  # noqa: N806
    blocks = w.to(torch.float32).reshape(O, K // QK, QK)
    d = blocks.abs().amax(dim=-1) / 7.0
    inv = torch.where(d != 0.0, 1.0 / torch.where(d != 0.0, d, 1.0), 0.0)
    q = _round_half_away(blocks * inv[..., None]).clamp(-8, 7)
    deq = q * d.to(torch_dtype(scale_dtype)).to(torch.float32)[..., None]
    return deq.reshape(O, K)


def q4_take_rows(w: Q4Tensor, ids: torch.Tensor,
                 dtype=torch.float32) -> torch.Tensor:
    """Gather + dequantize logical rows (axis O) → [..., K] (ggml GET_ROWS
    on a quantized wte).  Embeddings stay in the interleaved layout."""
    if w.layout != "i":
        raise ValueError("q4_take_rows needs the interleaved layout")
    flat = ids.reshape(-1)
    packed = w.packed[:, flat]  # [K/2, N]
    scales = w.scales[:, flat]  # [K/32, N]
    q = unpack_nibbles(packed, "i")  # [K, N]
    x = q.to(dtype) * scales.to(dtype).repeat_interleave(QK, dim=0)
    return x.T.reshape(*ids.shape, w.in_features)
