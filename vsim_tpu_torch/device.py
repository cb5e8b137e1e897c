"""Device selection shared by the port's entry points, and the cards'
peak rates.

Entry points (``InferenceEngine``, ``random_q4_params``, ``init_params``,
``init_cache``) run on the CUDA card unless the caller names another device.
There is no silent CPU continuation: with no card and no explicit device
they raise.  ``card_peaks`` gives a card's memory rate and peak operation
rates (the bounds of chip_smoke.py and the benchmarks' speed of light);
``card_label`` its name and power limit as ``nvidia-smi`` reports them.
"""

from __future__ import annotations

import subprocess
from typing import Optional, Tuple, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA card; anything else is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


_DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16,
    "float16": torch.float16, "int8": torch.int8,
}


def torch_dtype(dt) -> torch.dtype:
    """A torch dtype from a dtype or its name ("int4" is not a torch
    dtype: callers handle it before asking)."""
    if isinstance(dt, torch.dtype):
        return dt
    name = str(dt)
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {dt!r}; known: {sorted(_DTYPES)}")
    return _DTYPES[name]


# Card peaks by name (NVIDIA data sheets, dense): bytes/s, bf16 FLOP/s,
# f32 (non-tensor) FLOP/s.  Looked up by the first key the card's name
# contains, so "H100 PCIe" comes before "H100".
PEAKS = {"H100 PCIe": (2.0e12, 756e12, 51e12),
         "H100": (3.35e12, 989e12, 67e12),
         "H200": (4.8e12, 989e12, 67e12)}
# dense TF32 FLOP/s (NVIDIA data sheets): the second bound of K7/K8's
# "mma_3xtf32" instance, three TF32 products per f32 product
TF32_PEAKS = {"H100 PCIe": 378e12, "H100": 494.7e12, "H200": 494.7e12}


def card_peaks(name: str) -> Tuple[float, float, float]:
    """(bytes/s, bf16 FLOP/s, f32 FLOP/s) of the card named ``name``."""
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    raise ValueError(f"no peak table for card {name!r}")


def card_label() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them (its first
    card)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]
