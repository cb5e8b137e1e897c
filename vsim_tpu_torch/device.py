"""Device selection shared by the port's entry points.

Entry points (``InferenceEngine``, ``random_q4_params``, ``init_params``,
``init_cache``) run on the CUDA card unless the caller names another device.
There is no silent CPU continuation: with no card and no explicit device
they raise.
"""

from __future__ import annotations

from typing import Optional, Union

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
