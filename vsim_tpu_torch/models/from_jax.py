"""Carry a params tree across from the JAX package.

``params_from_numpy`` takes the JAX package's params tree after
``np.asarray`` on every leaf and returns the port's params.  Q4 leaves are
duck-typed (anything with ``.packed``, ``.scales`` and ``.layout``); bf16
arrays are read through their uint16 bits, so no bfloat16 numpy dtype is
needed here.  Stacked weights stay stacked; per-layer tuples become lists.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from vsim_tpu_torch.device import DeviceLike, resolve_device
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.quant.q4 import Q4Tensor, tensor_from_np


def _is_q4(leaf) -> bool:
    return all(hasattr(leaf, a) for a in ("packed", "scales", "layout"))


def _convert(leaf, dev):
    if _is_q4(leaf):
        return Q4Tensor(packed=tensor_from_np(np.asarray(leaf.packed), dev),
                        scales=tensor_from_np(np.asarray(leaf.scales), dev),
                        layout=leaf.layout)
    if isinstance(leaf, dict):
        return {k: _convert(v, dev) for k, v in leaf.items()}
    if isinstance(leaf, (list, tuple)):
        return [_convert(v, dev) for v in leaf]
    return tensor_from_np(np.asarray(leaf), dev)


def params_from_numpy(cfg: ModelConfig, tree: Any,
                      device: DeviceLike = None) -> dict:
    """The port's params from a JAX params tree with numpy leaves."""
    dev = resolve_device(device)
    params = _convert(tree, dev)
    if "layers" not in params or "lm_head" not in params:
        raise ValueError("not a params tree: needs 'layers' and 'lm_head'")
    n = cfg.n_layer
    for k, v in params["layers"].items():
        lead = len(v) if isinstance(v, list) else (
            v.packed.shape[0] if isinstance(v, Q4Tensor) else v.shape[0])
        if lead != n:
            raise ValueError(f"layers[{k!r}] holds {lead} layers, config "
                             f"says {n}")
    return params
