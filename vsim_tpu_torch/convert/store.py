"""Checkpoint store: params tree ↔ directory of .npy leaves (port of
vsim_tpu/convert/store.py), in the JAX package's format, so a directory
written by either package loads in the other:

  manifest.json   {"format_version": 1, "config": the ModelConfig's fields,
                   "leaves": sorted leaf names, "dtypes": name → dtype name}
  <leaf>.npy      one array per leaf, "/" in a name written as "__"; a Q4
                  weight is two leaves, "<name>.q4packed" and
                  "<name>.q4scales".

The JAX package saves a bfloat16 leaf through ml_dtypes, which .npy records
as raw 2-byte values ("<V2") beside the manifest's "bfloat16"; the port
writes the same header and bytes from the tensor's bits, and reads such a
leaf back through uint16.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from vsim_tpu_torch.device import DeviceLike, resolve_device
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.quant.q4 import Q4Tensor, tensor_from_np

_FORMAT_VERSION = 1


def _flatten(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    if isinstance(tree, Q4Tensor):
        out[prefix + ".q4packed"] = tree.packed
        out[prefix + ".q4scales"] = tree.scales
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree
    else:
        raise TypeError(f"{prefix}: cannot store a {type(tree).__name__} "
                        "(a store holds a tree of dicts, tensors and "
                        "Q4Tensors; an engine's per-layer params are not one)")
    return out


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _save_leaf(fn: str, t: torch.Tensor) -> None:
    a = t.detach().cpu().contiguous()
    if a.dtype != torch.bfloat16:
        np.save(fn, a.numpy())
        return
    # np.save of an ml_dtypes bfloat16 array: descr '<V2', the raw bits
    bits = a.view(torch.int16).numpy()
    with open(fn, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": "<V2", "fortran_order": False, "shape": bits.shape})
        f.write(bits.tobytes())


def save_params(path: str, cfg: ModelConfig, params: Any) -> None:
    os.makedirs(path, exist_ok=True)
    leaves = _flatten(params)
    manifest = {
        "format_version": _FORMAT_VERSION,
        "config": dataclasses.asdict(cfg),
        "leaves": sorted(leaves),
        "dtypes": {name: _dtype_name(t) for name, t in leaves.items()},
    }
    for name, t in leaves.items():
        _save_leaf(os.path.join(path, name.replace("/", "__") + ".npy"), t)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def _load_leaf(fn: str, want: str, mmap: bool) -> np.ndarray:
    arr = np.load(fn, mmap_mode="r" if mmap else None)
    if want == "bfloat16":
        return arr.view(np.uint16)  # tensor_from_np reads it as bf16
    if want and str(arr.dtype) != want:
        return arr.view(np.dtype(want))
    return arr


def load_params(path: str, mmap: bool = False, device: DeviceLike = None
                ) -> Tuple[ModelConfig, Any]:
    """(config, params) from a store directory, the params on ``device``
    (the card unless another is named)."""
    dev = resolve_device(device)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    cfg = ModelConfig(**manifest["config"])
    dtypes = manifest.get("dtypes", {})
    flat = {}
    for name in manifest["leaves"]:
        arr = _load_leaf(os.path.join(path, name.replace("/", "__") + ".npy"),
                         dtypes.get(name), mmap)
        flat[name] = tensor_from_np(arr, dev)

    tree: Dict[str, Any] = {}

    def insert(keypath: str, value):
        parts = keypath.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    for name, t in flat.items():
        if name.endswith(".q4packed"):
            base = name[: -len(".q4packed")]
            insert(base, Q4Tensor(packed=t, scales=flat[base + ".q4scales"]))
        elif not name.endswith(".q4scales"):
            insert(name, t)
    return cfg, tree
