"""Parameter / KV-cache sharding rules (port of
vsim_tpu/parallel/sharding.py: Megatron-style tensor parallelism).

Layout, as the JAX package's:
  * q/k/v, the fused ``w_qkv`` and ``w_fc`` split their output rows over
    the ``model`` axis (attention heads and ffn neurons);
  * ``wo`` and ``w_proj`` split their contraction dim K (each rank's
    product is a partial sum, models/transformer.py reduces it);
  * ``wte`` and ``lm_head`` split the vocabulary;
  * the biases of row-split weights split with them; everything else
    (layer norms, ``bo``, ``b_proj``) is replicated;
  * the KV cache [L, B, H, S, D] splits its batch over ``data`` and its
    heads over ``model``; an int8/int4 cache's scales [L, B, H, S] with it.

``param_pspecs`` / ``cache_pspec`` return, per leaf, the axis tuple the JAX
functions' ``PartitionSpec`` holds (a ``Q4Spec`` for a Q4 weight), the JAX
degrade included: a leaf whose dims do not divide the mesh is replicated,
its packed bytes and scales each on their own.  ``shard_params`` /
``shard_cache`` return this rank's local tree.  A leaf the specs replicate
is held whole on every rank, where GSPMD would gather it: for a Q4 weight
both arrays whenever either is replicated (a K split that would cut a
32-row block: ``wo`` at E = 64 over 4 ranks), and a K split of a
plane-split weight (byte c holds elements c and c + K/2, so its rows are
not a K slice), as are an lm head or ``wte`` whose vocabulary does not
divide.  models/transformer.py runs a whole weight under a split block on
its gathered input.  What the JAX package cannot place either raises
``ValueError``: cache heads that do not split over ``model`` and cache
rows (``max_batch``) that do not split over ``data``.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from vsim_tpu_torch.parallel.mesh import AXIS_DATA, AXIS_MODEL, Mesh
from vsim_tpu_torch.quant.q4 import Q4Tensor

Spec = Tuple[Any, ...]

# weight-name -> which logical dim is sharded
_ROW_PARALLEL = {"wq", "wk", "wv", "w_qkv", "w_fc"}  # shard O (output rows)
_COL_PARALLEL = {"wo", "w_proj"}  # shard K (contraction)
_ROW_BIAS = {"bq", "bk", "bv", "b_qkv", "b_fc"}
_VOCAB = {"wte", "lm_head"}


class Q4Spec(NamedTuple):
    """The specs of a Q4 weight's two arrays."""

    packed: Spec
    scales: Spec


def _weight_spec(name: str, stacked: bool, k_major: bool) -> Spec:
    """Spec for a weight.  K-major (Q4Tensor) storage is [.., K', O];
    dense storage is the logical [.., O, K]."""
    lead = (None,) if stacked else ()
    if name in _ROW_PARALLEL:  # shard O
        return (*lead, None, AXIS_MODEL) if k_major else (*lead, AXIS_MODEL,
                                                          None)
    if name in _COL_PARALLEL:  # shard K
        return (*lead, AXIS_MODEL, None) if k_major else (*lead, None,
                                                          AXIS_MODEL)
    if name in _VOCAB:  # shard vocab (= O)
        return (None, AXIS_MODEL) if k_major else (AXIS_MODEL, None)
    return ()


def _vec_spec(name: str, stacked: bool) -> Spec:
    lead = (None,) if stacked else ()
    if name in _ROW_BIAS:
        return (*lead, AXIS_MODEL)
    if name == "lm_head_b":
        return (AXIS_MODEL,)
    return ()


def _divisible(shape, spec: Spec, mesh: Mesh) -> bool:
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if ax is not None and dim % mesh.size(ax):
            return False
    return True


def param_pspecs(params: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """Same-structure tree of specs (axis tuples; ``Q4Spec`` for a Q4
    weight).  Any leaf whose shape does not divide the mesh degrades to
    replicated, ``()``."""

    def spec_leaf(name: str, leaf, stacked: bool):
        if isinstance(leaf, Q4Tensor):
            s = _weight_spec(name, stacked, k_major=True)
            return Q4Spec(s if _divisible(leaf.packed.shape, s, mesh) else (),
                          s if _divisible(leaf.scales.shape, s, mesh) else ())
        if leaf.dim() >= 2 and name in (_ROW_PARALLEL | _COL_PARALLEL | _VOCAB):
            s = _weight_spec(name, stacked, k_major=False)
        else:
            s = _vec_spec(name, stacked)
        return s if _divisible(leaf.shape, s, mesh) else ()

    out: Dict[str, Any] = {}
    for k, v in params.items():
        if k == "layers":
            out[k] = {lk: spec_leaf(lk, lv, stacked=True)
                      for lk, lv in v.items()}
        else:
            out[k] = spec_leaf(k, v, stacked=False)
    return out


def cache_pspec(mesh: Mesh, cache=None) -> Dict[str, Any]:
    """KV cache [L, B, H, S, D] (head-major): batch over data, heads over
    model; an int8/int4 cache's ``(values, scales [L, B, H, S])`` pairs
    shard congruently.  (``mesh`` is unused, as in the JAX function.)"""
    s5 = (None, AXIS_DATA, AXIS_MODEL, None, None)
    if cache is not None and isinstance(cache.get("k"), tuple):
        s4 = (None, AXIS_DATA, AXIS_MODEL, None)
        return {"k": (s5, s4), "v": (s5, s4)}
    return {"k": s5, "v": s5}


def local_shard(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (a copy; ``t`` itself when
    nothing splits)."""
    out = t
    for dim, ax in enumerate(spec):
        if ax is None or mesh.size(ax) == 1:
            continue
        n = t.shape[dim] // mesh.size(ax)
        out = out.narrow(dim, mesh.index(ax) * n, n)
    return t if out is t else out.contiguous()


def _model_split(spec: Spec, mesh: Mesh) -> bool:
    return AXIS_MODEL in spec and mesh.size(AXIS_MODEL) > 1


def shard_params(params: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's shard of a params tree (stacked layers, as
    ``param_pspecs`` takes it).  A leaf the specs replicate stays whole;
    so does a Q4 weight whose packed bytes and scales split differently,
    or whose K split is of a plane-split layout."""
    specs = param_pspecs(params, mesh)

    def shard(leaf, spec):
        if not isinstance(leaf, Q4Tensor):
            return local_shard(leaf, spec, mesh)
        split_p, split_s = (_model_split(s, mesh) for s in spec)
        k_split = split_p and spec.packed[-2] == AXIS_MODEL
        if not (split_p and split_s) or (k_split and leaf.layout != "i"):
            return leaf
        return Q4Tensor(local_shard(leaf.packed, spec.packed, mesh),
                        local_shard(leaf.scales, spec.scales, mesh),
                        leaf.layout)

    out: Dict[str, Any] = {}
    for k, v in params.items():
        if k == "layers":
            out[k] = {lk: shard(lv, specs[k][lk]) for lk, lv in v.items()}
        else:
            out[k] = shard(v, specs[k])
    return out


def local_rows(batch: int, mesh: Mesh) -> Tuple[int, int]:
    """(rows, first): this rank's block of ``batch`` cache rows (serving
    slots) over the ``data`` axis; ``ValueError`` where they do not split,
    as the JAX ``device_put`` of ``cache_pspec`` raises."""
    n = mesh.size(AXIS_DATA)
    if batch % n:
        raise ValueError(f"{batch} cache rows (max_batch) do not split over "
                         f"{n} ranks on {AXIS_DATA!r}")
    return batch // n, mesh.index(AXIS_DATA) * (batch // n)


def shard_cache(cache: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's block of a KV cache: [L, B/data, H/model, S, D], its
    scales with it."""
    specs = cache_pspec(mesh, cache)
    out = {}
    for side, store in cache.items():
        values = store[0] if isinstance(store, tuple) else store
        local_rows(values.shape[1], mesh)
        check_heads(values.shape[2], mesh)
        if isinstance(store, tuple):
            out[side] = tuple(local_shard(t, s, mesh)
                              for t, s in zip(store, specs[side]))
        else:
            out[side] = local_shard(store, specs[side], mesh)
    return out


def check_heads(heads: int, mesh: Mesh) -> None:
    """Raise ``ValueError`` where the model axis does not split ``heads``
    into whole heads: the JAX cache cannot be placed there either.  (A Q4
    block a split would cut is held whole: ``shard_params``.)"""
    tp = mesh.size(AXIS_MODEL)
    if heads % tp:
        raise ValueError(f"{heads} heads do not split into whole heads "
                         f"over {tp} ranks")
