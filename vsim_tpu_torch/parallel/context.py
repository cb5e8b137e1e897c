"""Logical-axis sharding context (port of vsim_tpu/parallel/context.py).

The JAX model annotates activations with logical axis names ("batch",
"heads", "embed", ...) and, under a mesh, GSPMD turns those hints into
collectives.  PyTorch has no partitioner: here each rank holds its own
shard (parallel/sharding.py) and runs the model on it, and the context
tells models/transformer.py which collectives to run.  ``constrain``'s
call sites become the few named points where a sharded activation is
reduced or gathered:

  * ``all_reduce``: a row-parallel product's partial sums (after ``wo``
    and ``w_proj``, K split over "heads" / "ffn"), and the vocab-parallel
    embedding's masked lookups;
  * ``gather``: the vocab-parallel lm head's logits, and under sequence
    parallelism the token axis before attention, the MLP and the head.

Both use only ``all_reduce``, which gloo and NCCL both take on CUDA
tensors, so one code path runs over either: a gather is an all-reduce of
each rank's slice placed in a zero buffer, which is exact.  With no mesh,
or a model axis of one rank, nothing runs.

  * ``all_gather``: the serving engine's exchange over the data axis
    (engine/serving.py), each data rank's slots' tokens for the host to
    read: an all-gather of the device tensors over NCCL; over gloo, of the
    tensors brought to the host first, where the engine reads them anyway.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from vsim_tpu_torch.parallel.mesh import Mesh

# default logical-name -> mesh-axis mapping (Megatron-style 2-D mesh)
DEFAULT_RULES: Dict[str, Optional[str]] = {
    "batch": "data",
    "heads": "model",
    "vocab": "model",
    "ffn": "model",
    "embed": None,  # replicated
    # sequence parallelism (Megatron-SP): map "seq" -> "model" via
    # use_mesh(..., rules={"seq": "model"}) to shard the residual stream's
    # token axis through LN/residual segments (prefill and forward_nocache;
    # a one-token decode step has nothing to split).  Off by default.
    "seq": None,
}


class _State(threading.local):
    def __init__(self):
        self.mesh: Optional[Mesh] = None
        self.rules: Dict[str, Optional[str]] = dict(DEFAULT_RULES)


_STATE = _State()


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh], rules: Optional[Dict[str, str]] = None):
    """Activate a mesh (and optional rule overrides) for the model code."""
    prev = (_STATE.mesh, _STATE.rules)
    _STATE.mesh = mesh
    if rules is not None:
        _STATE.rules = {**DEFAULT_RULES, **rules}
    try:
        yield
    finally:
        _STATE.mesh, _STATE.rules = prev


def current_mesh() -> Optional[Mesh]:
    return _STATE.mesh


def logical_spec(*names: Optional[str]) -> Tuple[Optional[str], ...]:
    """Map logical axis names to mesh axes under the current rules (the
    tuple that stands in for a ``PartitionSpec``)."""
    return tuple(_STATE.rules.get(n) if n is not None else None
                 for n in names)


class Axis(NamedTuple):
    """A mesh axis as this rank runs it: its size, this rank's index on
    it, and its process group."""

    size: int
    index: int
    group: object


def axis(logical: str) -> Optional[Axis]:
    """The mesh axis a logical name maps to under the current mesh and
    rules; None when there is no mesh, no mapping, or one rank on it."""
    mesh = _STATE.mesh
    name = _STATE.rules.get(logical)
    if mesh is None or name is None or mesh.size(name) == 1:
        return None
    if mesh.group(name) is None:
        raise ValueError(f"mesh axis {name!r} has {mesh.size(name)} ranks "
                         "but no process group: build the mesh with "
                         "make_mesh over an initialized group")
    return Axis(mesh.size(name), mesh.index(name), mesh.group(name))


def all_reduce(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``ax``, in place (x contiguous)."""
    dist.all_reduce(x, group=ax.group)
    return x


def gather(x: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    """The ranks' slices of ``x`` along ``dim``, concatenated in rank
    order: each rank's slice in a zero buffer, summed (exact)."""
    dim = dim % x.dim()
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * ax.size
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    out.narrow(dim, ax.index * n, n).copy_(x)
    return all_reduce(out, ax)


def all_gather(x: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order, for the
    host to read: gathered on the device over NCCL; over gloo, whose
    collectives go through the host, on the host (the result lies on the
    CPU)."""
    if dist.get_backend(ax.group) == "gloo":
        x = x.cpu()
    parts = [torch.empty_like(x) for _ in range(ax.size)]
    dist.all_gather(parts, x.contiguous(), group=ax.group)
    return torch.cat(parts, dim)


def local(x: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim`` (a view; no collective)."""
    n = x.shape[dim]
    if n % ax.size:
        raise ValueError(f"dimension {dim} of size {n} does not split over "
                         f"{ax.size} ranks")
    return x.narrow(dim, ax.index * (n // ax.size), n // ax.size)
