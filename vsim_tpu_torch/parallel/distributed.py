"""Multi-process runtime (port of vsim_tpu/parallel/distributed.py).

Every rank runs the same program in its own process, on its own device.
``initialize`` joins the ranks into one ``torch.distributed`` process group;
a mesh over them (``global_mesh``) then carries the model's collectives.

Usage (the same program in every process):

    from vsim_tpu_torch.parallel import distributed
    distributed.initialize()             # env- or argument-configured
    mesh = distributed.global_mesh((1, -1))
    ...                                  # ServingEngine(..., mesh=mesh)

Configuration, in priority order: explicit arguments, then the
``VSIM_COORDINATOR`` (host:port of rank 0's store) / ``VSIM_NUM_PROCESSES``
/ ``VSIM_PROCESS_ID`` environment variables, as the JAX package reads them.
With none of them set this is one process and ``initialize`` does nothing.

The backend follows the device, by one rule the caller can override by
naming it: "gloo" on the CPU; on CUDA, "nccl" where every rank has a card
of its own (``local_device_ids``, or rank r on card r of its host, which
needs as many cards as ranks on one host) and "gloo" where ranks share a
card (NCCL refuses two ranks on one card).  Naming "nccl" for ranks that
share a card raises.  ``backend()`` says what was chosen.  Both backends
take the collectives the model runs, all_reduce and broadcast, on CUDA
tensors; gloo copies them through the host.

A rank that dies trips the group's timeout in a waiting collective (gloo
raises; NCCL's watchdog aborts the process) and ``barrier``'s own timeout,
rather than hanging the others.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from vsim_tpu_torch.device import DeviceLike, resolve_device
from vsim_tpu_torch.parallel.mesh import AXIS_DATA, AXIS_MODEL, Mesh

DEFAULT_TIMEOUT_S = 300


class _Runtime:
    """What ``initialize`` set up: this rank's device and the groups."""

    device: Optional[torch.device] = None
    barrier_group = None


_RT = _Runtime()


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v is None else int(v)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None, *,
               backend: Optional[str] = None, device: DeviceLike = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join (or create) the process group.  Idempotent; a no-op when no
    coordinator and no process count are configured (one process).
    ``device``: the device type of the ranks ("cpu", or by default the
    CUDA card, which raises without one); ``local_device_ids``: this
    rank's card index (one id)."""
    if dist.is_initialized():
        return
    coordinator_address = coordinator_address or os.environ.get(
        "VSIM_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("VSIM_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("VSIM_PROCESS_ID")
    if coordinator_address is None and num_processes is None:
        return
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError(
            "a process group needs a coordinator address, a process count "
            "and this process's id (VSIM_COORDINATOR, VSIM_NUM_PROCESSES, "
            f"VSIM_PROCESS_ID): got {coordinator_address!r}, "
            f"{num_processes!r}, {process_id!r}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        if local_device_ids is not None:
            if len(local_device_ids) != 1:
                raise ValueError("one device a rank: local_device_ids must "
                                 f"hold one id, got {list(local_device_ids)}")
            index = int(local_device_ids[0])
            own_card = True
        else:
            index = process_id % count
            own_card = num_processes <= count
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
        chosen = "nccl" if own_card else "gloo"
        if backend == "nccl" and not own_card:
            raise ValueError(f"nccl with {num_processes} ranks on {count} "
                             "card(s): NCCL takes one rank a card; name "
                             "'gloo' or give each rank its own card")
    else:
        dev, chosen = torch.device("cpu"), "gloo"
    backend = backend or chosen
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)
    _RT.device = dev
    # barriers run on the host, over gloo, whatever the model's backend
    _RT.barrier_group = (dist.group.WORLD if backend == "gloo"
                         else dist.new_group(backend="gloo", timeout=timeout))


def shutdown() -> None:
    """Leave the process group (the end of a rank's program)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _RT.device = _RT.barrier_group = None


def is_distributed() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def backend() -> Optional[str]:
    """The process group's backend ("nccl" or "gloo"), None without one."""
    return dist.get_backend() if dist.is_initialized() else None


def local_device() -> torch.device:
    """This rank's device: the one ``initialize`` chose, else the card
    (raising without one, as every entry point)."""
    return _RT.device if _RT.device is not None else resolve_device(None)


def global_mesh(shape: Optional[Tuple[int, ...]] = None,
                axis_names: Sequence[str] = (AXIS_DATA, AXIS_MODEL)) -> Mesh:
    """A mesh over every rank.  ``shape`` may hold -1 for one dimension.
    Default (1, world): every rank tensor parallel (a rank is one device,
    so the JAX package's (hosts, devices per host) default has no
    counterpart)."""
    from vsim_tpu_torch.parallel.mesh import make_mesh

    n = process_count()
    shape = (1, n) if shape is None else tuple(shape)
    if shape.count(-1) > 1:
        raise ValueError(f"at most one -1 in a mesh shape, got {shape}")
    if -1 in shape:
        known = 1
        for d in shape:
            if d != -1:
                known *= d
        shape = tuple(n // known if d == -1 else d for d in shape)
    return make_mesh(shape, axis_names=axis_names, device=local_device())


def barrier(name: str = "vsim_barrier", timeout_s: float = 60) -> None:
    """Every rank waits here; a rank that does not arrive within
    ``timeout_s`` makes the others raise, naming it (failure detection
    rather than a hang)."""
    if not is_distributed():
        return
    try:
        dist.monitored_barrier(group=_RT.barrier_group,
                               timeout=datetime.timedelta(seconds=timeout_s))
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r}: {e}") from e
