"""Joining the process group that ``torchrun`` sets up.

The port's counterpart of ``wavedm_tpu/parallel/distributed.py``.  One
process per card, as the original reference runs (``torch.distributed``
over NCCL): ``torchrun --nproc-per-node N`` starts N copies of an entry
point with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` in their environment, and each calls
:func:`initialize_multihost` before it touches a device.  Without those
variables (a plain run) the call does nothing and the port runs as one
process, as JAX's does without a coordinator.

The backend follows the device: NCCL for a CUDA device, gloo for the CPU,
unless the caller names one.  It is never chosen after a failure.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["initialize_multihost", "is_coordinator", "process_index",
           "process_count", "local_device", "collective_device"]

_state = {"device": None}


def initialize_multihost(backend: Optional[str] = None, device=None,
                         init_method: Optional[str] = None,
                         timeout_s: Optional[float] = None) -> bool:
    """Join the process group described by ``torchrun``'s environment;
    returns True when this process is in a group (joined now or before),
    False for a plain run (no ``RANK``/``WORLD_SIZE``: nothing to join).

    ``device``: this process's device; the card ``LOCAL_RANK`` when None
    (raises with no card, as ``resolve_device`` does), and a bare
    ``"cuda"`` also means that card.  A CUDA device becomes the current
    one before the group is joined.  ``backend``: NCCL on a CUDA device and
    gloo on the CPU unless named (gloo also moves CUDA tensors, through
    host copies).  ``init_method``: the rendezvous, ``env://`` (torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``) unless given."""
    if dist.is_initialized():
        return True
    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return False
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    local = int(env.get("LOCAL_RANK", 0))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the port on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = device
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world, **kwargs)
    _state["device"] = device
    return True


def process_index() -> int:
    """This process's rank (0 outside a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes in the group (1 outside a group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    """Rank-0 gating (the reference's ``dist.get_rank() == 0``)."""
    return process_index() == 0


def local_device() -> Optional[torch.device]:
    """The device :func:`initialize_multihost` joined the group with; None
    outside a group."""
    return _state["device"] if dist.is_initialized() else None


def collective_device() -> torch.device:
    """Where small host-born tensors (metric sums, a server's header) go
    for a collective: NCCL takes only CUDA tensors, gloo takes the CPU's."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return local_device()
    return torch.device("cpu")
