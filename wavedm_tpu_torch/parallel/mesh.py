"""The data mesh: data-parallel training, FSDP and patch parallelism.

The port's counterpart of ``wavedm_tpu/parallel/mesh.py``.  JAX builds a
one-controller ``Mesh`` over a host's devices; the port runs one process
per card (``parallel/distributed.py``), so a mesh here is the process
group with this process's rank and device:

- data parallelism: each rank holds a contiguous slice of the global batch
  (:func:`shard_batch`, or its own stripe of the dataset), and
  :func:`replicate` wraps the model in DDP, whose backward averages the
  gradients over the ranks (the reference's DDP);
- FSDP: :func:`fsdp_shard` applies FSDP2's ``fully_shard``, so the
  parameters, and with them the gradients, Adam's moments and the EMA
  shadow, live as DTensor shards on dim 0 and are all-gathered on use
  (JAX's ``fsdp_param_shardings`` shards each tensor's largest divisible
  axis instead; FSDP2 shards dim 0 and pads an uneven split);
- patch parallelism: the tiled sampler splits its patch batch over the
  ranks (``diffusion/sampling.py``).

A world of one process needs no group: :func:`make_mesh` then gives a mesh
without one, and every wrapper returns the module as it is.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from wavedm_tpu_torch.config import ConfigError
from wavedm_tpu_torch.parallel.distributed import (collective_device,
                                                   process_count)
from wavedm_tpu_torch.utils.device import resolve_device

__all__ = ["DATA_AXIS", "DataMesh", "make_mesh", "shard_batch", "replicate",
           "fsdp_shard", "unwrap", "grad_sync", "grad_norm", "all_mean",
           "full_tensor", "full_state_dict"]

DATA_AXIS = "data"


@dataclass(frozen=True)
class DataMesh:
    """The 1-D data mesh: the process ``group`` (None for a world of one
    without a group), this process's ``rank`` in it, its ``size`` and this
    process's ``device``."""
    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device

    def broadcast(self, t: torch.Tensor) -> None:
        """Give every rank rank 0's ``t`` (in place)."""
        dist.broadcast(t, dist.get_global_rank(self.group, 0),
                       group=self.group)

    def span(self, n: int):
        """This rank's contiguous range [lo, hi) of ``n`` items split as
        evenly as the ranks allow (the first ``n % size`` ranks get one
        more)."""
        base, extra = divmod(n, self.size)
        lo = self.rank * base + min(self.rank, extra)
        return lo, lo + base + (self.rank < extra)


def make_mesh(n: int = -1, device=None) -> DataMesh:
    """The data mesh over the whole world (``parallel.data_axis``; -1 =
    all processes).  A world of one outside a group gives a mesh without
    a group.  Any other ``n`` than -1 or the world size raises a
    ``ConfigError``: one process drives one card, so the mesh is the
    world."""
    world = process_count()
    if n not in (-1, world):
        raise ConfigError(
            f"parallel.data_axis={n}: the data mesh spans the whole world of "
            f"{world} process(es), one a card; set it to -1 or {world}, or "
            "launch that many processes with torchrun --nproc-per-node")
    group = dist.group.WORLD if dist.is_initialized() else None
    rank = dist.get_rank() if group is not None else 0
    return DataMesh(group, rank, world, resolve_device(device))


def shard_batch(batch, mesh: DataMesh):
    """This rank's contiguous slice of a global batch: an array or tensor,
    or a tuple of them (each sliced on its leading axis, which the mesh
    size must divide)."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(b, mesh) for b in batch)
    n = batch.shape[0]
    if n % mesh.size:
        raise ValueError(f"a global batch of {n} does not split over "
                         f"{mesh.size} ranks")
    per = n // mesh.size
    return batch[mesh.rank * per:(mesh.rank + 1) * per]


def replicate(module: nn.Module, mesh: DataMesh) -> nn.Module:
    """DDP over the mesh (the module as it is for a mesh without a group).
    Every parameter with a gradient must take part in each step
    (``find_unused_parameters=False``); buffers are constants and are not
    broadcast, so a forward on one rank alone (validation) needs no
    collective."""
    if mesh.group is None:
        return module
    from torch.nn.parallel import DistributedDataParallel

    ids = [mesh.device.index] if mesh.device.type == "cuda" else None
    return DistributedDataParallel(module, device_ids=ids,
                                   process_group=mesh.group,
                                   find_unused_parameters=False,
                                   broadcast_buffers=False)


def fsdp_shard(module: nn.Module, mesh: DataMesh) -> nn.Module:
    """FSDP2 (``fully_shard``) over the mesh, in place: every parameter
    becomes a DTensor sharded on dim 0, all-gathered for the forward and
    the backward and resharded after each.  Returns the module (as it is
    for a mesh without a group).  A module on the meta device is sharded
    without communication."""
    if mesh.group is None:
        return module
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.fsdp import fully_shard

    dm = init_device_mesh(mesh.device.type, (mesh.size,),
                          mesh_dim_names=(DATA_AXIS,))
    return fully_shard(module, mesh=dm)


def unwrap(module: nn.Module) -> nn.Module:
    """The module a DDP wrapper holds (the module itself otherwise): the
    parameter names of a world-one run."""
    from torch.nn.parallel import DistributedDataParallel

    return module.module if isinstance(module,
                                       DistributedDataParallel) else module


@contextlib.contextmanager
def grad_sync(module: nn.Module, on: bool):
    """Within it a backward averages gradients over the ranks only when
    ``on``: DDP's ``no_sync`` or FSDP2's ``set_requires_gradient_sync``
    for the micro-batches of a gradient accumulation but the last."""
    from torch.distributed.fsdp import FSDPModule
    from torch.nn.parallel import DistributedDataParallel

    if on:
        yield
    elif isinstance(module, DistributedDataParallel):
        with module.no_sync():
            yield
    elif isinstance(module, FSDPModule):
        module.set_requires_gradient_sync(False)
        try:
            yield
        finally:
            module.set_requires_gradient_sync(True)
    else:
        yield


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def grad_norm(grads) -> torch.Tensor:
    """The 2-norm of all ``grads`` together: of the global gradient, as
    DDP leaves it averaged on every rank, and under FSDP the DTensor total
    over every rank's shards."""
    if grads and _is_dtensor(grads[0]):
        return torch.nn.utils.get_total_norm(grads).full_tensor()
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def all_mean(values: torch.Tensor, mesh: Optional[DataMesh]) -> torch.Tensor:
    """The mean over the ranks of each element of ``values`` (itself for a
    mesh without a group or of one rank)."""
    if mesh is None or mesh.group is None or mesh.size == 1:
        return values
    buf = values.detach().to(collective_device(), torch.float64)
    dist.all_reduce(buf, group=mesh.group)
    return (buf / mesh.size).to(values.device, values.dtype)


def full_tensor(x: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole (every rank must call it); other tensors
    as they are."""
    return x.full_tensor() if _is_dtensor(x) else x


def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The state_dict of a world-one run: the inner module's names, every
    FSDP shard gathered whole (a collective on every rank)."""
    return {k: full_tensor(v)
            for k, v in unwrap(module).state_dict().items()}
