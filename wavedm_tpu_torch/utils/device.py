"""Where the port runs: the CUDA card unless the caller names a device."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The CUDA card unless the caller names a device; in a process group
    (``parallel/distributed.py``) the device this process joined it with,
    ``cuda:LOCAL_RANK`` under torchrun.  Raises when no card is present
    and none was named (the port never drops to the CPU by itself)."""
    if device is not None:
        return torch.device(device)
    from wavedm_tpu_torch.parallel.distributed import local_device

    if local_device() is not None:
        return local_device()
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the port on the CPU")
    return torch.device("cuda")
