"""Ops of the PyTorch port: the Haar wavelet transforms, GroupNorm(+swish)
and GroupNorm -> swish -> conv3x3, each a hand-written CUDA kernel beside
its plain PyTorch version."""

from typing import Dict

__all__ = ["launch_counts", "reset_launch_counts"]


def _counters():
    """(key prefix, the wrapper module's launch counts) of each kernel
    module."""
    from wavedm_tpu_torch.ops import (fused_resblock, groupnorm_cuda,
                                      wavelet_cuda)

    return (("group_norm_", groupnorm_cuda.launches),
            ("", wavelet_cuda.launches), ("", fused_resblock.launches))


def launch_counts() -> Dict[str, int]:
    """Each kernel's launches since the last reset, keyed as the kernel
    table of ``chip_smoke.py`` names them."""
    return {prefix + k: v for prefix, counts in _counters()
            for k, v in counts.items()}


def reset_launch_counts() -> None:
    for _, counts in _counters():
        for key in counts:
            counts[key] = 0
