"""TLC, the test-time local converter, on NCHW tensors.

The port of ``wavedm_tpu/ops/tlc.py``: at inference on images larger than
the training crops, the global average pool inside HFRM's channel
attention becomes a local windowed average whose window scales with the
test-to-train size ratio (``HFRM(tlc=...)``).  The windowed mean comes from
an integral image, as in JAX; it is plain PyTorch (JAX leaves it to XLA,
no Pallas kernel).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = ["local_avg_pool", "tlc_kernel"]


def local_avg_pool(x: torch.Tensor, kernel: Tuple[int, int]) -> torch.Tensor:
    """(B, C, H, W) -> same shape: the mean over each (kh, kw) window of a
    VALID sweep, replicate-padded back to (H, W) centred; ``kernel`` is
    clipped to the input, and a window as large as the input is the
    global mean."""
    h, w = x.shape[2:]
    kh, kw = min(h, kernel[0]), min(w, kernel[1])
    if kh >= h and kw >= w:
        return x.mean(dim=(2, 3), keepdim=True).expand_as(x)
    # integral image with a leading zero row and column
    s = F.pad(x.cumsum(dim=2).cumsum(dim=3), (1, 0, 1, 0))
    out = (s[:, :, kh:, kw:] + s[:, :, :-kh, :-kw] - s[:, :, :-kh, kw:]
           - s[:, :, kh:, :-kw]) / (kh * kw)
    ph, pw = h - out.shape[2], w - out.shape[3]
    return F.pad(out, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2),
                 mode="replicate")


def tlc_kernel(test_hw: Tuple[int, int], train_hw: Tuple[int, int],
               base_hw: Tuple[int, int]) -> Tuple[int, int]:
    """The window of each axis: test_size * base_size // train_size, at
    least 1."""
    return (max(1, test_hw[0] * base_hw[0] // train_hw[0]),
            max(1, test_hw[1] * base_hw[1] // train_hw[1]))
