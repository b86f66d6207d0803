"""The Laplacian-pyramid domain transform on NCHW tensors.

The port of ``wavedm_tpu/models/laplacian.py`` (``data.lap``): a fixed
5x5 Gauss-kernel pyramid decomposition and reconstruction
(:class:`LaplacianPyramid`), and the learned high-frequency translator
(:class:`TransHigh` inside :class:`LapHighTrans`) that predicts per-level
masks.  The Gauss filter is a plain depthwise conv over a reflect-padded
input, as it is plain XLA in JAX.

Where a level's size is odd, the 2x upsampled coarser level is resized to
it with nearest-neighbour sampling at half-pixel centres, which is
``jax.image.resize(..., "nearest")`` and torch's ``"nearest-exact"`` (not
``"nearest"``: the two part on odd sizes).

The translator's module names are the JAX tree's (``trans_high.res_0``,
``trans_high.trans_0_in``), so ``utils/convert.py`` carries its
parameters across by name.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["LaplacianPyramid", "TransHigh", "LapHighTrans"]

_GAUSS = np.array(
    [[1., 4., 6., 4., 1.],
     [4., 16., 24., 16., 4.],
     [6., 24., 36., 24., 6.],
     [4., 16., 24., 16., 4.],
     [1., 4., 6., 4., 1.]], dtype=np.float32) / 256.0


def _conv_gauss(img: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Depthwise 5x5 Gaussian with reflect padding."""
    c = img.shape[1]
    k = torch.as_tensor(_GAUSS * scale, dtype=img.dtype, device=img.device)
    img = F.pad(img, (2, 2, 2, 2), mode="reflect")
    return F.conv2d(img, k.expand(c, 1, 5, 5), groups=c)


def _downsample(x: torch.Tensor) -> torch.Tensor:
    return x[:, :, ::2, ::2]


def _upsample(x: torch.Tensor) -> torch.Tensor:
    """Zero-stuff 2x, then smooth with 4x the kernel."""
    b, c, h, w = x.shape
    up = x.new_zeros((b, c, 2 * h, 2 * w))
    up[:, :, ::2, ::2] = x
    return _conv_gauss(up, scale=4.0)


def _resize_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    if tuple(x.shape[2:]) == (h, w):
        return x
    return F.interpolate(x, size=(h, w), mode="nearest-exact")


class LaplacianPyramid:
    """The fixed (parameter-free) pyramid: ``num_high`` high-frequency
    bands, finest first, then the low band."""

    def __init__(self, num_high: int = 3):
        self.num_high = num_high

    def decompose(self, img: torch.Tensor) -> List[torch.Tensor]:
        current, pyr = img, []
        for _ in range(self.num_high):
            down = _downsample(_conv_gauss(current))
            up = _resize_to(_upsample(down), *current.shape[2:])
            pyr.append(current - up)
            current = down
        pyr.append(current)
        return pyr

    def reconstruct(self, pyr: Sequence[torch.Tensor]) -> torch.Tensor:
        image = pyr[-1]
        for level in reversed(pyr[:-1]):
            image = _resize_to(_upsample(image), *level.shape[2:]) + level
        return image


class _ResBlock(nn.Module):
    def __init__(self, features: int, res_dim: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(features, res_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(res_dim, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(F.leaky_relu(self.conv1(x), 0.01))


class TransHigh(nn.Module):
    """Per-level masks that translate the high-frequency bands."""

    def __init__(self, num_residual_blocks: int = 3, res_dim: int = 64,
                 num_high: int = 3):
        super().__init__()
        self.num_residual_blocks, self.num_high = num_residual_blocks, num_high
        self.conv_in = nn.Conv2d(6, 64, 3, padding=1)
        for i in range(num_residual_blocks):
            self.add_module(f"res_{i}", _ResBlock(64, res_dim))
        self.conv_mask = nn.Conv2d(64, 3, 3, padding=1)
        for i in range(num_high):
            self.add_module(f"trans_{i}_in", nn.Conv2d(3, 16, 1))
            for j in range(num_residual_blocks):
                self.add_module(f"trans_{i}_res_{j}", _ResBlock(16, res_dim))
            self.add_module(f"trans_{i}_out", nn.Conv2d(16, 3, 1))

    def forward(self, x: torch.Tensor,
                pyr_original: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        nres = self.num_residual_blocks
        h = F.leaky_relu(self.conv_in(x), 0.01)
        for i in range(nres):
            h = getattr(self, f"res_{i}")(h)
        mask = self.conv_mask(h)
        results = []
        for i in range(self.num_high):
            lvl = pyr_original[-2 - i]
            mask = _resize_to(mask, *lvl.shape[2:])
            t = F.leaky_relu(getattr(self, f"trans_{i}_in")(lvl * mask + lvl),
                             0.01)
            for j in range(nres):
                t = getattr(self, f"trans_{i}_res_{j}")(t)
            results.append(getattr(self, f"trans_{i}_out")(t))
        return list(reversed(results)) + [pyr_original[-1]]


class LapHighTrans(nn.Module):
    """Feeds [second-coarsest high band | upsampled low band] to
    :class:`TransHigh`."""

    def __init__(self, res_num: int = 3, res_dim: int = 64,
                 num_high: int = 3):
        super().__init__()
        self.trans_high = TransHigh(res_num, res_dim, num_high)

    def forward(self, pyr: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        low_up = _resize_to(pyr[-1], *pyr[-2].shape[2:])
        return self.trans_high(torch.cat([pyr[-2], low_up], dim=1), pyr)
