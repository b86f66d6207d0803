"""SAM, the spatial attentive module with 8-direction IRNN sweeps, on NCHW
tensors.

The port of ``wavedm_tpu/models/sam.py``, dormant in the reference (only
the unused ``RRDB`` builds one), with the reference's key names
(``tests/golden/sam_small.npz``: ``irnn1.left_weight``, ...).  Each
directional sweep is the nonlinear recurrence out[i] = relu(out[i-1] * w +
x[i]) along rows or columns, run as a loop over the axis (JAX: a
``lax.scan``).  The reference's quirks, which JAX keeps, are kept:

- the four diagonal sweeps all use ``down_weight``; their own weights
  exist and are never read;
- its "direction attention" multiplies without assigning the result, so
  the attention head's output is never used: its parameters exist
  (``attention_layer``) and it is not run;
- ``conv_in`` exists and is never applied;
- entries no sweep reaches keep their input value.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["IRNNLayer", "ChannelAttentionSAM", "SpatialAttentionSAM",
           "SAMAttention", "SAM"]

_WEIGHTS = ("left_weight", "right_weight", "up_weight", "down_weight",
            "zuoshang_weight", "zuoxia_weight", "youshang_weight",
            "youxia_weight")


def _sweep(x: torch.Tensor, w: torch.Tensor, dim: int, reverse: bool,
           shift: int = 0) -> torch.Tensor:
    """The recurrence along ``dim`` (2: rows, 3: columns), from the last
    entry backwards with ``reverse``; ``shift`` moves the carry one entry
    along the other spatial axis a step (the diagonals), and the entries
    the shifted carry leaves uncovered keep their input."""
    xs = x.unbind(dim)
    order = range(len(xs) - 1, -1, -1) if reverse else range(len(xs))
    out = [None] * len(xs)
    carry = None
    for i in order:
        xi = xs[i]
        if carry is None:
            carry = xi
        else:
            new = F.relu(torch.roll(carry, shift, dims=-1) * w + xi)
            if shift > 0:
                new = torch.cat([xi[..., :shift], new[..., shift:]], dim=-1)
            elif shift < 0:
                new = torch.cat([new[..., :shift], xi[..., shift:]], dim=-1)
            carry = new
        out[i] = carry
    return torch.stack(out, dim)


class IRNNLayer(nn.Module):
    """The 8 directional sweeps of (B, C, H, W): (up, right, down, left,
    zuoxia, youxia, zuoshang, youshang), each (B, C, H, W)."""

    def __init__(self):
        super().__init__()
        for name in _WEIGHTS:
            setattr(self, name, nn.Parameter(torch.ones(())))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        down = _sweep(x, self.down_weight, 2, False)
        up = _sweep(x, self.up_weight, 2, True)
        right = _sweep(x, self.right_weight, 3, False)
        left = _sweep(x, self.left_weight, 3, True)
        w = self.down_weight          # the reference's, for all diagonals
        zuoxia = _sweep(x, w, 2, False, 1)
        youxia = _sweep(x, w, 2, False, -1)
        zuoshang = _sweep(x, w, 3, False, 1)
        youshang = _sweep(x, w, 3, False, -1)
        return up, right, down, left, zuoxia, youxia, zuoshang, youshang


class ChannelAttentionSAM(nn.Module):
    """avg- and max-pooled squeeze-excite."""

    def __init__(self, channels: int, ratio: int = 8):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, channels // ratio, 1, bias=False)
        self.fc2 = nn.Conv2d(channels // ratio, channels, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def mlp(s):
            return self.fc2(F.relu(self.fc1(s)))

        return torch.sigmoid(mlp(x.mean(dim=(2, 3), keepdim=True))
                             + mlp(x.amax(dim=(2, 3), keepdim=True)))


class SpatialAttentionSAM(nn.Module):
    """Channel mean and max -> 7x7 conv -> sigmoid."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.conv1 = nn.Conv2d(2, 1, kernel_size,
                               padding=kernel_size // 2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.cat([x.mean(dim=1, keepdim=True),
                       x.amax(dim=1, keepdim=True)], dim=1)
        return torch.sigmoid(self.conv1(h))


class SAMAttention(nn.Module):
    """The direction-weight head (whose output SAM never uses)."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.conv3 = nn.Conv2d(in_channels, 8, 1)
        self.ca = ChannelAttentionSAM(8)
        self.sa = SpatialAttentionSAM()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.conv3(x))
        h = self.ca(h) * h
        return self.sa(h) * h


class SAM(nn.Module):
    """(B, in_channels, H, W) -> a (B, 1, H, W) mask."""

    def __init__(self, in_channels: int = 64, out_channels: int = 32,
                 attention: bool = True):
        super().__init__()
        self.conv_in = nn.Conv2d(in_channels, out_channels, 3, padding=1,
                                 bias=False)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 1)
        self.conv2 = nn.Conv2d(out_channels * 8, out_channels, 1)
        self.conv3 = nn.Conv2d(out_channels * 8, out_channels, 1)
        self.conv_out = nn.Conv2d(out_channels, 1, 1, bias=False)
        self.irnn1 = IRNNLayer()
        self.irnn2 = IRNNLayer()
        if attention:
            self.attention_layer = SAMAttention(in_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.cat(self.irnn1(self.conv1(x)), dim=1)
        out = torch.cat(self.irnn2(self.conv2(out)), dim=1)
        return self.conv_out(F.relu(self.conv3(out)))
