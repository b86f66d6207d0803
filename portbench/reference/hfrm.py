"""The HFRM of WaveDM (``models/arch.py``, a NAFNet), in float32, with
the port's ``state_dict`` names.

``conv_in`` (3x3); per level a stack of blocks, then a 2x2 stride-2 conv
doubling the width; the middle blocks; per level a 1x1 conv doubling the
width (no bias) and a pixel shuffle, the encoder's output added, a stack
of blocks; ``conv_out`` (3x3) and the input added back.  A block:
LayerNorm over channels -> 1x1 conv to twice the width -> depthwise 3x3
conv -> SimpleGate -> channel attention (global mean -> 1x1 conv -> scale)
-> 1x1 conv, scaled by ``beta`` and added; LayerNorm -> 1x1 conv to twice
the width -> SimpleGate -> 1x1 conv, scaled by ``gamma`` and added.  The
input is zero-padded to a multiple of 2**levels and the output cropped.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.precision import Prec
from portbench.reference.unet import Affine, Ops, conv, norm

__all__ = ["HFRM"]


def layer_norm(m: Affine, x: torch.Tensor) -> torch.Tensor:
    mu = x.mean(dim=1, keepdim=True)
    var = (x - mu).square().mean(dim=1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + 1e-6)
    return y * m.weight[:, None, None] + m.bias[:, None, None]


def gate(x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=1)
    return a * b


class Block(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.norm1, self.norm2 = norm(c), norm(c)
        self.conv1 = conv(c, 2 * c, 1)
        self.conv2 = Affine((2 * c, 1, 3, 3))
        self.channel_attn = nn.Module()
        self.channel_attn.chan_conv = conv(c, c, 1)
        self.conv3 = conv(c, c, 1)
        self.conv4 = conv(c, 2 * c, 1)
        self.conv5 = conv(c, c, 1)
        self.beta = nn.Parameter(torch.empty(1, c, 1, 1))
        self.gamma = nn.Parameter(torch.empty(1, c, 1, 1))

    def run(self, o: Ops, x):
        h = o.conv(self.conv1, layer_norm(self.norm1, x))
        h = gate(o.conv(self.conv2, h, groups=h.shape[1]))
        h = h * o.conv(self.channel_attn.chan_conv,
                       h.mean(dim=(2, 3), keepdim=True))
        y = x + o.conv(self.conv3, h) * self.beta
        h = gate(o.conv(self.conv4, layer_norm(self.norm2, y)))
        return y + o.conv(self.conv5, h) * self.gamma


class HFRM(nn.Module):
    """(B, 3, H, W) in [0, 1] -> (B, 3, H, W)."""

    def __init__(self, dim: int, enc: Sequence[int], middle: int,
                 dec: Sequence[int]):
        super().__init__()
        self.levels = len(enc)
        self.conv_in = conv(3, dim, 3)
        self.encoders, self.downs = nn.ModuleList(), nn.ModuleList()
        c = dim
        for n in enc:
            self.encoders.append(nn.Sequential(*[Block(c) for _ in range(n)]))
            self.downs.append(conv(c, 2 * c, 2))
            c *= 2
        self.mid_blks = nn.Sequential(*[Block(c) for _ in range(middle)])
        self.ups, self.decoders = nn.ModuleList(), nn.ModuleList()
        for n in dec:
            self.ups.append(nn.Sequential(conv(c, 2 * c, 1, bias=False)))
            c //= 2
            self.decoders.append(nn.Sequential(*[Block(c) for _ in range(n)]))
        self.conv_out = conv(dim, 3, 3)

    @classmethod
    def from_config(cls, cfg: dict) -> "HFRM":
        h = cfg["hfrm"]
        return cls(h["dim"], h["enc_blk_nums"], h["middle_blk_num"],
                   h["dec_blk_nums"])

    def run(self, prec: Prec, inp: torch.Tensor) -> torch.Tensor:
        o = Ops(prec)

        def blocks(seq, x):
            for blk in seq:
                x = blk.run(o, x)
            return x

        h, w = inp.shape[2:]
        mult = 2 ** self.levels
        x = o.conv(self.conv_in, F.pad(inp, (0, (-w) % mult, 0, (-h) % mult)))
        skips = []
        for enc, down in zip(self.encoders, self.downs):
            x = blocks(enc, x)
            skips.append(x)
            x = o.conv(down, x, stride=2, padding=0)
        x = blocks(self.mid_blks, x)
        for up, dec, skip in zip(self.ups, self.decoders, reversed(skips)):
            x = blocks(dec, F.pixel_shuffle(o.conv(up[0], x), 2) + skip)
        return o.conv(self.conv_out, x)[:, :, :h, :w] + inp
