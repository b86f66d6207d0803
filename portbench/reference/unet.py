"""The diffusion UNet of WaveDM (``models/unet.py`` of the paper's code,
after DDIM's), in float32, with the port's ``state_dict`` names.

Sinusoidal time embedding -> two linear layers; ``conv_in``; per level
``num_res_blocks`` ResnetBlocks (GroupNorm(32, eps 1e-6) -> swish -> 3x3
conv, + the projected embedding, GroupNorm -> swish -> 3x3 conv, a 1x1
shortcut where the width changes), self-attention at the resolutions
listed, a stride-2 conv after a (0, 1, 0, 1) pad between levels; the
middle block-attention-block; the mirrored levels with skip concatenation
and nearest x2 upsampling + conv; GroupNorm -> swish -> ``conv_out``.
Dropout is 0 in every configuration the benchmark runs, so there is none.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.precision import Prec

__all__ = ["UNet", "timestep_embedding"]


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                   device=t.device)
                      * -(math.log(10000.0) / (half - 1)))
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=1)


class Affine(nn.Module):
    """A weight and a bias: the parameters of a conv, linear or norm."""

    def __init__(self, wshape: Sequence[int], bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(tuple(wshape)))
        self.register_parameter(
            "bias", nn.Parameter(torch.empty(wshape[0])) if bias else None)


def conv(cin: int, cout: int, k: int, bias: bool = True) -> Affine:
    return Affine((cout, cin, k, k), bias)


def norm(c: int) -> Affine:
    return Affine((c,))


class Ops:
    """The layers' arithmetic, over one :class:`Prec`."""

    def __init__(self, prec: Prec):
        self.p = prec

    def conv(self, m: Affine, x, stride=1, padding=None, groups=1):
        pad = m.weight.shape[-1] // 2 if padding is None else padding
        return self.p.conv(x, m.weight, m.bias, stride, pad, groups)

    def linear(self, m: Affine, x):
        return self.p.linear(x, m.weight, m.bias)

    @staticmethod
    def gn_swish(m: Affine, x, swish=True):
        y = F.group_norm(x, 32, m.weight, m.bias, 1e-6)
        return F.silu(y) if swish else y


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, temb: int):
        super().__init__()
        self.norm1, self.conv1 = norm(cin), conv(cin, cout, 3)
        self.temb_proj = Affine((cout, temb))
        self.norm2, self.conv2 = norm(cout), conv(cout, cout, 3)
        if cin != cout:
            self.nin_shortcut = conv(cin, cout, 1)

    def run(self, o: Ops, x, temb):
        h = o.conv(self.conv1, o.gn_swish(self.norm1, x))
        h = h + o.linear(self.temb_proj, F.silu(temb))[:, :, None, None]
        h = o.conv(self.conv2, o.gn_swish(self.norm2, h))
        if hasattr(self, "nin_shortcut"):
            x = o.conv(self.nin_shortcut, x)
        return x + h


class Attn(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.norm = norm(c)
        self.q, self.k, self.v, self.proj_out = (conv(c, c, 1)
                                                 for _ in range(4))

    def run(self, o: Ops, x):
        b, c, h, w = x.shape
        hn = o.gn_swish(self.norm, x, swish=False)
        q = o.conv(self.q, hn).reshape(b, c, h * w).transpose(1, 2)
        k = o.conv(self.k, hn).reshape(b, c, h * w)
        v = o.conv(self.v, hn).reshape(b, c, h * w).transpose(1, 2)
        a = torch.softmax(o.p.matmul(q, k) * c ** -0.5, dim=-1)
        out = o.p.matmul(a, v).transpose(1, 2).reshape(b, c, h, w)
        return x + o.conv(self.proj_out, out)


class Resample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = conv(c, c, 3)


class UNet(nn.Module):
    """The epsilon predictor: (N, Cin, H, W), (N,) -> (N, out_ch, H, W)."""

    def __init__(self, in_channels: int, out_ch: int, ch: int,
                 ch_mult: Sequence[int], num_res_blocks: int,
                 attn_resolutions: Sequence[int], resolution: int):
        super().__init__()
        self.ch = ch
        temb = 4 * ch
        self.temb = nn.Module()
        self.temb.dense = nn.ModuleList([Affine((temb, ch)),
                                         Affine((temb, temb))])
        self.conv_in = conv(in_channels, ch, 3)
        mults = (1,) + tuple(ch_mult)
        res, cin = resolution, ch
        self.down = nn.ModuleList()
        for i, m in enumerate(ch_mult):
            lvl = nn.Module()
            lvl.block, lvl.attn = nn.ModuleList(), nn.ModuleList()
            cin = ch * mults[i]
            for _ in range(num_res_blocks):
                lvl.block.append(ResBlock(cin, ch * m, temb))
                cin = ch * m
                if res in attn_resolutions:
                    lvl.attn.append(Attn(cin))
            if i != len(ch_mult) - 1:
                lvl.downsample = Resample(cin)
                res //= 2
            self.down.append(lvl)
        self.mid = nn.Module()
        self.mid.block_1 = ResBlock(cin, cin, temb)
        self.mid.attn_1 = Attn(cin)
        self.mid.block_2 = ResBlock(cin, cin, temb)
        ups = []
        for i in reversed(range(len(ch_mult))):
            lvl = nn.Module()
            lvl.block, lvl.attn = nn.ModuleList(), nn.ModuleList()
            skip = ch * ch_mult[i]
            for j in range(num_res_blocks + 1):
                if j == num_res_blocks:
                    skip = ch * mults[i]
                lvl.block.append(ResBlock(cin + skip, ch * ch_mult[i], temb))
                cin = ch * ch_mult[i]
                if res in attn_resolutions:
                    lvl.attn.append(Attn(cin))
            if i != 0:
                lvl.upsample = Resample(cin)
                res *= 2
            ups.insert(0, lvl)
        self.up = nn.ModuleList(ups)
        self.norm_out = norm(cin)
        self.conv_out = conv(cin, out_ch, 3)

    @classmethod
    def from_config(cls, cfg: dict) -> "UNet":
        """From the configuration file's ``data`` and ``model`` sections."""
        m, d = cfg["model"], cfg["data"]
        cin = (2 * m["in_channels"] + m["pred_channels"]
               - m["other_channels_begin"])
        return cls(cin, m["out_ch"], m["ch"], m["ch_mult"],
                   m["num_res_blocks"], m["attn_resolutions"],
                   d["image_size"])

    def run(self, prec: Prec, x: torch.Tensor,
            t: torch.Tensor) -> torch.Tensor:
        o = Ops(prec)
        e = timestep_embedding(t, self.ch)
        e = o.linear(self.temb.dense[1],
                     F.silu(o.linear(self.temb.dense[0], e)))
        hs = [o.conv(self.conv_in, x)]
        for lvl in self.down:
            for j, blk in enumerate(lvl.block):
                h = blk.run(o, hs[-1], e)
                if len(lvl.attn):
                    h = lvl.attn[j].run(o, h)
                hs.append(h)
            if hasattr(lvl, "downsample"):
                hs.append(o.conv(lvl.downsample.conv,
                                 F.pad(hs[-1], (0, 1, 0, 1)), stride=2,
                                 padding=0))
        h = self.mid.block_1.run(o, hs[-1], e)
        h = self.mid.attn_1.run(o, h)
        h = self.mid.block_2.run(o, h, e)
        for i in reversed(range(len(self.up))):
            lvl = self.up[i]
            for j, blk in enumerate(lvl.block):
                h = blk.run(o, torch.cat([h, hs.pop()], dim=1), e)
                if len(lvl.attn):
                    h = lvl.attn[j].run(o, h)
            if hasattr(lvl, "upsample"):
                h = o.conv(lvl.upsample.conv,
                           F.interpolate(h, scale_factor=2.0,
                                         mode="nearest"))
        return o.conv(self.conv_out, o.gn_swish(self.norm_out, h))
