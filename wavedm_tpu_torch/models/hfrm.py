"""HFRM, the stage-1 high-frequency restoration module, on NCHW tensors.

NAFNet-style encoder-decoder with the reference's key names: ``conv_in``,
per-level ``encoders`` stacks with 2x2 stride-2 ``downs``, ``mid_blks``,
``ups`` (1x1 conv + PixelShuffle) with additive encoder skips, ``decoders``,
``conv_out`` and a global ``x + input`` residual.  The input is padded to a
multiple of 2**levels and the output cropped back.

Every conv is a ``layers.Conv2d``, so the compute dtype reaches all of
them: stored in it for serving, or (``keep_f32_params``, training) float32
parameters cast at each use, as the JAX model's flax ``dtype=`` does.
``remat`` recomputes each block's interior in the backward
(``torch.utils.checkpoint``), as the JAX model's ``nn.remat`` does.
``tlc`` = ((base_h, base_w), (train_h, train_w)) turns every channel
attention's global pool into TLC's local windowed mean (``ops/tlc.py``),
as the JAX model's constructor argument of that name does.
:func:`identity_center_init_` is the stage-1 trainer's starting point.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from wavedm_tpu_torch.config import Config
from wavedm_tpu_torch.models.layers import Conv2d, cast_compute
from wavedm_tpu_torch.ops.tlc import local_avg_pool, tlc_kernel

__all__ = ["LayerNorm2d", "ChannelAttn", "HFRMBlock", "HFRM",
           "identity_center_init_"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# TLC's ((base_h, base_w), (train_h, train_w)); None: global pooling
TLC = Optional[Tuple[Tuple[int, int], Tuple[int, int]]]


class LayerNorm2d(nn.Module):
    """Per-pixel LayerNorm over channels with biased variance, float32
    statistics, output in the input dtype."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mu = x32.mean(dim=1, keepdim=True)
        var = (x32 - mu).square().mean(dim=1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + self.eps)
        y = y * self.weight[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


def simple_gate(x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=1)
    return a * b


class ChannelAttn(nn.Module):
    """Global average pool (TLC's local mean with ``tlc``) -> 1x1 conv ->
    channel scale."""

    def __init__(self, channels: int, tlc: TLC = None):
        super().__init__()
        self.chan_conv = Conv2d(channels, channels, 1)
        self.tlc = tlc

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tlc is None:
            s = x.mean(dim=(2, 3), keepdim=True)
        else:
            base_hw, train_hw = self.tlc
            s = local_avg_pool(x, tlc_kernel(tuple(x.shape[2:]), train_hw,
                                             base_hw))
        return x * self.chan_conv(s)


class HFRMBlock(nn.Module):
    """One NAFNet-style residual block with zero-initialised beta/gamma."""

    def __init__(self, dim: int, tlc: TLC = None):
        super().__init__()
        self.norm1 = LayerNorm2d(dim)
        self.conv1 = Conv2d(dim, dim * 2, 1)
        self.conv2 = Conv2d(dim * 2, dim * 2, 3, padding=1, groups=dim * 2)
        self.channel_attn = ChannelAttn(dim, tlc)
        self.conv3 = Conv2d(dim, dim, 1)
        self.norm2 = LayerNorm2d(dim)
        self.conv4 = Conv2d(dim, dim * 2, 1)
        self.conv5 = Conv2d(dim, dim, 1)
        self.beta = nn.Parameter(torch.zeros(1, dim, 1, 1))
        self.gamma = nn.Parameter(torch.zeros(1, dim, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(self.conv1(self.norm1(x)))
        h = self.conv3(self.channel_attn(simple_gate(h)))
        y = x + (h * self.beta).to(x.dtype)
        h = self.conv5(simple_gate(self.conv4(self.norm2(y))))
        return y + (h * self.gamma).to(y.dtype)


class HFRM(nn.Module):
    """High-frequency restoration module: (B, 3, H, W) [0,1] -> same."""

    def __init__(self, in_channel: int = 3, dim: int = 32,
                 mid_blk_num: int = 6,
                 enc_blk_nums: Tuple[int, ...] = (2, 2, 2, 4),
                 dec_blk_nums: Tuple[int, ...] = (2, 2, 2, 2),
                 compute_dtype=torch.float32, keep_f32_params: bool = False,
                 remat: bool = False, tlc: TLC = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.num_levels = len(enc_blk_nums)
        self.conv_in = Conv2d(in_channel, dim, 3, padding=1)
        self.encoders, self.downs = nn.ModuleList(), nn.ModuleList()
        chan = dim
        for num in enc_blk_nums:
            self.encoders.append(
                nn.Sequential(*[HFRMBlock(chan, tlc) for _ in range(num)]))
            self.downs.append(Conv2d(chan, chan * 2, 2, stride=2))
            chan *= 2
        self.mid_blks = nn.Sequential(
            *[HFRMBlock(chan, tlc) for _ in range(mid_blk_num)])
        self.ups, self.decoders = nn.ModuleList(), nn.ModuleList()
        for num in dec_blk_nums:
            self.ups.append(nn.Sequential(
                Conv2d(chan, chan * 2, 1, bias=False), nn.PixelShuffle(2)))
            chan //= 2
            self.decoders.append(
                nn.Sequential(*[HFRMBlock(chan, tlc) for _ in range(num)]))
        self.conv_out = Conv2d(dim, in_channel, 3, padding=1)
        cast_compute(self, compute_dtype, store=not keep_f32_params)

    @classmethod
    def from_config(cls, cfg: Config, **overrides) -> "HFRM":
        kw = dict(dim=cfg.hfrm.dim, mid_blk_num=cfg.hfrm.middle_blk_num,
                  enc_blk_nums=cfg.hfrm.enc_blk_nums,
                  dec_blk_nums=cfg.hfrm.dec_blk_nums, remat=cfg.hfrm.remat,
                  compute_dtype=_DTYPES[cfg.parallel.compute_dtype])
        kw.update(overrides)
        return cls(**kw)

    def _blocks(self, blocks: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        for blk in blocks:
            if self.remat and self.training and torch.is_grad_enabled():
                x = checkpoint(blk, x, use_reentrant=False)
            else:
                x = blk(x)
        return x

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        h_in, w_in = inp.shape[2], inp.shape[3]
        mult = 2 ** self.num_levels
        x = F.pad(inp, (0, (-w_in) % mult, 0, (-h_in) % mult))
        x = self.conv_in(x.to(self.compute_dtype))
        skips = []
        for enc, down in zip(self.encoders, self.downs):
            x = self._blocks(enc, x)
            skips.append(x)
            x = down(x)
        x = self._blocks(self.mid_blks, x)
        for up, dec, skip in zip(self.ups, self.decoders, reversed(skips)):
            x = self._blocks(dec, up(x) + skip)
        x = self.conv_out(x)
        return x[:, :, :h_in, :w_in].float() + inp


@torch.no_grad()
def identity_center_init_(hfrm: HFRM) -> HFRM:
    """The stage-1 starting weights, in place: every conv weight zero but
    ``eye(cout, cin)`` at its spatial centre (depthwise and 2x2 convs
    included), conv biases 0, LayerNorm weights 1 and biases 0, beta and
    gamma 0.  No random draw is involved.  The port's copy of the JAX
    package's ``apply_identity_center_init`` on flax's default init."""
    for m in hfrm.modules():
        if isinstance(m, nn.Conv2d):
            w = torch.zeros(m.weight.shape, dtype=torch.float32)
            kh, kw = w.shape[2:]
            w[:, :, kh // 2, kw // 2] = torch.eye(w.shape[0], w.shape[1])
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, LayerNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, HFRMBlock):
            m.beta.zero_()
            m.gamma.zero_()
    return hfrm
