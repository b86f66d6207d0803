"""Time-conditioned diffusion UNet on NCHW tensors.

Architecture and ``state_dict`` key names of the reference ``DiffusionUNet``:
sinusoidal t-embedding -> 2-layer MLP (``temb.dense``), ``conv_in``,
``len(ch_mult)`` levels of ``num_res_blocks`` ResnetBlocks with attention at
``attn_resolutions``, stride-2 downsampling, mid block-attn-block, mirrored
upsampling with skip-concat (num_res_blocks + 1 blocks per level), and
GN -> swish -> ``conv_out``.

``compute_dtype`` threads through every conv and linear layer; the output
returns in float32.  ``keep_f32_params`` (training) keeps every parameter
float32 and casts conv and linear weights at each use, as the JAX model's
flax ``dtype=`` does; without it (serving) they are stored in the compute
dtype.  ``fused_block`` runs every ResnetBlock GN -> swish -> conv3x3 pair
through the fused kernel; attention and ``norm_out`` keep the plain
GroupNorm, as in JAX.

Two hooks of the JAX model wrap the network, each splitting its input at
a hard-coded 3 channels (the cond pixels, then the rest) as JAX does,
also where ``use_fft`` makes the conditioning 9 channels wide:
``use_window`` cuts each half into a window_size² grid of tiles stacked as
channels (:func:`space_to_depth`, undone on exit); ``wavelet_in_unet``
takes the Haar DWT of each half in float32 before the cast to the compute
dtype (one DWT kernel launch a half on the card, each reading its channel
slice in place) and the IWT of the float32 output.  Flax infers
``conv_in``'s width from its input; here :func:`conv_in_channels` computes
it.  Attention stays keyed to the configured ``resolution``'s halving
chain, not to the size the UNet works at, as in JAX.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from wavedm_tpu_torch.config import Config
from wavedm_tpu_torch.models.layers import (
    AttnBlock,
    Conv2d,
    Downsample,
    Linear,
    Normalize,
    ResnetBlock,
    Upsample,
    cast_compute,
    get_timestep_embedding,
)
from wavedm_tpu_torch.ops.wavelet import wavelet_rec
from wavedm_tpu_torch.ops.wavelet_cuda import wavelet_dec_cat

__all__ = ["space_to_depth", "depth_to_space", "conv_in_channels",
           "TimestepMLP", "DiffusionUNet"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def space_to_depth(x: torch.Tensor, p: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C*p*p, H/p, W/p), the reference's TILE
    decomposition: a p x p grid of contiguous (H/p, W/p) tiles stacked as
    channels, channel c*p*p + tile_row*p + tile_col.  Not
    ``F.pixel_unshuffle``, which interleaves pixel windows."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, p, h // p, p, w // p).permute(0, 1, 2, 4, 3, 5)
    return x.reshape(b, c * p * p, h // p, w // p)


def depth_to_space(x: torch.Tensor, p: int) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    b, cpp, h, w = x.shape
    x = x.reshape(b, cpp // (p * p), p, p, h, w).permute(0, 1, 2, 4, 3, 5)
    return x.reshape(b, cpp // (p * p), h * p, w * p)


def conv_in_channels(cfg: Config) -> int:
    """``conv_in``'s input width: the UNet's input channels, times
    window_size² under ``use_window`` and 16 under ``wavelet_in_unet``."""
    n = cfg.model.unet_in_channels
    if cfg.data.use_window:
        n *= cfg.data.window_size ** 2
    return n * (16 if cfg.data.wavelet_in_unet else 1)


class TimestepMLP(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.ch = ch
        self.dense = nn.ModuleList([Linear(ch, ch * 4),
                                    Linear(ch * 4, ch * 4)])

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        dt = self.dense[0].compute_dtype or self.dense[0].weight.dtype
        temb = get_timestep_embedding(t, self.ch).to(dt)
        temb = nn.functional.silu(self.dense[0](temb))
        return self.dense[1](temb)


class DiffusionUNet(nn.Module):
    """UNet epsilon-predictor.  Construct via :meth:`from_config`."""

    def __init__(self, in_channels: int, out_ch: int = 3, ch: int = 128,
                 ch_mult: Tuple[int, ...] = (1, 2, 4, 6),
                 num_res_blocks: int = 2,
                 attn_resolutions: Tuple[int, ...] = (16,),
                 dropout: float = 0.0, resamp_with_conv: bool = True,
                 resolution: int = 64, compute_dtype=torch.float32,
                 fused_gn: bool = False, use_window: bool = False,
                 window_size: int = 2, wavelet_in_unet: bool = False,
                 fused_block: bool = False, keep_f32_params: bool = False):
        """``in_channels``: ``conv_in``'s width, after the hooks."""
        super().__init__()
        self.use_window, self.window_size = use_window, window_size
        self.wavelet_in_unet = wavelet_in_unet
        self.ch, self.num_levels = ch, len(ch_mult)
        self.num_res_blocks = num_res_blocks
        self.compute_dtype = compute_dtype
        temb_ch = ch * 4
        self.temb = TimestepMLP(ch)
        self.conv_in = Conv2d(in_channels, ch, 3, padding=1)

        curr_res = resolution
        in_ch_mult = (1,) + tuple(ch_mult)
        block_in = ch
        self.down = nn.ModuleList()
        for i_level in range(self.num_levels):
            level = nn.Module()
            level.block, level.attn = nn.ModuleList(), nn.ModuleList()
            block_in = ch * in_ch_mult[i_level]
            block_out = ch * ch_mult[i_level]
            for _ in range(num_res_blocks):
                level.block.append(ResnetBlock(block_in, block_out, temb_ch,
                                               dropout=dropout,
                                               fused_gn=fused_gn,
                                               fused_block=fused_block))
                block_in = block_out
                if curr_res in attn_resolutions:
                    level.attn.append(AttnBlock(block_in, fused_gn))
            if i_level != self.num_levels - 1:
                level.downsample = Downsample(block_in, resamp_with_conv)
                curr_res //= 2
            self.down.append(level)

        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(block_in, block_in, temb_ch,
                                       dropout=dropout, fused_gn=fused_gn,
                                       fused_block=fused_block)
        self.mid.attn_1 = AttnBlock(block_in, fused_gn)
        self.mid.block_2 = ResnetBlock(block_in, block_in, temb_ch,
                                       dropout=dropout, fused_gn=fused_gn,
                                       fused_block=fused_block)

        up = []
        for i_level in reversed(range(self.num_levels)):
            level = nn.Module()
            level.block, level.attn = nn.ModuleList(), nn.ModuleList()
            block_out = ch * ch_mult[i_level]
            skip_in = ch * ch_mult[i_level]
            for i_block in range(num_res_blocks + 1):
                if i_block == num_res_blocks:
                    skip_in = ch * in_ch_mult[i_level]
                level.block.append(ResnetBlock(block_in + skip_in, block_out,
                                               temb_ch, dropout=dropout,
                                               fused_gn=fused_gn,
                                               fused_block=fused_block))
                block_in = block_out
                if curr_res in attn_resolutions:
                    level.attn.append(AttnBlock(block_in, fused_gn))
            if i_level != 0:
                level.upsample = Upsample(block_in, resamp_with_conv)
                curr_res *= 2
            up.insert(0, level)
        self.up = nn.ModuleList(up)

        self.norm_out = Normalize(block_in, fused_gn, swish=True)
        self.conv_out = Conv2d(block_in, out_ch, 3, padding=1)
        cast_compute(self, compute_dtype, store=not keep_f32_params)

    @classmethod
    def from_config(cls, cfg: Config, **overrides) -> "DiffusionUNet":
        kw = dict(
            in_channels=conv_in_channels(cfg),
            out_ch=cfg.model.out_ch,
            ch=cfg.model.ch,
            ch_mult=tuple(cfg.model.ch_mult),
            num_res_blocks=cfg.model.num_res_blocks,
            attn_resolutions=tuple(cfg.model.attn_resolutions),
            dropout=cfg.model.dropout,
            resamp_with_conv=cfg.model.resamp_with_conv,
            resolution=cfg.data.image_size,
            compute_dtype=_DTYPES[cfg.parallel.compute_dtype],
            fused_gn=cfg.parallel.fused_groupnorm,
            use_window=cfg.data.use_window,
            window_size=cfg.data.window_size,
            wavelet_in_unet=cfg.data.wavelet_in_unet,
            fused_block=cfg.parallel.fused_resblock,
        )
        kw.update(overrides)
        return cls(**kw)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """x: (N, Cin, H, W), t: (N,) -> (N, out_ch, H, W) float32 (the
        hooks change both channel counts and sizes, as JAX's do)."""
        if self.use_window:
            p = self.window_size
            x = torch.cat([space_to_depth(x[:, :3], p),
                           space_to_depth(x[:, 3:], p)], dim=1)
        if self.wavelet_in_unet:
            x = wavelet_dec_cat([x[:, :3], x[:, 3:]])
        div = 2 ** (self.num_levels - 1)
        if x.shape[2] % div or x.shape[3] % div:
            raise ValueError(f"input dims {tuple(x.shape[2:])} must be "
                             f"divisible by {div} for the skip-concat chain")
        x = x.to(self.compute_dtype)
        temb = self.temb(t)

        hs = [self.conv_in(x)]
        for i_level, level in enumerate(self.down):
            for i_block, block in enumerate(level.block):
                h = block(hs[-1], temb)
                if len(level.attn):
                    h = level.attn[i_block](h)
                hs.append(h)
            if hasattr(level, "downsample"):
                hs.append(level.downsample(hs[-1]))

        h = self.mid.block_1(hs[-1], temb)
        h = self.mid.attn_1(h)
        h = self.mid.block_2(h, temb)

        for i_level in reversed(range(self.num_levels)):
            level = self.up[i_level]
            for i_block, block in enumerate(level.block):
                h = block(torch.cat([h, hs.pop()], dim=1), temb)
                if len(level.attn):
                    h = level.attn[i_block](h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        assert not hs

        h = self.conv_out(self.norm_out(h)).float()
        if self.use_window:
            h = depth_to_space(h, self.window_size)
        if self.wavelet_in_unet:
            h = wavelet_rec(h)
        return h
