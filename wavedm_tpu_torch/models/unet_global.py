"""The global-attention diffusion UNet on NCHW tensors.

The port of ``wavedm_tpu/models/unet_global.py`` (``data.global_attn``):
the UNet of ``models/unet.py`` plus a parallel whole-image ("global")
branch whose features every level cross-attends into the patch features
(:class:`AttnGlobal`).  The global branch is ``global_conv_in``, then a
4x4 stride-2 conv (padding 1) after each down level and a 4x4 stride-2
transposed conv on the way up.

Kept as JAX has them, since they decide the parameters and the outputs:
- :class:`AttnGlobal` normalises both inputs with ``norm_patch``; its
  ``norm_global`` parameters exist and are never applied.
- After the last down level the globally attended ``h`` is dropped: the
  mid block restarts from the last skip tensor.
- The two 1x1 ``*_proj`` convs that JAX adds where the reference would
  crash (a global feature one level too narrow at the last down level and
  the first up level).
- The transposed conv is Flax's ``ConvTranspose(4x4, stride 2, padding
  ((1, 1), (1, 1)))``: a conv of the unflipped kernel over the 2x
  zero-stuffed input padded by one, so an H input gives 2H - 2 rows, not
  2H.  Its torch form is ``ConvTranspose2d(k=4, s=2, padding=2)`` with the
  Flax kernel flipped in both spatial axes (``utils/convert.py``).

As in JAX, the ResnetBlocks take ``fused_block`` and no norm site takes the
GroupNorm kernel (``parallel.fused_groupnorm`` does not reach this model).

The global tensor holds Bg whole images for B patches.  By default patch i
attends to image ``i // (B // Bg)`` (JAX's ``jnp.repeat``: each image's
patches are consecutive); ``global_index`` (B,) names each patch's image
instead, which lets a chunk of patches from several images (the sampler's
``patch_micro_batch``) attend to the right ones.  The whole-image k/v are
encoded once per image and gathered per patch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from wavedm_tpu_torch.config import Config
from wavedm_tpu_torch.models.layers import (Conv2d, ConvTranspose2d,
                                            Normalize, cast_compute)
from wavedm_tpu_torch.models.unet import _DTYPES, DiffusionUNet

__all__ = ["AttnGlobal", "DiffusionUNetGlobal", "patch_images"]


def patch_images(b: int, bg: int, device=None) -> torch.Tensor:
    """The image each of ``b`` patches attends to when ``bg`` images hold
    them in order, ``b // bg`` each."""
    if b % bg:
        raise ValueError(f"{b} patches do not split over {bg} global images")
    return torch.arange(bg, device=device).repeat_interleave(b // bg)


class AttnGlobal(nn.Module):
    """Cross-attention: strided-conv tokens of the patch (queries) attend to
    grouped strided-conv tokens of the whole image (keys, values)."""

    def __init__(self, channels: int, local_patch_size: int = 2,
                 global_patch_size: int = 8):
        super().__init__()
        c, lp, gp = channels, local_patch_size, global_patch_size
        self.lp = lp
        self.norm_patch = Normalize(c)
        self.norm_global = Normalize(c)      # never applied (see module doc)
        self.q = Conv2d(c, c, lp, stride=lp)
        self.k = Conv2d(c, c, gp, stride=gp, groups=c)
        self.v = Conv2d(c, c, gp, stride=gp, groups=c)
        self.proj_out = Conv2d(c, c, 1)

    def forward(self, x_patch: torch.Tensor, x_global: torch.Tensor,
                global_index: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x_patch: (B, c, h, w); x_global: (Bg, c, H, W); global_index:
        (B,) image of each patch (default :func:`patch_images`)."""
        b, c = x_patch.shape[:2]
        q = self.q(self.norm_patch(x_patch))
        hq, wq = q.shape[2:]
        hg = self.norm_patch(x_global)
        k = self.k(hg).flatten(2)                        # (Bg, c, Lk)
        v = self.v(hg).flatten(2)
        if global_index is None:
            if k.shape[0] != b:
                global_index = patch_images(b, k.shape[0], k.device)
        if global_index is not None:
            k, v = k[global_index], v[global_index]
        qf = q.flatten(2).transpose(1, 2)                # (B, Lq, c)
        logits = torch.matmul(qf.float(), k.float()) * (c ** -0.5)
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v.transpose(1, 2))      # (B, Lq, c)
        out = self.proj_out(out.transpose(1, 2).reshape(b, c, hq, wq))
        if self.lp > 1:
            out = out.repeat_interleave(self.lp, 2).repeat_interleave(
                self.lp, 3)
        return x_patch + out


class DiffusionUNetGlobal(DiffusionUNet):
    """:class:`DiffusionUNet` with per-level global cross-attention.
    Construct via :meth:`from_config`."""

    def __init__(self, in_channels: int, out_ch: int = 3, ch: int = 128,
                 ch_mult: Tuple[int, ...] = (1, 2, 4, 6),
                 num_res_blocks: int = 2,
                 attn_resolutions: Tuple[int, ...] = (16,),
                 dropout: float = 0.0, resamp_with_conv: bool = True,
                 resolution: int = 64, global_channels: int = 48,
                 compute_dtype=torch.float32, fused_block: bool = False,
                 keep_f32_params: bool = False):
        super().__init__(in_channels, out_ch, ch, ch_mult, num_res_blocks,
                         attn_resolutions, dropout, resamp_with_conv,
                         resolution, compute_dtype, fused_gn=False,
                         fused_block=fused_block,
                         keep_f32_params=keep_f32_params)
        self.resolution = resolution
        self.global_conv_in = Conv2d(global_channels, ch, 3, padding=1)
        last = self.num_levels - 1
        g_ch = ch
        for i_level, level in enumerate(self.down):
            block_out = ch * ch_mult[i_level]
            if i_level != last:
                level.global_conv = Conv2d(g_ch, block_out, 4, stride=2,
                                           padding=1)
            elif g_ch != block_out:
                level.global_proj = Conv2d(g_ch, block_out, 1)
            g_ch = block_out
            level.global_attn = AttnGlobal(block_out)
        for i_level in reversed(range(self.num_levels)):
            level = self.up[i_level]
            block_out = ch * ch_mult[i_level]
            if i_level != 0:
                level.global_conv = ConvTranspose2d(g_ch, block_out, 4,
                                                    stride=2, padding=2)
            elif g_ch != block_out:
                level.global_proj = Conv2d(g_ch, block_out, 1)
            g_ch = block_out
            level.global_attn = AttnGlobal(block_out)
        cast_compute(self, compute_dtype, store=not keep_f32_params)

    @classmethod
    def from_config(cls, cfg: Config, **overrides) -> "DiffusionUNetGlobal":
        kw = dict(
            in_channels=cfg.model.unet_in_channels,
            out_ch=cfg.model.out_ch,
            ch=cfg.model.ch,
            ch_mult=tuple(cfg.model.ch_mult),
            num_res_blocks=cfg.model.num_res_blocks,
            attn_resolutions=tuple(cfg.model.attn_resolutions),
            dropout=cfg.model.dropout,
            resamp_with_conv=cfg.model.resamp_with_conv,
            resolution=cfg.data.image_size,
            global_channels=cfg.model.in_channels,
            compute_dtype=_DTYPES[cfg.parallel.compute_dtype],
            fused_block=cfg.parallel.fused_resblock,
        )
        kw.update(overrides)
        return cls(**kw)

    @staticmethod
    def _global_step(level: nn.Module, h_global: torch.Tensor
                     ) -> torch.Tensor:
        if hasattr(level, "global_conv"):
            return level.global_conv(h_global)
        if hasattr(level, "global_proj"):
            return level.global_proj(h_global)
        return h_global

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                x_global: torch.Tensor,
                global_index: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (N, Cin, r, r) patches at the model's resolution r; t: (N,);
        x_global: (Bg, global_channels, H, W) whole images; global_index:
        (N,) image of each patch (see the module doc).  Returns
        (N, out_ch, r, r) float32."""
        if tuple(x.shape[2:]) != (self.resolution,) * 2:
            raise ValueError(f"the global UNet runs on {self.resolution}^2 "
                             f"patches, got {tuple(x.shape[2:])}")
        x = x.to(self.compute_dtype)
        temb = self.temb(t)
        h_global = self.global_conv_in(x_global.to(self.compute_dtype))
        hs = [self.conv_in(x)]
        h = hs[-1]
        for level in self.down:
            for i_block, block in enumerate(level.block):
                h = block(h, temb)
                if len(level.attn):
                    h = level.attn[i_block](h)
                hs.append(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
                hs.append(h)
            h_global = self._global_step(level, h_global)
            h = level.global_attn(h, h_global, global_index)

        # the mid block restarts from the last skip tensor (see module doc)
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
            h_global = self._global_step(level, h_global)
            h = level.global_attn(h, h_global, global_index)
        assert not hs

        h = self.conv_out(self.norm_out(h))      # norm_out folds the swish
        return h.float()
