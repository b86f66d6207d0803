"""UNet building blocks on NCHW tensors, with the reference's key names.

Numerics follow ``wavedm_tpu/models/layers.py``: GroupNorm(32, eps 1e-6)
with float32 statistics, nearest x2 upsampling, the asymmetric (0,1,0,1)
downsample pad, and attention logits in float32 whatever the compute dtype.
Convolutions and linear layers run in the compute dtype (see
``cast_compute``): for serving their weights are stored in it, for training
they stay float32 and are cast at each use, as flax's ``dtype=`` does; norm
parameters stay float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from wavedm_tpu_torch.ops.fused_resblock import fused_gn_swish_conv
from wavedm_tpu_torch.ops.groupnorm_cuda import group_norm

__all__ = [
    "get_timestep_embedding",
    "Conv2d",
    "ConvTranspose2d",
    "Linear",
    "Normalize",
    "Upsample",
    "Downsample",
    "ResnetBlock",
    "AttnBlock",
    "cast_compute",
]


def get_timestep_embedding(timesteps: torch.Tensor,
                           embedding_dim: int) -> torch.Tensor:
    """Sinusoidal embedding of (B,) timesteps -> (B, embedding_dim) f32."""
    assert timesteps.dim() == 1
    half_dim = embedding_dim // 2
    scale = math.log(10000.0) / (half_dim - 1)
    freqs = torch.exp(torch.arange(half_dim, dtype=torch.float32,
                                   device=timesteps.device) * -scale)
    args = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that runs in ``compute_dtype`` when it is set, casting
    its weight and bias at each use (a no-op when they are stored in it)."""

    compute_dtype = None
    keep_f32 = False       # read by the fused kernel, which casts itself

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x, self.weight.to(dt), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` with the cast-at-use ``compute_dtype`` of
    :class:`Conv2d`."""

    compute_dtype = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv_transpose2d(x, self.weight.to(dt), bias, self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation)


class Linear(nn.Linear):
    """``nn.Linear`` with the cast-at-use ``compute_dtype`` of
    :class:`Conv2d`."""

    compute_dtype = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.linear(x, self.weight.to(dt), self.bias.to(dt))


def cast_compute(module: nn.Module, dtype: torch.dtype,
                 store: bool = True) -> nn.Module:
    """Run every conv and linear layer in the compute dtype.

    ``store=True`` (serving) stores the weights in it; ``store=False``
    (training) keeps them float32 and casts them at each use, as the JAX
    package's flax ``dtype=`` does.  Both round the same way, so the two
    forwards are bit-identical.  Convs that feed the fused kernel
    (``keep_f32``) stay float32 either way: the kernel casts the weight and
    adds the bias in float32, as the JAX kernel does.  Norm and
    residual-scale parameters stay float32."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            m.compute_dtype = dtype
            if store and not getattr(m, "keep_f32", False):
                m.to(dtype)
    return module


class Normalize(nn.Module):
    """GroupNorm(32, eps 1e-6) with affine, optionally followed by swish.

    ``fused=True`` runs the GroupNorm(+swish) CUDA kernel
    (``ops/groupnorm_cuda.py``); otherwise ``F.group_norm`` in float32 is
    cast to the input dtype before the swish, as flax's GroupNorm does."""

    def __init__(self, channels: int, fused: bool = False,
                 swish: bool = False, num_groups: int = 32,
                 eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.fused, self.swish = fused, swish
        self.num_groups, self.eps = num_groups, eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            return group_norm(x, self.weight, self.bias, self.num_groups,
                              self.eps, self.swish)
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                         self.eps).to(x.dtype)
        return F.silu(y) if self.swish else y


class Upsample(nn.Module):
    """Nearest x2 upsample, then a 3x3 conv."""

    def __init__(self, channels: int, with_conv: bool = True):
        super().__init__()
        self.with_conv = with_conv
        if with_conv:
            self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        return self.conv(x) if self.with_conv else x


class Downsample(nn.Module):
    """A (0,1,0,1) pad then a stride-2 VALID 3x3 conv, or 2x2 average pool."""

    def __init__(self, channels: int, with_conv: bool = True):
        super().__init__()
        self.with_conv = with_conv
        if with_conv:
            self.conv = Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.with_conv:
            return self.conv(F.pad(x, (0, 1, 0, 1)))
        return F.avg_pool2d(x, 2, 2)


class ResnetBlock(nn.Module):
    """GN -> swish -> conv -> + temb_proj -> GN -> swish -> conv, with a 1x1
    (or 3x3) shortcut when the channel count changes.

    ``fused_block`` runs each GN -> swish -> conv3x3 pair through the fused
    kernel (``ops/fused_resblock.py``) with the same parameters and keys;
    the second pair stays unfused while dropout is active in training (the
    kernel has no dropout point), as in the JAX block."""

    def __init__(self, in_channels: int, out_channels: int | None = None,
                 temb_channels: int = 512, conv_shortcut: bool = False,
                 dropout: float = 0.0, fused_gn: bool = False,
                 fused_block: bool = False):
        super().__init__()
        out_channels = out_channels or in_channels
        self.fused_block = fused_block
        self.norm1 = Normalize(in_channels, fused_gn, swish=True)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.temb_proj = Linear(temb_channels, out_channels)
        self.norm2 = Normalize(out_channels, fused_gn, swish=True)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv1.keep_f32 = self.conv2.keep_f32 = fused_block
        if in_channels != out_channels:
            if conv_shortcut:
                self.conv_shortcut = Conv2d(in_channels, out_channels, 3,
                                            padding=1)
            else:
                self.nin_shortcut = Conv2d(in_channels, out_channels, 1)

    def _fused(self, x: torch.Tensor, norm: Normalize,
               conv: Conv2d) -> torch.Tensor:
        # activations arrive in the compute dtype
        return fused_gn_swish_conv(x, norm.weight, norm.bias, conv.weight,
                                   conv.bias, x.dtype)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        if self.fused_block:
            h = self._fused(x, self.norm1, self.conv1)
        else:
            h = self.conv1(self.norm1(x))
        h = h + self.temb_proj(F.silu(temb))[:, :, None, None]
        if self.fused_block and (self.dropout.p == 0.0 or not self.training):
            h = self._fused(h, self.norm2, self.conv2)
        else:
            h = self.conv2(self.dropout(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        elif hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Full spatial self-attention with 1x1 projections.  Logits and softmax
    in float32 (plain matmuls, as the JAX einsum chain does)."""

    def __init__(self, channels: int, fused_gn: bool = False):
        super().__init__()
        self.norm = Normalize(channels, fused_gn)
        self.q = Conv2d(channels, channels, 1)
        self.k = Conv2d(channels, channels, 1)
        self.v = Conv2d(channels, channels, 1)
        self.proj_out = Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        hn = self.norm(x)
        q = self.q(hn).reshape(b, c, h * w).transpose(1, 2)     # (b, hw, c)
        k = self.k(hn).reshape(b, c, h * w)                     # (b, c, hw)
        v = self.v(hn).reshape(b, c, h * w).transpose(1, 2)     # (b, hw, c)
        logits = torch.matmul(q.float(), k.float()) * (c ** -0.5)
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, c, h, w)
        return x + self.proj_out(out)
