"""Wrapper of the GroupNorm(+swish) CUDA kernel (``csrc/groupnorm.cu``).

A CPU tensor runs :func:`group_norm_plain`; a CUDA tensor launches the
kernel or raises.  Launches are counted in ``launches`` per instantiation
("f32", "f32_swish", "bf16", "bf16_swish").  The kernel has no gradient, so
:func:`group_norm` refuses to run under autograd on every device, as the
JAX package's ``fused_group_norm`` refuses ``jax.grad``.
"""

from __future__ import annotations

import torch

from wavedm_tpu_torch.ops import _build

__all__ = ["group_norm", "group_norm_plain", "launches", "VARIANTS"]

VARIANTS = ("f32", "f32_swish", "bf16", "bf16_swish")
_ENTRY = {torch.float32: ("group_norm_f32", "f32"),
          torch.bfloat16: ("group_norm_bf16", "bf16")}

# kernel launches since the last reset, by instantiation
launches = dict.fromkeys(VARIANTS, 0)


def group_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, num_groups: int = 32,
                     eps: float = 1e-6, swish: bool = False) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: float32 statistics
    E[x^2] - E[x]^2, eps inside the rsqrt, folded affine y = x*a + b,
    optional swish, output in x's dtype.  x: (N, C, *spatial)."""
    n, c = x.shape[:2]
    x32 = x.float()
    xg = x32.reshape(n, num_groups, -1)
    mean = xg.mean(dim=2)
    var = (xg * xg).mean(dim=2) - mean * mean
    inv = torch.rsqrt(var + eps)                               # (n, G)
    cg = c // num_groups
    a = inv.repeat_interleave(cg, dim=1) * weight.float()      # (n, C)
    b = bias.float() - mean.repeat_interleave(cg, dim=1) * a
    bshape = (n, c) + (1,) * (x.dim() - 2)
    y = x32 * a.reshape(bshape) + b.reshape(bshape)
    if swish:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-6,
               swish: bool = False) -> torch.Tensor:
    """GroupNorm(num_groups, eps) + affine (+ swish) over NCHW ``x``;
    weight/bias: (C,) float32.  Returns x's dtype.  Raises under autograd
    (grad mode on and an input that requires grad)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, weight, bias)):
        raise RuntimeError(
            "group_norm: the fused GroupNorm kernel has no gradient; "
            "train with parallel.fused_groupnorm: false (or "
            "fused_resblock: true)")
    if x.device.type == "cpu":
        return group_norm_plain(x, weight, bias, num_groups, eps, swish)
    lib = _build.library()
    if not x.is_cuda:
        raise ValueError(f"group_norm: expected a CUDA tensor, got {x.device}")
    if x.dtype not in _ENTRY:
        raise ValueError(f"group_norm: unsupported dtype {x.dtype}")
    if x.dim() < 2 or not x.is_contiguous():
        raise ValueError("group_norm: expected a contiguous (N, C, ...) tensor")
    n, c = x.shape[:2]
    if c % num_groups:
        raise ValueError(f"group_norm: {c} channels not divisible by "
                         f"{num_groups} groups")
    hw = x[0, 0].numel()
    if (c // num_groups) * hw >= 2 ** 31 or n * num_groups >= 2 ** 31:
        raise ValueError("group_norm: tensor too large for the kernel")
    for p, name in ((weight, "weight"), (bias, "bias")):
        if (p.device != x.device or p.dtype != torch.float32
                or p.shape != (c,) or not p.is_contiguous()):
            raise ValueError(f"group_norm: {name} must be a contiguous "
                             f"float32 ({c},) tensor on {x.device}")
    entry, tag = _ENTRY[x.dtype]
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = getattr(lib, entry)(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            n, c, hw, num_groups, eps, int(swish),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "group_norm")
    launches[tag + ("_swish" if swish else "")] += 1
    return y
