"""GroupNorm(32, 1e-6) -> swish -> 3x3 SAME conv + bias: the ResnetBlock
prefix as one op (``csrc/fused_resblock.cu``).

:func:`fused_gn_swish_conv` is an autograd Function.  Its forward launches
the CUDA kernel for a CUDA tensor (or raises) and runs
:func:`fused_gn_swish_conv_plain` for a CPU tensor.  Its backward is the
JAX package's (``_bwd``): it recomputes through the plain composition
(two-pass variance, ``y`` rounded to the compute dtype, the conv in the
compute dtype) under autograd, on either device.  Only the inputs are
saved.  Launches are counted in ``launches`` per dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from wavedm_tpu_torch.ops import _build
from wavedm_tpu_torch.ops.groupnorm_cuda import group_norm_plain

__all__ = ["fused_gn_swish_conv", "fused_gn_swish_conv_plain",
           "fused_gn_swish_conv_reference", "launches", "GROUPS", "EPS"]

GROUPS = 32
EPS = 1e-6
_BN = 128     # the kernel's output-channel tile; weights are padded to it
_ENTRY = {torch.float32: "fused_gn_swish_conv_f32",
          torch.bfloat16: "fused_gn_swish_conv_bf16"}

# kernel launches since the last reset, by instantiation
launches = dict.fromkeys(_ENTRY.values(), 0)


def fused_gn_swish_conv_plain(x, weight_gn, bias_gn, w, b, compute_dtype):
    """The kernel's arithmetic in plain PyTorch: float32 statistics
    E[x^2] - E[x]^2, folded affine, swish in float32, y rounded to the
    compute dtype, the conv over the zero-padded y with float32
    accumulation (compute-dtype operands widened exactly), + b in float32,
    one rounding to x's dtype.  x: (N, Cin, H, W); w: (Cout, Cin, 3, 3)."""
    y = group_norm_plain(x.float(), weight_gn, bias_gn, GROUPS, EPS,
                         swish=True).to(compute_dtype)
    out = F.conv2d(y.float(), w.to(compute_dtype).float(), b.float(),
                   padding=1)
    return out.to(x.dtype)


def fused_gn_swish_conv_reference(x, weight_gn, bias_gn, w, b,
                                  compute_dtype):
    """The composition the backward differentiates: the plain counterpart
    of JAX ``_reference_impl`` (two-pass variance, y rounded to the compute
    dtype, the conv in the compute dtype, + b in float32)."""
    n, c = x.shape[:2]
    xg = x.float().reshape(n, GROUPS, -1)
    mean = xg.mean(dim=2, keepdim=True)
    var = (xg - mean).square().mean(dim=2, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + EPS)).reshape(x.shape)
    y = y * weight_gn.float()[:, None, None] + bias_gn.float()[:, None, None]
    y = (y * torch.sigmoid(y)).to(compute_dtype)
    out = F.conv2d(y, w.to(compute_dtype), padding=1)
    return (out.float() + b.float()[:, None, None]).to(x.dtype)


def _launch(x, weight_gn, bias_gn, w, b, compute_dtype):
    lib = _build.library()
    if not x.is_cuda:
        raise ValueError(
            f"fused_gn_swish_conv: expected a CUDA tensor, got {x.device}")
    if x.dtype not in _ENTRY or compute_dtype != x.dtype:
        raise ValueError(
            "fused_gn_swish_conv: the kernel takes float32 or bfloat16 x "
            f"with the compute dtype equal to it (got {x.dtype}, "
            f"{compute_dtype})")
    if not x.is_contiguous():
        raise ValueError("fused_gn_swish_conv: expected a contiguous NCHW x")
    n, cin, h, wd = x.shape
    cout = w.shape[0]
    if n * h * wd >= 2 ** 31:
        raise ValueError("fused_gn_swish_conv: tensor too large for the kernel")
    for t, name, size in ((weight_gn, "GroupNorm scale", cin),
                          (bias_gn, "GroupNorm bias", cin),
                          (b, "conv bias", cout), (w, "conv weight", None)):
        if t.device != x.device:
            raise ValueError(f"fused_gn_swish_conv: {name} on {t.device}, "
                             f"x on {x.device}")
        if size is not None and t.shape != (size,):
            raise ValueError(f"fused_gn_swish_conv: {name} must be ({size},)")
    # weights as (9*Cin, Cout_pad) in the compute dtype, row tap*Cin + ci
    cout_pad = -(-cout // _BN) * _BN
    wk = (torch.zeros if cout_pad != cout else torch.empty)(
        (9 * cin, cout_pad), dtype=x.dtype, device=x.device)
    wk[:, :cout] = w.permute(2, 3, 1, 0).reshape(9 * cin, cout)
    gamma = weight_gn.float().contiguous()
    beta = bias_gn.float().contiguous()
    bias = b.float().contiguous()
    ab = torch.empty(2 * n * cin, dtype=torch.float32, device=x.device)
    out = torch.empty((n, cout, h, wd), dtype=x.dtype, device=x.device)
    entry = _ENTRY[x.dtype]
    with torch.cuda.device(x.device):
        err = getattr(lib, entry)(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wk.data_ptr(),
            bias.data_ptr(), ab.data_ptr(), out.data_ptr(), n, cin, h, wd,
            cout, cout_pad, EPS,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "fused_gn_swish_conv")
    launches[entry] += 1
    return out


class _FusedGnSwishConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight_gn, bias_gn, w, b, compute_dtype):
        ctx.compute_dtype = compute_dtype
        ctx.save_for_backward(x, weight_gn, bias_gn, w, b)
        if x.device.type == "cpu":
            return fused_gn_swish_conv_plain(x, weight_gn, bias_gn, w, b,
                                             compute_dtype)
        return _launch(x, weight_gn, bias_gn, w, b, compute_dtype)

    @staticmethod
    def backward(ctx, gout):
        need = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(r)
                      for t, r in zip(ctx.saved_tensors, need)]
            out = fused_gn_swish_conv_reference(*leaves, ctx.compute_dtype)
            grads = iter(torch.autograd.grad(
                out, [t for t, r in zip(leaves, need) if r], gout))
        return (*(next(grads) if r else None for r in need), None)


def fused_gn_swish_conv(x: torch.Tensor, weight_gn: torch.Tensor,
                        bias_gn: torch.Tensor, w: torch.Tensor,
                        b: torch.Tensor,
                        compute_dtype: torch.dtype = torch.bfloat16
                        ) -> torch.Tensor:
    """GroupNorm(32, 1e-6) -> swish -> conv3x3 (SAME) + bias over NCHW x.

    x: (N, Cin, H, W) with Cin % 32 == 0; weight_gn, bias_gn: (Cin,);
    w: (Cout, Cin, 3, 3); b: (Cout,).  Returns (N, Cout, H, W) in x's
    dtype; differentiable in all five tensors."""
    if x.dim() != 4 or x.shape[1] % GROUPS:
        raise ValueError("fused_gn_swish_conv: expected (N, Cin, H, W) with "
                         f"Cin % {GROUPS} == 0, got {tuple(x.shape)}")
    if w.dim() != 4 or w.shape[1:] != (x.shape[1], 3, 3):
        raise ValueError("fused_gn_swish_conv: expected a (Cout, "
                         f"{x.shape[1]}, 3, 3) weight, got {tuple(w.shape)}")
    return _FusedGnSwishConv.apply(x, weight_gn, bias_gn, w, b,
                                   compute_dtype)
