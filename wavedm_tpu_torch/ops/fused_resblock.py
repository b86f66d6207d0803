"""GroupNorm(32, 1e-6) -> swish -> 3x3 SAME conv + bias: the ResnetBlock
prefix as one op (``csrc/fused_resblock.cu``).

:func:`fused_gn_swish_conv` is an autograd Function.  Its forward launches
the CUDA kernel for a CUDA tensor (or raises) and runs
:func:`fused_gn_swish_conv_plain` for a CPU tensor.  Its backward is the
JAX package's (``_bwd``): it recomputes through the plain composition
(two-pass variance, ``y`` rounded to the compute dtype, the conv in the
compute dtype) under autograd, on either device.  Only the inputs are
saved.  Launches are counted in ``launches`` per compute dtype; x may be
float32 or bfloat16 whatever the compute dtype, and the output takes x's
dtype.  The kernel's weight layout (:func:`weight_layout`) is cached per
frozen weight tensor (:func:`kernel_weight`).  With a work counter active
(``utils/work.py``) a launch records its :func:`declared_work`, and the
backward counts as :func:`declared_backward_work` (its recompute's flops
are not the model's): the plain route's counts, whatever runs.
"""

from __future__ import annotations

import contextlib
import functools
import weakref

import torch
import torch.nn.functional as F

from wavedm_tpu_torch.ops import _build
from wavedm_tpu_torch.ops.groupnorm_cuda import group_norm_plain
from wavedm_tpu_torch.utils import work

__all__ = ["fused_gn_swish_conv", "fused_gn_swish_conv_plain",
           "fused_gn_swish_conv_reference", "weight_layout", "kernel_weight",
           "split_k", "declared_work", "declared_backward_work", "launches",
           "GROUPS", "EPS"]

GROUPS = 32
EPS = 1e-6
_BM = 128     # the kernel's output-pixel tile
_BN = 128     # its output-channel tile; weights are padded to it
_CK = 32      # its input-channel chunk
_ENTRY = {torch.float32: "fused_gn_swish_conv_f32",
          torch.bfloat16: "fused_gn_swish_conv_bf16"}

# kernel launches since the last reset, by compute dtype
launches = dict.fromkeys(_ENTRY.values(), 0)


def _size(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def declared_work(x_shape, cout: int, x_dtype: torch.dtype,
                  compute_dtype: torch.dtype) -> tuple:
    """(flops, xla_flops, bytes) of one launch on x of ``x_shape`` (N, Cin,
    H, W): what the counter counts for :func:`fused_gn_swish_conv_plain`
    (the conv's dense 2*N*H*W*9*Cin*Cout; in XLA's convention its taps on
    real pixels, the bias add, and GroupNorm and swish as
    ``group_norm_plain`` counts them), and the bytes the kernel must move:
    x, the float32 GroupNorm scale and shift, the weight in the compute
    dtype and the float32 bias read, the output (in x's dtype) written."""
    n, cin, h, w = x_shape
    out = (n, cout, h, w)
    flops, conv_xla = work.conv_work(x_shape, (cout, cin, 3, 3), out,
                                     padding=(1,), bias=True)
    xla = conv_xla + work.group_norm_xla_flops(n * cin * h * w, n, cin,
                                               GROUPS, True)
    nbytes = (n * (cin + cout) * h * w * _size(x_dtype) + 4 * (2 * cin + cout)
              + 9 * cin * cout * _size(compute_dtype))
    return flops, xla, nbytes


def declared_backward_work(x_shape, cout: int, needs) -> tuple:
    """(flops, xla_flops) of the backward, as the plain route counts its
    ops: the conv's backward (torch's formula for the input's and the
    weight's gradients; in XLA's convention their taps on real pixels and
    the bias gradient's reduction), swish's and GroupNorm's gradients
    (``utils/work.py``).  ``needs``: which of x, the GroupNorm scale and
    shift, the weight and the bias need a gradient."""
    need_x, need_g, need_b, need_w, need_bias = needs
    n, cin, h, w = x_shape
    x4, w4, go = list(x_shape), [cout, cin, 3, 3], [n, cout, h, w]
    need_y = need_x or need_g or need_b        # the conv input's gradient
    flops = (need_y * work.conv_flop_count(go, w4, x4, transposed=True)
             + need_w * work.conv_flop_count([cin, n, h, w], [cout, n, h, w],
                                             [cin, cout, 3, 3]))
    valid = work.conv_valid_taps(x4, w4, (1,), (1,), (1,))
    numel = n * cin * h * w
    xla = 2 * valid * (int(need_y) + int(need_w))
    if need_bias:
        xla += n * cout * h * w - cout
    if need_y:
        xla += (work.SILU_BACKWARD_XLA * numel
                + work.group_norm_backward_xla_flops(numel, need_x,
                                                     need_g or need_b))
    return flops, xla


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


def weight_layout(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The kernel's weight operand from (Cout, Cin, 3, 3), in ``dtype``,
    output channels zero-padded to a multiple of the kernel's 128-channel
    tile (Cout_pad), tap = 3*dy + dx:

    - bfloat16: blocked as the tensor cores read it, so that the weights of
      one (128-channel tile, 32-channel chunk) are one contiguous run:
      (Cout_pad/128, Cin/32, 9, 4, 16, 8, 8) indexed (n tile, chunk, tap,
      k8 block, n8 block, n % 8, k % 8), element
      ``w[128*nt + 8*j + r, 32*c + 8*q + e, dy, dx]``;
    - float32: (9*Cin, Cout_pad), row tap*Cin + ci, ``w.permute(2, 3, 1, 0)``.
    """
    cout, cin = w.shape[:2]
    pad = -(-cout // _BN) * _BN - cout
    w = w.detach().to(dtype)
    if dtype == torch.bfloat16:
        wp = F.pad(w, (0, 0, 0, 0, 0, 0, 0, pad)).reshape(
            -1, 16, 8, cin // _CK, 4, 8, 9)        # nt, j, r, c, q, e, tap
        return wp.permute(0, 3, 6, 4, 1, 2, 5).contiguous()
    wk = w.permute(2, 3, 1, 0).reshape(9 * cin, cout)
    return F.pad(wk, (0, pad)).contiguous()


# id(weight) -> (weakref to it, (data_ptr, version, dtype), its layout)
_layouts = {}


def _forget(key, ref):
    if _layouts.get(key, (None,))[0] is ref:
        del _layouts[key]


def kernel_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """:func:`weight_layout`, cached per weight tensor while the weight
    does not require grad (serving: frozen weights).  The entry is keyed by
    the tensor's storage address and version counter, so an in-place
    ``copy_`` or ``load_state_dict`` rebuilds it; it dies with the tensor.
    A weight that requires grad (training) is laid out anew each call."""
    if w.requires_grad:
        return weight_layout(w, dtype)
    key = (w.data_ptr(), w._version, dtype)
    hit = _layouts.get(id(w))
    if hit is not None and hit[0]() is w and hit[1] == key:
        return hit[2]
    wk = weight_layout(w, dtype)
    _layouts[id(w)] = (weakref.ref(w, functools.partial(_forget, id(w))),
                       key, wk)
    return wk


def split_k(m: int, cout: int, cin: int, sm_count: int) -> int:
    """How many tiles share the Cin chunks of one (128-pixel x 128-channel)
    output tile.  The kernel runs one persistent block an SM over the
    tiles.  When there are fewer tiles than SMs, or their last round leaves
    SMs idle, splitting K evens it out, at the cost of a round trip of
    float32 partials.  Takes the fewest splits (at most 8, at least one
    32-channel chunk each) within 10 points of the best share of busy SM
    rounds; once the tiles fill the SMs, each split keeps at least 13
    chunks (on the H100 the 8x8 sites at N = 90 gained from splitting only
    at Cin >= 1280)."""
    tiles = -(-m // _BM) * -(-cout // _BN)
    chunks = cin // _CK
    most = min(chunks, 8) if tiles < sm_count else max(1, chunks // 13)
    share = {s: tiles * s / (-(-tiles * s // sm_count) * sm_count)
             for s in range(1, min(most, 8) + 1)}
    best = max(share.values())
    return min(s for s, v in share.items() if v >= best - 0.1)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _launch(x, weight_gn, bias_gn, w, b, compute_dtype):
    lib = _build.library()
    if not x.is_cuda:
        raise ValueError(
            f"fused_gn_swish_conv: expected a CUDA tensor, got {x.device}")
    if x.dtype not in _ENTRY or compute_dtype not in _ENTRY:
        raise ValueError(
            "fused_gn_swish_conv: the kernel takes float32 or bfloat16 x "
            f"and compute dtype (got {x.dtype}, {compute_dtype})")
    if not x.is_contiguous():
        raise ValueError("fused_gn_swish_conv: expected a contiguous NCHW x")
    n, cin, h, wd = x.shape
    cout = w.shape[0]
    m = n * h * wd
    if m + 2 * wd + 2 * _BM >= 2 ** 31:
        raise ValueError("fused_gn_swish_conv: tensor too large for the kernel")
    for t, name, size in ((weight_gn, "GroupNorm scale", cin),
                          (bias_gn, "GroupNorm bias", cin),
                          (b, "conv bias", cout), (w, "conv weight", None)):
        if t.device != x.device:
            raise ValueError(f"fused_gn_swish_conv: {name} on {t.device}, "
                             f"x on {x.device}")
        if size is not None and t.shape != (size,):
            raise ValueError(f"fused_gn_swish_conv: {name} must be ({size},)")
    wk = kernel_weight(w, compute_dtype)
    cout_pad = -(-cout // _BN) * _BN
    gamma = weight_gn.float().contiguous()
    beta = bias_gn.float().contiguous()
    bias = b.float().contiguous()
    splits = split_k(m, cout, cin, _sm_count(x.device.index))
    ab = torch.empty(2 * n * cin, dtype=torch.float32, device=x.device)
    ws = (torch.empty(splits * cout_pad * m, dtype=torch.float32,
                      device=x.device) if splits > 1 else None)
    out = torch.empty((n, cout, h, wd), dtype=x.dtype, device=x.device)
    entry = _ENTRY[compute_dtype]
    _build.launch(lib, entry, x.get_device(), x.data_ptr(), gamma.data_ptr(),
                  beta.data_ptr(), wk.data_ptr(), bias.data_ptr(),
                  ab.data_ptr(), None if ws is None else ws.data_ptr(),
                  out.data_ptr(), n, cin, h, wd, cout, cout_pad, splits,
                  int(x.dtype == torch.bfloat16), EPS)
    launches[entry] += 1
    if work.active():
        work.record("kernel:" + entry, *declared_work(
            x.shape, cout, x.dtype, compute_dtype))
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
        x, w = ctx.saved_tensors[0], ctx.saved_tensors[3]
        unit = (work.declared("fused_gn_swish_conv_backward",
                              *declared_backward_work(x.shape, w.shape[0],
                                                      need))
                if work.active() else contextlib.nullcontext())
        with unit, torch.enable_grad():
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
