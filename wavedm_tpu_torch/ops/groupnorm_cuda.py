"""Wrapper of the GroupNorm(+swish) CUDA kernel (``csrc/groupnorm.cu``).

A CPU tensor runs :func:`group_norm_plain`; a CUDA tensor launches the
kernel or raises.  :func:`group_norm_plan` sizes the launch (how a segment
is held on chip).  The kernel has two roundings: the fused route's (the
JAX package's Pallas kernel: swish on the float32 affine, one rounding)
and, with ``round_affine``, the default route's (flax's GroupNorm in the
compute dtype, then a swish on its output: the affine rounded to x's dtype,
the swish on that, rounded again).  Launches are counted in ``launches``
per variant ("f32", "f32_swish", "bf16", "bf16_swish", and the same with
"_plain" after the dtype for ``round_affine``); a launch records its
:func:`declared_work` with a work counter (``utils/work.py``) under
"kernel:group_norm_" and the variant.  The kernel has no gradient, so
:func:`group_norm` refuses to run under autograd on every device, as the
JAX package's ``fused_group_norm`` refuses ``jax.grad``.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from wavedm_tpu_torch.ops import _build
from wavedm_tpu_torch.utils import work

__all__ = ["group_norm", "group_norm_plain", "group_norm_plan",
           "GroupNormPlan", "autograd_records", "declared_work", "launches",
           "DTYPES", "VARIANTS"]

VARIANTS = ("f32", "f32_swish", "bf16", "bf16_swish", "f32_plain",
            "f32_plain_swish", "bf16_plain", "bf16_plain_swish")
_ENTRY = {torch.float32: ("group_norm_f32", "f32"),
          torch.bfloat16: ("group_norm_bf16", "bf16")}
DTYPES = tuple(_ENTRY)          # the activation dtypes the kernel takes
SWISH, ROUND_AFFINE = 1, 2      # the bits of the kernel's epilogue mode
# variant name by (dtype, mode)
_VARIANT = {(dt, mode): tag + ("_plain" if mode & ROUND_AFFINE else "")
            + ("_swish" if mode & SWISH else "")
            for dt, (_, tag) in _ENTRY.items() for mode in range(4)}

# kernel launches since the last reset, by instantiation
launches = dict.fromkeys(VARIANTS, 0)

THREADS = 256               # the kernel's block ...
SMALL_THREADS = 128         # ... for segments under SMALL_BYTES
SMALL_BYTES = 24 * 1024
PACK_BYTES = 8 * 1024       # segments up to this go two to a block
MAX_CLUSTER = 8             # portable thread-block cluster size
SLICE_BYTES = 96 * 1024     # most bytes a block holds: 2 blocks an SM
SMEM_MAX = 232_448 - 1024   # an H100 block's shared memory, less statics
SMS = 132                   # an H100's SMs


class GroupNormPlan(NamedTuple):
    """How ``csrc/groupnorm.cu`` runs one call.  ``cluster`` blocks share
    one (n, g) segment, each holding ``slice`` of its elements in shared
    memory (``cluster`` 1: the block holds ``segs_per_cta`` whole
    segments); ``cluster`` 0 is the two-pass stream kernel, one block a
    segment, for segments too large to hold on chip."""
    cluster: int
    segs_per_cta: int
    slice: int             # elements a block holds of one segment
    threads: int
    smem_bytes: int        # dynamic shared memory a block
    grid: int              # blocks

    @property
    def kind(self) -> str:
        return "stream" if self.cluster == 0 else (
            "cluster" if self.cluster > 1 else "packed" if
            self.segs_per_cta > 1 else "block")


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=4096)
def group_norm_plan(n: int, c: int, hw: int, groups: int,
                    dtype: torch.dtype, aligned: bool = True
                    ) -> GroupNormPlan:
    """The launch for x of shape (n, c, hw) in ``dtype`` (float32 or
    bfloat16).  A segment of L = (c/groups)*hw elements takes the fewest
    cluster blocks (1, 2, 4, 8) whose slices stay within SLICE_BYTES, a
    slice a whole number of 16-byte vectors when the vectors fit (hw a
    multiple of 16/element bytes and ``aligned`` tensors); else 8 blocks
    if their slices fit SMEM_MAX; else the stream kernel.  A segment under
    SMALL_BYTES takes a block of SMALL_THREADS, and one of PACK_BYTES or
    less shares it with the next, as long as that leaves two blocks for
    each SM.  (``chip_smoke.py --phases sweep`` times every cluster size,
    pairing and block size at the flagship's sites, N = 90: on the H100
    these choices came within half a point of the best share of the bound
    at each of the 34 site shapes.)"""
    elem = torch.empty((), dtype=dtype).element_size()
    vec = 16 // elem
    unit = vec if aligned and hw % vec == 0 else 1
    length = (c // groups) * hw
    segs = n * groups
    fits = [(k, _ceil(_ceil(length, k), unit) * unit)
            for k in (1, 2, 4, MAX_CLUSTER)]
    fits = [(k, sl) for k, sl in fits if k == 1 or (k - 1) * sl < length]
    k, sl = next(((k, sl) for k, sl in fits if sl * elem <= SLICE_BYTES),
                 fits[-1])
    if sl * elem > SMEM_MAX:
        return GroupNormPlan(0, 1, length, THREADS, 2 * (c // groups) * 4,
                             segs)
    small = k == 1 and sl * elem < SMALL_BYTES
    m = 2 if (small and sl * elem <= PACK_BYTES
              and _ceil(segs, 2) >= 2 * SMS) else 1
    return GroupNormPlan(k, m, sl, SMALL_THREADS if small else THREADS,
                         m * sl * elem, _ceil(segs, m) * k)


def declared_work(n: int, c: int, hw: int, groups: int, swish: bool,
                  dtype: torch.dtype) -> tuple:
    """(flops, xla_flops, bytes) of one launch on x of shape (n, c, hw) in
    ``dtype``: what the counter counts for :func:`group_norm_plain` (no
    dense flops; its elementwise work in XLA's convention), and the bytes
    the kernel moves: x read, y written, the float32 scale and shift
    read."""
    numel = n * c * hw
    nbytes = 2 * numel * torch.empty((), dtype=dtype).element_size()
    return (0, work.group_norm_xla_flops(numel, n, c, groups, swish),
            nbytes + 2 * 4 * c)


def group_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, num_groups: int = 32,
                     eps: float = 1e-6, swish: bool = False, *,
                     round_affine: bool = False) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: float32 statistics
    E[x^2] - E[x]^2 (at least 0, as flax clamps it), eps inside the rsqrt, folded affine y = x*a + b,
    optional swish, output in x's dtype.  ``round_affine`` rounds y to x's
    dtype before the swish (the default route's rounding).
    x: (N, C, *spatial)."""
    n, c = x.shape[:2]
    x32 = x.float()
    xg = x32.reshape(n, num_groups, -1)
    mean = xg.mean(dim=2)
    var = ((xg * xg).mean(dim=2) - mean * mean).clamp_min(0)
    inv = torch.rsqrt(var + eps)                               # (n, G)
    cg = c // num_groups
    a = inv.repeat_interleave(cg, dim=1) * weight.float()      # (n, C)
    b = bias.float() - mean.repeat_interleave(cg, dim=1) * a
    bshape = (n, c) + (1,) * (x.dim() - 2)
    y = x32 * a.reshape(bshape) + b.reshape(bshape)
    if round_affine:
        y = y.to(x.dtype).float()
    if swish:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def autograd_records(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor) -> bool:
    """Whether autograd would record a GroupNorm of these tensors: the
    kernel has no gradient, so :func:`group_norm` refuses such a call."""
    return torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                        or bias.requires_grad)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-6,
               swish: bool = False, *,
               round_affine: bool = False) -> torch.Tensor:
    """GroupNorm(num_groups, eps) + affine (+ swish) over NCHW ``x``;
    weight/bias: (C,) float32.  Returns x's dtype, rounded as
    :func:`group_norm_plain` with the same ``round_affine``.  Raises under
    autograd (grad mode on and an input that requires grad)."""
    if autograd_records(x, weight, bias):
        raise RuntimeError(
            "group_norm: the fused GroupNorm kernel has no gradient; "
            "train with parallel.fused_groupnorm: false (or "
            "fused_resblock: true)")
    if x.device.type == "cpu":
        return group_norm_plain(x, weight, bias, num_groups, eps, swish,
                                round_affine=round_affine)
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
    hw = math.prod(x.shape[2:])
    if (c // num_groups) * hw >= 2 ** 31 or n * num_groups >= 2 ** 31:
        raise ValueError("group_norm: tensor too large for the kernel")
    for p, name in ((weight, "weight"), (bias, "bias")):
        if (p.device != x.device or p.dtype != torch.float32
                or p.shape != (c,) or not p.is_contiguous()):
            raise ValueError(f"group_norm: {name} must be a contiguous "
                             f"float32 ({c},) tensor on {x.device}")
    mode = (SWISH if swish else 0) | (ROUND_AFFINE if round_affine else 0)
    y = torch.empty_like(x)
    plan = group_norm_plan(n, c, hw, num_groups, x.dtype,
                           x.data_ptr() % 16 == 0)
    _build.launch(lib, _ENTRY[x.dtype][0], x.get_device(), x.data_ptr(),
                  weight.data_ptr(), bias.data_ptr(), y.data_ptr(), n, c, hw,
                  num_groups, eps, mode, plan.cluster, plan.segs_per_cta,
                  plan.slice, plan.threads)
    name = _VARIANT[x.dtype, mode]
    launches[name] += 1
    if work.active():
        work.record("kernel:group_norm_" + name,
                    *declared_work(n, c, hw, num_groups, swish, x.dtype))
    return y
