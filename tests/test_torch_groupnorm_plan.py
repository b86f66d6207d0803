"""PyTorch port: the GroupNorm kernel's launch plan (``group_norm_plan``)
and its split statistics, on the CPU.

The CUDA kernel runs only on the card; what decides its launch is Python.
For every norm site of the flagship UNet at several batch sizes, and for
odd shapes, the plan is walked block by block as ``csrc/groupnorm.cu``
walks it: every (n, g) segment is held exactly once, slices start and end
on 16-byte boundaries where the kernel takes vectors, and shared memory,
cluster size and grid stay within an H100's limits.  A plain emulation of
the split statistics (per-slice float32 (sum x, sum x^2), added in rank
order) is held to the Pallas kernel it replaces, run in the Pallas
interpreter as ``tests/test_torch_groupnorm.py`` runs it, at the float32
tolerance of ``tests/test_groupnorm_pallas.py`` (2e-5).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wavedm_tpu.ops.groupnorm_pallas import fused_group_norm

from wavedm_tpu_torch.ops.groupnorm_cuda import (GroupNormPlan,
                                                 group_norm_plan)

H100_SMEM_PER_BLOCK = 232_448      # bytes a block may use
MAX_GRID_X = 2 ** 31 - 1
GROUPS = 32

# The flagship UNet's norm sites at 64x64 patches (C, H = W), as
# chip_smoke.gn_sites finds them: 17 shapes over 51 sites a forward.
FLAGSHIP_SITES = [(128, 32), (128, 64), (256, 16), (256, 32), (256, 64),
                  (384, 32), (384, 64), (512, 8), (512, 16), (512, 32),
                  (768, 8), (768, 16), (768, 32), (1024, 16), (1280, 8),
                  (1280, 16), (1536, 8)]
# (C, H, W): HW not a multiple of 8 (nor of 4), one channel a group, HW = 1,
# and segments too large for one block or for the chip
ODD_SHAPES = [(64, 5, 7), (96, 33, 33), (32, 1, 3), (32, 64, 64),
              (256, 1, 1), (64, 150, 151), (2048, 64, 64), (128, 512, 512)]

CASES = ([(n, c, h, h, dt) for c, h in FLAGSHIP_SITES for n in (1, 2, 16, 90)
          for dt in ("float32", "bfloat16")]
         + [(n, c, h, w, dt) for c, h, w in ODD_SHAPES for n in (1, 3)
            for dt in ("float32", "bfloat16")])


def _walk(plan: GroupNormPlan, n: int, length: int):
    """(segment, start, length) of every slice the kernel holds, walked
    block by block as group_norm_onchip_kernel does."""
    segs = n * GROUPS
    if plan.cluster == 0:                       # stream: one block a segment
        assert plan.grid == segs
        return [(s, 0, length) for s in range(segs)]
    out = []
    for block in range(plan.grid):
        rank, cta = block % plan.cluster, block // plan.cluster
        for team in range(plan.segs_per_cta):
            seg = cta * plan.segs_per_cta + team
            start = rank * plan.slice
            size = max(0, min(length - start, plan.slice)) if seg < segs else 0
            if size:
                out.append((seg, start, size))
    return out


@pytest.mark.parametrize("n,c,h,w,dtype", CASES,
                         ids=[f"{n}x{c}x{h}x{w}-{d}" for n, c, h, w, d in CASES])
def test_plan_holds_every_segment_once_within_limits(n, c, h, w, dtype):
    tdt = getattr(torch, dtype)
    elem = 4 if dtype == "float32" else 2
    hw, length = h * w, (c // GROUPS) * h * w
    plan = group_norm_plan(n, c, hw, GROUPS, tdt)

    assert plan.cluster in (0, 1, 2, 4, 8)
    assert plan.segs_per_cta in (1, 2)
    assert plan.cluster <= 1 or plan.segs_per_cta == 1
    assert plan.threads in (128, 256)
    assert plan.cluster != 0 or plan.threads == 256     # the stream kernel
    assert 0 < plan.grid <= MAX_GRID_X
    assert plan.grid % max(plan.cluster, 1) == 0     # whole clusters
    assert plan.smem_bytes + 1024 <= H100_SMEM_PER_BLOCK
    if plan.cluster:
        assert plan.smem_bytes == plan.segs_per_cta * plan.slice * elem
        assert plan.cluster * plan.slice >= length
    if plan.cluster == 1:
        assert plan.slice == length

    # every element of every segment held exactly once, in order
    by_seg = {}
    for seg, start, size in _walk(plan, n, length):
        by_seg.setdefault(seg, []).append((start, size))
    assert sorted(by_seg) == list(range(n * GROUPS))
    for pieces in by_seg.values():
        pos = 0
        for start, size in sorted(pieces):
            assert start == pos and size > 0
            pos += size
        assert pos == length

    # vectors: every bulk copy starts and ends on a 16-byte boundary
    if plan.cluster and hw % (16 // elem) == 0:
        for seg, start, size in _walk(plan, n, length)[:4096]:
            assert ((seg * length + start) * elem) % 16 == 0
            assert (size * elem) % 16 == 0


def test_plan_flagship_sites_hold_on_chip_and_unaligned_goes_scalar():
    """At N = 90 every flagship site is held on chip (no stream kernel),
    and an unaligned tensor takes whole-element slices."""
    for c, h in FLAGSHIP_SITES:
        for dt in (torch.float32, torch.bfloat16):
            assert group_norm_plan(90, c, h * h, GROUPS, dt).cluster >= 1
    # 24,580 float32 a segment (96 KB + 16 B): two slices, of whole vectors
    # when the tensor is aligned, of whole elements when it is not
    aligned = group_norm_plan(1, 32, 24580, GROUPS, torch.float32)
    unaligned = group_norm_plan(1, 32, 24580, GROUPS, torch.float32,
                                aligned=False)
    assert (aligned.cluster, aligned.slice) == (2, 12292)
    assert (unaligned.cluster, unaligned.slice) == (2, 12290)


def split_stats_group_norm(x, weight, bias, cluster, eps=1e-6, swish=False):
    """The kernel's arithmetic with a segment split over ``cluster``
    slices (on 16-byte boundaries, as the plan cuts them): float32
    (sum x, sum x^2) per slice, added in rank order, then
    max(E[x^2] - E[x]^2, 0), the folded affine and swish; x: (N, C, H,
    W)."""
    n, c = x.shape[:2]
    x32 = x.float()
    xg = x32.reshape(n, GROUPS, -1)
    length = xg.shape[2]
    unit = 16 // x.element_size()
    sl = -(-length // cluster)
    sl = -(-sl // unit) * unit
    s1 = torch.zeros(n, GROUPS)
    s2 = torch.zeros(n, GROUPS)
    for r in range(cluster):
        part = xg[:, :, r * sl:(r + 1) * sl]
        s1 = s1 + part.sum(dim=2)
        s2 = s2 + (part * part).sum(dim=2)
    mean = s1 / length
    inv = torch.rsqrt((s2 / length - mean * mean).clamp_min(0) + eps)
    cg = c // GROUPS
    a = inv.repeat_interleave(cg, dim=1) * weight
    b = bias - mean.repeat_interleave(cg, dim=1) * a
    y = x32 * a[:, :, None, None] + b[:, :, None, None]
    if swish:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


@pytest.mark.parametrize("swish", [False, True])
@pytest.mark.parametrize("c", [32, 64, 96])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_split_statistics_match_pallas(cluster, c, swish):
    rng = np.random.default_rng(10 * cluster + c + swish)
    x = (rng.standard_normal((2, 8, 12, c)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    ref = fused_group_norm(jnp.asarray(x), jnp.asarray(scale),
                           jnp.asarray(bias), num_groups=GROUPS, swish=swish)
    ref = np.asarray(ref).transpose(0, 3, 1, 2)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    out = split_stats_group_norm(xt, torch.from_numpy(scale),
                                 torch.from_numpy(bias), cluster, swish=swish)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)
