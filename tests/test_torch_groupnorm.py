"""PyTorch port: GroupNorm(+swish) against the Pallas kernel it replaces.

``fused_group_norm`` runs in the Pallas interpreter off the TPU.  Both sides
compute float32 statistics with the E[x^2] - E[x]^2 formula; they differ
only in summation order, so float32 outputs agree to the 2e-5 of
tests/test_groupnorm_pallas.py.  In bfloat16 both round the same float32
value once, so they differ by at most one bfloat16 ulp (<= 2**-6 relative
next to a power of two) where that value sits on a rounding boundary.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from wavedm_tpu.ops.groupnorm_pallas import fused_group_norm

from wavedm_tpu_torch.ops import groupnorm_cuda
from wavedm_tpu_torch.ops.groupnorm_cuda import group_norm, group_norm_plain

BF16_ULP_REL = 2.0 ** -6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("swish", [False, True])
@pytest.mark.parametrize("c", [32, 64, 96])
def test_plain_matches_pallas(c, swish, dtype):
    rng = np.random.default_rng(c + 2 * swish)
    x = (rng.standard_normal((2, 8, 12, c)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)

    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = fused_group_norm(jnp.asarray(x, jdt), jnp.asarray(scale),
                           jnp.asarray(bias), num_groups=32, swish=swish)
    ref = np.asarray(ref.astype(jnp.float32)).transpose(0, 3, 1, 2)

    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(tdt)
    out = group_norm(xt, torch.from_numpy(scale), torch.from_numpy(bias),
                     32, 1e-6, swish)
    assert out.dtype == tdt and out.shape == xt.shape
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)
    else:
        np.testing.assert_allclose(out.float().numpy(), ref, atol=1e-6,
                                   rtol=BF16_ULP_REL)


def test_plain_matches_torch_group_norm():
    """The folded-affine formula equals GroupNorm(32) + swish."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 128, 6, 5, generator=g) * 2 - 0.5
    w, b = torch.randn(128, generator=g), torch.randn(128, generator=g)
    ref = F.silu(F.group_norm(x, 32, w, b, 1e-6))
    torch.testing.assert_close(group_norm_plain(x, w, b, swish=True), ref,
                               atol=2e-5, rtol=2e-5)


def test_cpu_calls_run_plain_and_count_nothing():
    before = dict(groupnorm_cuda.launches)
    x = torch.randn(2, 64, 4, 4)
    w, b = torch.ones(64), torch.zeros(64)
    torch.testing.assert_close(group_norm(x, w, b), group_norm_plain(x, w, b))
    assert groupnorm_cuda.launches == before


@pytest.mark.parametrize("grad_of", ["x", "weight", "bias"])
def test_refuses_autograd_as_jax_does(grad_of):
    """The kernel has no gradient.  JAX's fused_group_norm refuses
    jax.grad; the port's group_norm refuses autograd on every device
    instead of cutting the gradient silently."""
    import jax

    xj = jnp.ones((1, 4, 4, 32))
    with pytest.raises(Exception, match="Linearization failed"):
        jax.grad(lambda a: jnp.sum(fused_group_norm(
            a, jnp.ones(32), jnp.zeros(32))))(xj)
    args = {"x": torch.randn(1, 32, 4, 4), "weight": torch.ones(32),
            "bias": torch.zeros(32)}
    args[grad_of].requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient"):
        group_norm(args["x"], args["weight"], args["bias"], swish=True)
    with torch.no_grad():        # inference under no_grad still runs
        group_norm(args["x"], args["weight"], args["bias"], swish=True)
