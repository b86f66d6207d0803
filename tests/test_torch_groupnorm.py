"""PyTorch port: GroupNorm(+swish) against the Pallas kernel it replaces,
and its ``round_affine`` mode against the UNet's default route.

``fused_group_norm`` runs in the Pallas interpreter off the TPU.  Both sides
compute float32 statistics with the E[x^2] - E[x]^2 formula; they differ
only in summation order, so float32 outputs agree to the 2e-5 of
tests/test_groupnorm_pallas.py.  In bfloat16 both round the same float32
value once, so they differ by at most one bfloat16 ulp (<= 2**-6 relative
next to a power of two) where that value sits on a rounding boundary.

``round_affine`` rounds as the default route does (the affine rounded to
the activation dtype, the swish on that, rounded again): against that
route's eager chain it differs only where the statistics' own rounding
moves a float32 value across a bfloat16 boundary, a few elements in 10^5.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from wavedm_tpu.models.layers import Normalize as JaxNormalize
from wavedm_tpu.ops.groupnorm_pallas import fused_group_norm

from wavedm_tpu_torch.models.layers import Normalize
from wavedm_tpu_torch.ops import groupnorm_cuda
from wavedm_tpu_torch.ops.groupnorm_cuda import group_norm, group_norm_plain

# shared with the card's tests, whose file imports no JAX
from test_torch_cuda import (UNET_GN_SITES, assert_constant_group_holds,
                             assert_rounds_as_eager_chain,
                             constant_group_case, eager_chain)

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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("site", UNET_GN_SITES, ids=lambda s: "{}x{}x{}{}"
                         .format(*s[:3], "_swish" if s[3] else ""))
def test_round_affine_matches_the_eager_chain(site, dtype):
    """At each UNet site (two patches), ``round_affine`` is the default
    route's eager chain F.silu(F.group_norm(x.float()).to(x.dtype)), on
    the CPU through group_norm as through group_norm_plain; without it
    (the fused route's one rounding) a quarter of the bfloat16 outputs
    differ."""
    c, h, w, swish = site
    g = torch.Generator().manual_seed(c + h)
    x = (torch.randn(2, c, h, w, generator=g) * 3 + 1).to(dtype)
    wt, b = torch.randn(c, generator=g), torch.randn(c, generator=g)
    aff, ref = eager_chain(x, wt, b, swish)
    out = group_norm_plain(x, wt, b, 32, 1e-6, swish, round_affine=True)
    assert out.dtype == dtype
    assert_rounds_as_eager_chain(out, aff, ref, swish)
    assert torch.equal(group_norm(x, wt, b, 32, 1e-6, swish,
                                  round_affine=True), out)
    if dtype == torch.bfloat16 and swish:
        once = group_norm_plain(x, wt, b, 32, 1e-6, swish)
        assert float((once != ref).float().mean()) > 0.1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("swish", [False, True])
@pytest.mark.parametrize("c", [128, 384])
def test_round_affine_matches_jax_plain_normalize(c, swish, dtype):
    """``round_affine`` against the JAX package's plain Normalize (flax
    GroupNorm in the compute dtype, then swish), within the tolerances of
    test_plain_matches_pallas: JAX's bfloat16 swish rounds its sigmoid
    too, one more rounding than the port's."""
    rng = np.random.default_rng(c + swish)
    x = (rng.standard_normal((2, 8, 12, c)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)

    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    params = {"params": {"norm": {"scale": jnp.asarray(scale),
                                  "bias": jnp.asarray(bias)}}}
    ref = JaxNormalize(dtype=jdt, fold_swish=swish).apply(
        params, jnp.asarray(x, jdt))
    assert ref.dtype == jdt
    ref = np.asarray(ref.astype(jnp.float32)).transpose(0, 3, 1, 2)

    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(tdt)
    out = group_norm_plain(xt, torch.from_numpy(scale),
                           torch.from_numpy(bias), 32, 1e-6, swish,
                           round_affine=True)
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)
    else:
        np.testing.assert_allclose(out.float().numpy(), ref, atol=1e-6,
                                   rtol=BF16_ULP_REL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("swish", [False, True])
def test_default_normalize_on_cpu_is_the_eager_chain(swish, dtype):
    """Off the card ``Normalize(fused=False)`` runs the eager chain, bit
    for bit, with and without autograd, and launches nothing; under
    autograd its gradients are the eager chain's."""
    g = torch.Generator().manual_seed(7)
    norm = Normalize(64, swish=swish)
    with torch.no_grad():
        norm.weight.copy_(torch.randn(64, generator=g))
        norm.bias.copy_(torch.randn(64, generator=g))
    x = (torch.randn(2, 64, 6, 10, generator=g) * 2 + 0.5).to(dtype)
    before = dict(groupnorm_cuda.launches)
    with torch.no_grad():
        assert torch.equal(norm(x), eager_chain(x, norm.weight, norm.bias,
                                                swish)[1])
    xg = x.clone().requires_grad_()
    xe = x.clone().requires_grad_()
    w, b = (norm.weight.detach().clone().requires_grad_(),
            norm.bias.detach().clone().requires_grad_())
    y = norm(xg)
    ye = eager_chain(xe, w, b, swish)[1]
    assert torch.equal(y, ye)
    seed = torch.randn(y.shape, generator=g).to(dtype)
    (y.float() * seed.float()).sum().backward()
    (ye.float() * seed.float()).sum().backward()
    assert torch.equal(xg.grad, xe.grad)
    assert torch.equal(norm.weight.grad, w.grad)
    assert torch.equal(norm.bias.grad, b.grad)
    assert groupnorm_cuda.launches == before


@pytest.mark.parametrize("round_affine", [False, True],
                         ids=["fused", "round_affine"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_plain_clamps_a_negative_variance(dtype, round_affine):
    """A group of equal values whose float32 E[x^2] - E[x]^2 reads below
    -eps here: group_norm_plain clamps it at 0, as flax's GroupNorm does,
    so both roundings stay finite and hold the eager chain's output."""
    x, wt, b = constant_group_case(dtype, "cpu")
    xg = x.float()[:, 5].reshape(2, -1)
    assert bool(((xg * xg).mean(1) - xg.mean(1) ** 2 < -1e-6).all())
    for swish in (False, True):
        y = group_norm_plain(x, wt, b, 32, 1e-6, swish,
                             round_affine=round_affine)
        assert_constant_group_holds(y, x, wt, b, swish)
