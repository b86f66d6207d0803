"""PyTorch port: the fused GroupNorm -> swish -> conv3x3 op against the JAX
package's ``fused_gn_swish_conv`` (its Pallas kernel in interpret mode on
the CPU) and ``_reference_impl``.

Tolerances: float32 outputs at 2e-4 (``tests/test_fused_resblock.py``'s own
bound; only the summation order and the variance formula differ).  With a
bfloat16 compute dtype both sides round y and the weights to bfloat16 once
and accumulate in float32; a y value sitting on a rounding boundary may
round the other way, so outputs are held to 2**-7 of their scale.
Gradients go through the same composition on both sides (the JAX custom
VJP recomputes through ``_reference_impl``, the port through its plain
counterpart) and are held to 1e-4 of each gradient's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wavedm_tpu.ops.fused_resblock as fr

from wavedm_tpu_torch.ops.fused_resblock import (fused_gn_swish_conv,
                                                 fused_gn_swish_conv_plain)


def _mk(n=2, h=8, w=16, cin=128, cout=128, seed=0):
    """Inputs in the JAX layout (NHWC, HWIO), as tests/test_fused_resblock.py
    draws them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    scale = (rng.standard_normal(cin) * 0.1 + 1).astype(np.float32)
    bias = (rng.standard_normal(cin) * 0.1).astype(np.float32)
    wk = (rng.standard_normal((3, 3, cin, cout)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return x, scale, bias, wk, b


def _torch(x, scale, bias, wk, b, dtype=torch.float32):
    """The same inputs in the port's layout (NCHW, OIHW)."""
    return (torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(dtype),
            torch.from_numpy(scale), torch.from_numpy(bias),
            torch.from_numpy(wk.transpose(3, 2, 0, 1).copy()),
            torch.from_numpy(b))


def _nhwc(t):
    return t.float().detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("shape", [(1, 8, 8, 128, 128), (2, 8, 16, 128, 256)],
                         ids=["8x8_128to128", "8x16_128to256"])
def test_matches_jax_kernel_f32(shape):
    n, h, w, cin, cout = shape
    args = _mk(n, h, w, cin, cout)
    want = np.asarray(fr.fused_gn_swish_conv(
        *map(jnp.asarray, args), jnp.float32))
    targs = _torch(*args)
    for fn in (fused_gn_swish_conv_plain, fused_gn_swish_conv):
        got = _nhwc(fn(*targs, torch.float32))
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_bf16_compute_matches_jax_reference(x_dtype):
    args = _mk(1, 8, 8, 128, 128, seed=3)
    jx = jnp.asarray(args[0], jnp.bfloat16 if x_dtype == torch.bfloat16
                     else jnp.float32)
    want = np.asarray(fr._reference_impl(
        jx, *map(jnp.asarray, args[1:]), compute_dtype=jnp.bfloat16),
        np.float32)
    got = fused_gn_swish_conv(*_torch(*args, dtype=x_dtype), torch.bfloat16)
    assert got.dtype == x_dtype
    err = float(np.abs(_nhwc(got) - want).max())
    assert err <= 2.0 ** -7 * float(np.abs(want).max()), err


def test_gradients_match_jax_custom_vjp():
    args = _mk(1, 8, 8, 128, 128, seed=1)
    g = np.random.default_rng(2).standard_normal(
        (1, 8, 8, 128)).astype(np.float32)

    def loss(*a):
        return jnp.sum(fr.fused_gn_swish_conv(*a, jnp.float32) * g)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))
    targs = [t.requires_grad_() for t in _torch(*args)]
    out = fused_gn_swish_conv(*targs, torch.float32)
    (out * torch.from_numpy(g.transpose(0, 3, 1, 2).copy())).sum().backward()
    got = [targs[0].grad.numpy().transpose(0, 2, 3, 1),
           targs[1].grad.numpy(), targs[2].grad.numpy(),
           targs[3].grad.numpy().transpose(2, 3, 1, 0), targs[4].grad.numpy()]
    for name, a, c in zip(("x", "scale", "bias", "w", "b"), got, want):
        c = np.asarray(c)
        assert a.shape == c.shape, name
        err = float(np.abs(a - c).max())
        assert err <= 1e-4 * float(np.abs(c).max()), (name, err)


def _numpy_op(x, scale, bias, w, b, pad_y=True):
    """Independent float64 numpy version (NCHW, OIHW); ``pad_y=False``
    zero-pads x before the norm instead, the fault the test must catch."""
    x = x.astype(np.float64)
    if not pad_y:
        x = np.pad(x, ((0, 0), (0, 0), (1, 1), (1, 1)))
    n, c, h, wd = x.shape
    xg = x.reshape(n, 32, -1)
    mean = xg.mean(-1, keepdims=True)
    var = xg.var(-1, keepdims=True)
    y = ((xg - mean) / np.sqrt(var + 1e-6)).reshape(x.shape)
    y = y * scale[:, None, None] + bias[:, None, None]
    y = y / (1 + np.exp(-y))
    if pad_y:
        y = np.pad(y, ((0, 0), (0, 0), (1, 1), (1, 1)))
        h, wd = h + 2, wd + 2
    out = np.zeros((n, w.shape[0], h - 2, wd - 2))
    for dy in range(3):
        for dx in range(3):
            out += np.einsum("nchw,oc->nohw", y[:, :, dy:dy + h - 2,
                                                dx:dx + wd - 2], w[:, :, dy, dx])
    return out + b[:, None, None]


def test_same_padding_pads_the_normalized_activation():
    """The zero border is applied after normalize+swish: with a large
    GroupNorm shift, swish(shift) != 0, so padding x instead changes every
    border pixel."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 32, 5, 7)).astype(np.float32)
    scale = np.ones(32, np.float32)
    bias = np.full(32, 2.0, np.float32)
    w = (rng.standard_normal((32, 32, 3, 3)) * 0.1).astype(np.float32)
    b = np.zeros(32, np.float32)
    got = fused_gn_swish_conv(*map(torch.from_numpy, (x, scale, bias, w, b)),
                              torch.float32).numpy()
    np.testing.assert_allclose(got, _numpy_op(x, scale, bias, w, b),
                               atol=1e-4, rtol=1e-4)
    wrong = _numpy_op(x, scale, bias, w, b, pad_y=False)
    assert float(np.abs(got - wrong).max()) > 0.1


@pytest.mark.parametrize("cin", [48, 100])
def test_channels_not_a_multiple_of_32_raise(cin):
    x = torch.zeros(1, cin, 4, 4)
    with pytest.raises(ValueError, match="Cin % 32"):
        fused_gn_swish_conv(x, torch.ones(cin), torch.zeros(cin),
                            torch.zeros(32, cin, 3, 3), torch.zeros(32),
                            torch.float32)
