"""PyTorch port: Haar wavelet transforms against the JAX package.

Inputs are drawn with numpy and handed to both sides.  The filters are
+-2**-s, so each coefficient is a float32 sum of ks² exactly scaled terms;
two summation orders differ by a few float32 ulps of the coefficient
magnitude (<= 2**scale for inputs in [-1, 1]) -- hence the 2e-6 of
tests/test_wavelet_pallas.py at scale 2, scaled by 2**(scale-2) elsewhere.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wavedm_tpu.ops.wavelet import haar_packet_basis as jax_basis
from wavedm_tpu.ops.wavelet import wavelet_dec as jax_dec
from wavedm_tpu.ops.wavelet import wavelet_rec as jax_rec
from wavedm_tpu.ops.wavelet import conv_weights as jax_conv_weights
from wavedm_tpu.ops.wavelet_pallas import wavelet_dec_pallas, wavelet_rec_pallas

from wavedm_tpu_torch.ops.wavelet import (conv_weights, haar_packet_basis,
                                          wavelet_dec, wavelet_rec)
from wavedm_tpu_torch.ops.wavelet_cuda import (wavelet_dec_cuda,
                                               wavelet_rec_cuda)


def _tol(scale):
    return 2e-6 * 2.0 ** max(scale - 2, 0)


@pytest.mark.parametrize("scale", [1, 2, 3])
def test_basis_and_conv_bank_match_jax(scale):
    np.testing.assert_array_equal(haar_packet_basis(scale), jax_basis(scale))
    np.testing.assert_array_equal(conv_weights(scale), jax_conv_weights(scale))


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
@pytest.mark.parametrize("scale", [1, 2, 3])
def test_dec_rec_match_jax(scale, layout):
    rng = np.random.default_rng(scale)
    shape = (2, 32, 48, 3) if layout == "NHWC" else (2, 3, 32, 48)
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    z = wavelet_dec(torch.from_numpy(x), scale, layout)
    zj = np.asarray(jax_dec(jnp.asarray(x), scale, layout))
    assert tuple(z.shape) == zj.shape
    np.testing.assert_allclose(z.numpy(), zj, atol=_tol(scale), rtol=0)

    c = rng.uniform(-1, 1, zj.shape).astype(np.float32)
    y = wavelet_rec(torch.from_numpy(c), scale, layout)
    yj = np.asarray(jax_rec(jnp.asarray(c), scale, layout))
    np.testing.assert_allclose(y.numpy(), yj, atol=_tol(scale), rtol=0)


def test_scale2_plain_matches_pallas_kernel():
    """The CUDA kernel's plain version against the Pallas kernel it
    replaces (interpret mode), both directions."""
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (2, 64, 48, 3)).astype(np.float32)
    zp = np.asarray(wavelet_dec_pallas(jnp.asarray(x), interpret=True))
    z = wavelet_dec_cuda(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    np.testing.assert_allclose(z.permute(0, 2, 3, 1).numpy(), zp, atol=2e-6)

    c = rng.uniform(-1, 1, (1, 16, 12, 48)).astype(np.float32)
    yp = np.asarray(wavelet_rec_pallas(jnp.asarray(c), interpret=True))
    y = wavelet_rec_cuda(torch.from_numpy(c).permute(0, 3, 1, 2).contiguous())
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), yp, atol=2e-6)


def test_roundtrip_at_480x720():
    """The main path's geometry: 480x720 RGB -> 120x180x48 and back."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 3, 480, 720)).astype(np.float32))
    z = wavelet_dec(x)
    assert tuple(z.shape) == (1, 48, 120, 180)
    back = wavelet_rec(z)
    assert float((back - x).abs().max()) <= 2e-6


def test_wrappers_do_not_count_cpu_calls():
    from wavedm_tpu_torch.ops import wavelet_cuda

    before = dict(wavelet_cuda.launches)
    wavelet_rec(wavelet_dec(torch.zeros(1, 3, 8, 8)))
    assert wavelet_cuda.launches == before
