"""PyTorch port: the numpy-only metrics against ``wavedm_tpu/utils/metrics.py``.

The JAX package's SSIM filters with ``cv2.filter2D`` where cv2 is
installed (it is on this host); the port applies the same 11x11 Gaussian
window as two valid 1-D passes in float64, so the interior values part
only by summation order: the filter is held to cv2's to 1e-9 on [0,255]
data, SSIM to 1e-9 absolute.  The PSNR variants are the same arithmetic:
held to rtol 1e-12.
"""

import cv2
import numpy as np
import pytest

from wavedm_tpu.utils import metrics as jax_metrics

from wavedm_tpu_torch.utils import metrics


def _pair(seed, shape=(48, 64, 3), noise=0.05):
    rng = np.random.default_rng(seed)
    gt = rng.random(shape).astype(np.float32)
    pred = np.clip(gt + noise * rng.standard_normal(shape), -0.1, 1.1)
    return gt, pred.astype(np.float32)


def test_gaussian_kernel_is_cv2s():
    np.testing.assert_allclose(metrics.gaussian_kernel(),
                               cv2.getGaussianKernel(11, 1.5)[:, 0],
                               rtol=1e-15, atol=0)


@pytest.mark.parametrize("shape", [(11, 11), (48, 64), (120, 97)])
def test_separable_filter_matches_cv2_filter2d(shape):
    img = np.random.default_rng(1).random(shape) * 255
    k = cv2.getGaussianKernel(11, 1.5)
    ref = cv2.filter2D(img, -1, np.outer(k, k.T))[5:-5, 5:-5]
    ours = metrics.filter_valid(img, metrics.gaussian_kernel())
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-9)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_psnr_variants_match_jax(seed):
    gt, pred = _pair(seed, noise=0.02 * (seed + 1))
    for name in ("psnr_torch", "psnr_y"):
        assert getattr(metrics, name)(gt, pred) == pytest.approx(
            getattr(jax_metrics, name)(gt, pred), rel=1e-12)
    a, b = np.clip(gt * 255, 0, 255), np.clip(pred * 255, 0, 255)
    for y in (False, True):
        assert metrics.psnr_np(a, b, test_y_channel=y) == pytest.approx(
            jax_metrics.psnr_np(a, b, test_y_channel=y), rel=1e-12)
    batch_gt, batch_pred = _pair(seed + 10, shape=(3, 16, 16, 3))
    np.testing.assert_allclose(metrics.batch_psnr(batch_gt, batch_pred),
                               jax_metrics.batch_psnr(batch_gt, batch_pred),
                               rtol=1e-12)


def test_psnr_np_of_identical_images_is_infinite():
    a = np.full((8, 8, 3), 100.0)
    assert metrics.psnr_np(a, a) == jax_metrics.psnr_np(a, a) == float("inf")


@pytest.mark.parametrize("y_only", [False, True])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_ycbcr_conversions_match_jax(dtype, y_only):
    rng = np.random.default_rng(3)
    img = (rng.integers(0, 256, (16, 24, 3)).astype(np.uint8)
           if dtype == np.uint8 else rng.random((16, 24, 3), np.float32))
    ours = metrics.bgr2ycbcr(img, y_only=y_only)
    ref = jax_metrics.bgr2ycbcr(img, y_only=y_only)
    assert ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(metrics.to_y_channel(img * 1.0),
                                  jax_metrics.to_y_channel(img * 1.0))
    np.testing.assert_array_equal(metrics.rgb_to_y_reference(img),
                                  jax_metrics.rgb_to_y_reference(img))


def test_luma_weights_rgb_as_bgr():
    """The reference's luma treats RGB data as BGR: blue weighs 65.481."""
    blue = np.zeros((1, 1, 3), np.float32)
    blue[..., 2] = 1.0
    assert metrics.rgb_to_y_reference(blue)[0, 0] == pytest.approx(
        (65.481 + 16.0) / 255.0)


@pytest.mark.parametrize("y", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_ssim_matches_jax(seed, y):
    gt, pred = _pair(seed, shape=(60, 90, 3), noise=0.1)
    a, b = np.clip(gt * 255, 0, 255), np.clip(pred * 255, 0, 255)
    ours = metrics.ssim(a, b, test_y_channel=y)
    ref = jax_metrics.ssim(a, b, test_y_channel=y)
    assert 0.0 < ours < 1.0
    assert abs(ours - ref) <= 1e-9


def test_ssim_of_identical_images_is_one():
    a = np.random.default_rng(4).random((32, 32, 3)) * 255
    assert metrics.ssim(a, a) == pytest.approx(1.0, abs=1e-12)
