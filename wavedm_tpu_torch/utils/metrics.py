"""Image quality metrics on the host, numpy only: PSNR (the reference's
variants), SSIM (MATLAB-equivalent) and the BT.601 Y channel.

The port's own copy of ``wavedm_tpu/utils/metrics.py``, with the same
numbers:

- ``psnr_torch``: clamp to [0,1], RMSE over the whole array,
  20*log10(1/rmse) (reference torchPSNR).
- ``psnr_np``: [0,255] float64 images, optional Y channel,
  20*log10(255/rmse) (reference calculate_psnr).
- ``psnr_y``: [0,1] images, Y channel by the BT.601 dot product, mean MSE
  (reference calculate_psnr_in_GPU).
- ``ssim``: 11x11 Gaussian window, sigma 1.5, the 5-pixel border cropped,
  mean over channels (reference calculate_ssim).

The reference feeds RGB images to its ``bgr2ycbcr`` helpers, so the luma it
reports is 24.966*R + 128.553*G + 65.481*B; that is kept exactly, since it
changes the reported PSNR.  The SSIM window is applied as two valid 1-D
passes of the 11-tap Gaussian in float64 (the window is the outer product
of that kernel), which equals the reference's ``cv2.filter2D`` interior to
rounding, without cv2 and without an (H, W, 11, 11) view.
"""

from __future__ import annotations

import numpy as np

__all__ = ["psnr_torch", "batch_psnr", "rgb_to_y_reference", "psnr_y",
           "bgr2ycbcr", "to_y_channel", "psnr_np", "gaussian_kernel",
           "filter_valid", "ssim"]

Array = np.ndarray

# BT.601 (as applied by the reference to RGB-ordered data)
_Y_COEF_RGB_AS_BGR = np.array([24.966, 128.553, 65.481], dtype=np.float64)
_YCBCR_MAT = np.array(
    [[24.966, 112.0, -18.214],
     [128.553, -74.203, -93.786],
     [65.481, -37.797, 112.0]], dtype=np.float64)
_YCBCR_OFF = np.array([16.0, 128.0, 128.0], dtype=np.float64)


def psnr_torch(target: Array, pred: Array) -> float:
    """PSNR over the whole array on [0,1] data (reference torchPSNR)."""
    diff = (np.clip(pred, 0, 1).astype(np.float64)
            - np.clip(target, 0, 1).astype(np.float64))
    rmse = np.sqrt((diff ** 2).mean())
    return float(20.0 * np.log10(1.0 / rmse))


def batch_psnr(target: Array, pred: Array) -> Array:
    """Per-image PSNR on [0,1] NHWC batches (reference BatchPSNR)."""
    diff = (np.clip(pred, 0, 1).astype(np.float64)
            - np.clip(target, 0, 1).astype(np.float64))
    rmse = np.sqrt((diff ** 2).mean(axis=(1, 2, 3)))
    return 20.0 * np.log10(1.0 / rmse)


def rgb_to_y_reference(img: Array) -> Array:
    """[0,1] RGB -> [0,1]-ranged Y, as the reference's bgr-named helper
    computes it on RGB data."""
    y = img.astype(np.float64) @ _Y_COEF_RGB_AS_BGR + 16.0
    return y / 255.0


def psnr_y(target: Array, pred: Array) -> float:
    """[0,1] HWC (or NHWC) images -> Y-channel PSNR (reference
    calculate_psnr_in_GPU with test_y_channel=True)."""
    ty = rgb_to_y_reference(target)
    py = rgb_to_y_reference(pred)
    mse = ((ty - py) ** 2).mean()
    return float(20.0 * np.log10(1.0 / np.sqrt(mse)))


def bgr2ycbcr(img: Array, y_only: bool = False) -> Array:
    """BT.601 'BGR' -> YCbCr on [0,1] float or uint8 input, with the
    reference's type and range conventions."""
    img_type = img.dtype
    x = img.astype(np.float64)
    if img_type == np.uint8:
        x = x / 255.0
    if y_only:
        out = x @ _Y_COEF_RGB_AS_BGR + 16.0
    else:
        out = x @ _YCBCR_MAT + _YCBCR_OFF
    if img_type == np.uint8:
        out = out.round().astype(np.uint8)
    else:
        out = (out / 255.0).astype(np.float32)
    return out


def to_y_channel(img: Array) -> Array:
    """[0,255] image -> [0,255] float Y channel (reference to_y_channel)."""
    x = img.astype(np.float32) / 255.0
    if x.ndim == 3 and x.shape[2] == 3:
        x = bgr2ycbcr(x, y_only=True)
        x = x[..., None]
    return x * 255.0


def psnr_np(img1: Array, img2: Array, test_y_channel: bool = False) -> float:
    """[0,255] HWC images -> PSNR (reference calculate_psnr)."""
    assert img1.shape == img2.shape
    a = img1.astype(np.float64)
    b = img2.astype(np.float64)
    if test_y_channel:
        a = to_y_channel(a)
        b = to_y_channel(b)
    mse = ((a - b) ** 2).mean()
    if mse == 0:
        return float("inf")
    return float(20.0 * np.log10(255.0 / np.sqrt(mse)))


def gaussian_kernel(size: int = 11, sigma: float = 1.5) -> Array:
    """The normalized 1-D Gaussian, float64 (cv2.getGaussianKernel's)."""
    xs = np.arange(size) - (size - 1) / 2
    k = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    return k / k.sum()


def filter_valid(img: Array, k: Array) -> Array:
    """Valid correlation of a 2-D float64 image with outer(k, k): rows, then
    columns; (H, W) -> (H - n + 1, W - n + 1) for an n-tap k."""
    n = len(k)
    h, w = img.shape
    rows = sum(k[i] * img[:, i:w - n + 1 + i] for i in range(n))
    return sum(k[i] * rows[i:h - n + 1 + i] for i in range(n))


def _ssim_single(img1: Array, img2: Array) -> float:
    """One-channel SSIM on [0,255] data (reference _ssim)."""
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    k = gaussian_kernel()
    mu1 = filter_valid(img1, k)
    mu2 = filter_valid(img2, k)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = filter_valid(img1 ** 2, k) - mu1_sq
    sigma2_sq = filter_valid(img2 ** 2, k) - mu2_sq
    sigma12 = filter_valid(img1 * img2, k) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return float(ssim_map.mean())


def ssim(img1: Array, img2: Array, test_y_channel: bool = False) -> float:
    """[0,255] HWC images -> mean per-channel SSIM (reference
    calculate_ssim)."""
    assert img1.shape == img2.shape
    a = img1.astype(np.float64)
    b = img2.astype(np.float64)
    if test_y_channel:
        a = to_y_channel(a)
        b = to_y_channel(b)
    return float(np.mean([_ssim_single(a[..., i], b[..., i])
                          for i in range(a.shape[2])]))
