"""The Haar wavelet-packet filter bank and the plain (PyTorch) DWT/IWT.

The plain versions are the CPU path of :mod:`wavedm_tpu_torch.ops.wavelet`
and the yardstick the CUDA kernels (``ops/wavelet_cuda.py``) are held to;
see that module for the transform itself.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["haar_packet_filters", "haar_packet_basis", "conv_weights",
           "wavelet_dec_plain", "wavelet_rec_plain"]

# 2x2 Haar quad in the reference's filter order:
# [LL, row-avg/col-diff, row-diff/col-avg, diag]
_G = np.array(
    [
        [[1.0, 1.0], [1.0, 1.0]],
        [[1.0, -1.0], [1.0, -1.0]],
        [[1.0, 1.0], [-1.0, -1.0]],
        [[1.0, -1.0], [-1.0, 1.0]],
    ],
    dtype=np.float64,
) / 2.0


@functools.lru_cache(maxsize=8)
def haar_packet_filters(scale: int) -> np.ndarray:
    """(4**scale, ks, ks) filter bank, entries +-2**-scale."""
    if scale < 1:
        raise ValueError("scale must be >= 1")
    bank = _G
    for _ in range(scale - 1):
        prev = bank
        bank = np.stack([np.kron(_G[f % 4], prev[f // 4])
                         for f in range(4 * prev.shape[0])])
    bank.setflags(write=False)
    return bank


@functools.lru_cache(maxsize=8)
def haar_packet_basis(scale: int) -> np.ndarray:
    """(ks*ks, ks*ks) orthonormal M with M[p*ks+q, f] = filter_f[p, q]:
    ``coeffs = pixels_flat @ M`` is the DWT of one block and
    ``pixels_flat = coeffs @ M.T`` inverts it."""
    filters = haar_packet_filters(scale)
    nf, ks, _ = filters.shape
    basis = np.ascontiguousarray(filters.reshape(nf, ks * ks).T)
    basis.setflags(write=False)
    return basis


def conv_weights(scale: int, channels: int = 3) -> np.ndarray:
    """Grouped-conv weight bank (channels * 4**scale, 1, ks, ks), out channel
    c*nf + f: the reference's ``Conv2d(C, C*ks*ks, ks, stride=ks, groups=C)``
    form.  Used only as a yardstick, never by the port's path."""
    filters = haar_packet_filters(scale)
    nf, ks, _ = filters.shape
    w = np.tile(filters[None], (channels, 1, 1, 1))
    return w.reshape(channels * nf, 1, ks, ks).astype(np.float32)


def _basis(scale: int, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.array(haar_packet_basis(scale)),
                           dtype=like.dtype, device=like.device)


def wavelet_dec_plain(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """NCHW (B, C, H, W) -> (B, C*ks², H/ks, W/ks), channel f*C + c."""
    ks = 2 ** scale
    b, c, h, w = x.shape
    if h % ks or w % ks:
        raise ValueError(f"spatial dims {(h, w)} not divisible by block {ks}")
    xb = x.reshape(b, c, h // ks, ks, w // ks, ks)
    # (b, c, i, j, p, q) -> blocks flattened on the last axis
    xb = xb.permute(0, 1, 2, 4, 3, 5).reshape(b, c, h // ks, w // ks, ks * ks)
    coeffs = torch.matmul(xb, _basis(scale, x))          # (b, c, i, j, f)
    return coeffs.permute(0, 4, 1, 2, 3).reshape(b, ks * ks * c,
                                                 h // ks, w // ks)


def wavelet_rec_plain(z: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Inverse of :func:`wavelet_dec_plain`: (B, C*ks², h, w) -> (B, C, h*ks, w*ks)."""
    ks = 2 ** scale
    nf = ks * ks
    b, fc, h, w = z.shape
    if fc % nf:
        raise ValueError(f"channel dim {fc} not divisible by {nf} subbands")
    c = fc // nf
    zb = z.reshape(b, nf, c, h, w).permute(0, 2, 3, 4, 1)  # (b, c, i, j, f)
    xb = torch.matmul(zb, _basis(scale, z).T)              # (b, c, i, j, pq)
    xb = xb.reshape(b, c, h, w, ks, ks).permute(0, 1, 2, 4, 3, 5)
    return xb.reshape(b, c, h * ks, w * ks)
