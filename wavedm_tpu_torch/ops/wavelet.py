"""Fixed Haar wavelet-packet transforms (DWT/IWT).

A ``scale``-level Haar packet transform over a ``ks = 2**scale`` pixel block
is an orthonormal linear map from the ks*ks pixels of the block to ks*ks
subband coefficients, so it is a reshape plus a (ks², ks²) basis matmul.
Output channel k = f*C + c for filter f and image channel c (the reference's
interleave), so at scale 2 on RGB the first 3 channels are the LL band.

The filter bank is the kron recursion

    B_1[f] = G[f]                       (f in 0..3, the 2x2 Haar quad, +-1/2)
    B_s[f] = kron(G[f mod 4], B_{s-1}[f // 4])

whose entries are +-2**-s, exact in float32.

At scale 2 the transform goes through the wrapper of ``ops/wavelet_cuda.py``,
which launches the hand-written CUDA kernel on a CUDA tensor (with its own
gradient under autograd) and runs the plain composition below on a CPU
tensor; scales 1 and 3 are always plain.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "haar_packet_filters",
    "haar_packet_basis",
    "conv_weights",
    "wavelet_dec",
    "wavelet_rec",
    "wavelet_dec_plain",
    "wavelet_rec_plain",
]

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


def _nchw(x: torch.Tensor, layout: str) -> torch.Tensor:
    if layout == "NCHW":
        return x
    if layout == "NHWC":
        return x.permute(0, 3, 1, 2)
    raise ValueError(f"unknown layout {layout!r}")


def _from_nchw(x: torch.Tensor, layout: str) -> torch.Tensor:
    return x if layout == "NCHW" else x.permute(0, 2, 3, 1)


def wavelet_dec(x: torch.Tensor, scale: int = 2,
                layout: str = "NCHW") -> torch.Tensor:
    """Haar wavelet-packet decomposition, channel k = f*C + c.

    NCHW: (B, C, H, W) -> (B, C*ks², H/ks, W/ks); NHWC likewise with the
    channel axis last."""
    xc = _nchw(x, layout)
    if scale == 2:
        from wavedm_tpu_torch.ops.wavelet_cuda import (kernel_layout,
                                                       wavelet_dec_cuda)
        return _from_nchw(wavelet_dec_cuda(kernel_layout(xc)), layout)
    return _from_nchw(wavelet_dec_plain(xc, scale), layout)


def wavelet_rec(z: torch.Tensor, scale: int = 2,
                layout: str = "NCHW") -> torch.Tensor:
    """Inverse Haar wavelet-packet transform (exact inverse of
    :func:`wavelet_dec`)."""
    zc = _nchw(z, layout)
    if scale == 2:
        from wavedm_tpu_torch.ops.wavelet_cuda import (kernel_layout,
                                                       wavelet_rec_cuda)
        return _from_nchw(wavelet_rec_cuda(kernel_layout(zc, False)), layout)
    return _from_nchw(wavelet_rec_plain(zc, scale), layout)
