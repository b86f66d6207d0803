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
gradient under autograd) and runs the plain composition of
``ops/wavelet_plain.py`` on a CPU tensor; scales 1 and 3 are always plain.
"""

from __future__ import annotations

import torch

from wavedm_tpu_torch.ops.wavelet_cuda import (kernel_layout,
                                               wavelet_dec_cuda,
                                               wavelet_rec_cuda)
from wavedm_tpu_torch.ops.wavelet_plain import (conv_weights,
                                                haar_packet_basis,
                                                haar_packet_filters,
                                                wavelet_dec_plain,
                                                wavelet_rec_plain)

__all__ = [
    "haar_packet_filters",
    "haar_packet_basis",
    "conv_weights",
    "wavelet_dec",
    "wavelet_rec",
    "wavelet_dec_plain",
    "wavelet_rec_plain",
]


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
        return _from_nchw(wavelet_dec_cuda(kernel_layout(xc)), layout)
    return _from_nchw(wavelet_dec_plain(xc, scale), layout)


def wavelet_rec(z: torch.Tensor, scale: int = 2,
                layout: str = "NCHW") -> torch.Tensor:
    """Inverse Haar wavelet-packet transform (exact inverse of
    :func:`wavelet_dec`)."""
    zc = _nchw(z, layout)
    if scale == 2:
        return _from_nchw(wavelet_rec_cuda(kernel_layout(zc, False)), layout)
    return _from_nchw(wavelet_rec_plain(zc, scale), layout)
