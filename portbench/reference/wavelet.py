"""The 2-level Haar wavelet packet transform, plainly.

A 4x4 pixel block maps to 16 coefficients by an orthonormal basis whose
filters are the Kronecker products of the 2x2 Haar quad (entries +-1/4).
Output channel k = f * C + c for filter f and image channel c, so on RGB
the first three channels are the LL band (WaveDM's ``models/wavelet.py``
filter order: LL, row-average/column-difference, row-difference/
column-average, diagonal, recursed).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["haar_basis", "dwt", "iwt"]

_QUAD = np.array([[[1, 1], [1, 1]], [[1, -1], [1, -1]],
                  [[1, 1], [-1, -1]], [[1, -1], [-1, 1]]], np.float64) / 2.0


def haar_basis() -> np.ndarray:
    """(16, 16) M with M[p * 4 + q, f] = filter f at pixel (p, q)."""
    bank = np.stack([np.kron(_QUAD[f % 4], _QUAD[f // 4])
                     for f in range(16)])
    return bank.reshape(16, 16).T.copy()


def _basis(like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(haar_basis(), dtype=like.dtype, device=like.device)


def dwt(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 16 C, H/4, W/4)."""
    b, c, h, w = x.shape
    blocks = x.reshape(b, c, h // 4, 4, w // 4, 4).permute(0, 1, 2, 4, 3, 5)
    coef = blocks.reshape(b, c, h // 4, w // 4, 16) @ _basis(x)
    return coef.permute(0, 4, 1, 2, 3).reshape(b, 16 * c, h // 4, w // 4)


def iwt(z: torch.Tensor) -> torch.Tensor:
    """(B, 16 C, h, w) -> (B, C, 4 h, 4 w), the inverse of :func:`dwt`."""
    b, fc, h, w = z.shape
    c = fc // 16
    coef = z.reshape(b, 16, c, h, w).permute(0, 2, 3, 4, 1)
    pix = (coef @ _basis(z).T).reshape(b, c, h, w, 4, 4)
    return pix.permute(0, 1, 2, 4, 3, 5).reshape(b, c, 4 * h, 4 * w)
