"""Wrappers of the scale-2 Haar DWT/IWT CUDA kernels (``csrc/wavelet.cu``).

A CPU tensor runs the plain version (:func:`wavelet_dec_plain` /
:func:`wavelet_rec_plain`, reshape + basis matmul); a CUDA tensor launches
the kernel or raises.  Each wrapper counts its launches in ``launches``.
"""

from __future__ import annotations

import torch

from wavedm_tpu_torch.ops import _build
from wavedm_tpu_torch.ops.wavelet import wavelet_dec_plain, wavelet_rec_plain

__all__ = ["wavelet_dec_cuda", "wavelet_rec_cuda", "wavelet_dec_plain",
           "wavelet_rec_plain", "launches"]

# kernel launches since the last reset, by kernel name
launches = {"wavelet_dec": 0, "wavelet_rec": 0}


def _check(t: torch.Tensor, what: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{what}: expected float32, got {t.dtype}")
    if t.dim() != 4 or not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous NCHW tensor")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def wavelet_dec_cuda(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) float32 -> (B, 16C, H/4, W/4), channel f*C + c."""
    if x.device.type == "cpu":
        return wavelet_dec_plain(x, 2)
    lib = _build.library()
    _check(x, "wavelet_dec")
    b, c, h, w = x.shape
    if h % 4 or w % 4:
        raise ValueError(f"wavelet_dec: spatial dims {(h, w)} not divisible by 4")
    z = torch.empty((b, 16 * c, h // 4, w // 4), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.wavelet_dec_f32(x.data_ptr(), z.data_ptr(), b, c, h, w,
                                  _stream(x))
    _build.check(lib, err, "wavelet_dec")
    launches["wavelet_dec"] += 1
    return z


def wavelet_rec_cuda(z: torch.Tensor) -> torch.Tensor:
    """(B, 16C, h, w) float32 -> (B, C, 4h, 4w): the exact inverse."""
    if z.device.type == "cpu":
        return wavelet_rec_plain(z, 2)
    lib = _build.library()
    _check(z, "wavelet_rec")
    b, fc, h, w = z.shape
    if fc % 16:
        raise ValueError(f"wavelet_rec: channel dim {fc} not divisible by 16")
    x = torch.empty((b, fc // 16, 4 * h, 4 * w), dtype=z.dtype, device=z.device)
    with torch.cuda.device(z.device):
        err = lib.wavelet_rec_f32(z.data_ptr(), x.data_ptr(), b, fc // 16,
                                  4 * h, 4 * w, _stream(z))
    _build.check(lib, err, "wavelet_rec")
    launches["wavelet_rec"] += 1
    return x
