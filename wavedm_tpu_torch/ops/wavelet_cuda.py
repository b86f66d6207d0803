"""Wrappers of the scale-2 Haar DWT/IWT CUDA kernels (``csrc/wavelet.cu``).

A CPU tensor runs the plain version (:func:`wavelet_dec_plain` /
:func:`wavelet_rec_plain`, reshape + basis matmul, differentiable as JAX's
``wavelet_dec`` is); a tensor on any other device launches the kernel or
raises.

Layouts: each image's (C, H, W) block must be contiguous, at any batch
stride (a multiple of 4 floats, the pixel side 16-byte aligned).  So a
channel slice ``x[:, a:b]`` of a contiguous NCHW batch is read in place,
and :func:`wavelet_dec_cat` writes the DWTs of several such slices straight
into the channel ranges of one output: the UNet's ``wavelet_in_unet`` hook
takes no copy and no ``torch.cat``.

Gradients: the basis is orthonormal, so the adjoint of the DWT is the IWT
and the adjoint of the IWT is the DWT.  On the card every call goes
through one of two ``torch.autograd.Function``\\ s whose forward launches one
kernel and whose backward launches the other on the incoming gradient (a
gradient in a layout the kernels do not take is made contiguous first).
JAX's Pallas wavelet has no ``custom_vjp``: its gradient is XLA's transpose
of the plain einsum, the same linear map.

``launches`` counts the kernel launches since the last reset:
``wavelet_dec`` / ``wavelet_rec`` in forward passes, ``wavelet_dec_backward``
the IWT kernel run as a DWT's backward, ``wavelet_rec_backward`` the DWT
kernel run as an IWT's backward.
"""

from __future__ import annotations

from typing import Sequence

import torch

from wavedm_tpu_torch.ops import _build
from wavedm_tpu_torch.ops.wavelet import wavelet_dec_plain, wavelet_rec_plain

__all__ = ["wavelet_dec_cuda", "wavelet_rec_cuda", "wavelet_dec_cat",
           "wavelet_dec_plain", "wavelet_rec_plain", "kernel_layout",
           "WaveletDecCat", "WaveletRec", "launches"]

launches = {"wavelet_dec": 0, "wavelet_rec": 0, "wavelet_dec_backward": 0,
            "wavelet_rec_backward": 0}


def _fits(t: torch.Tensor, pixels: bool) -> bool:
    """Whether the kernels take ``t`` as it lies: 4-D float32, each image
    contiguous, images apart by at least their size (and, on the pixel
    side, at a multiple of 4 floats from a 16-byte aligned start)."""
    if t.dim() != 4 or t.dtype != torch.float32:
        return False
    if t.shape[0] == 0 or t[0].numel() == 0:
        return True
    if not t[0].is_contiguous():
        return False
    if t.shape[0] > 1 and t.stride(0) < t[0].numel():
        return False
    return not pixels or (t.data_ptr() % 16 == 0
                          and (t.shape[0] == 1 or t.stride(0) % 4 == 0))


def kernel_layout(t: torch.Tensor, pixels: bool = True) -> torch.Tensor:
    """``t`` itself when the kernels take its layout, else a contiguous
    copy."""
    return t if _fits(t, pixels) else t.contiguous()


def _check(t: torch.Tensor, what: str, pixels: bool) -> None:
    if t.dtype != torch.float32:
        raise ValueError(f"{what}: expected float32, got {t.dtype}")
    if not _fits(t, pixels):
        raise ValueError(f"{what}: expected NCHW whose images are each "
                         "contiguous at a batch stride of 4k floats, got "
                         f"shape {tuple(t.shape)} strides {t.stride()}")


def _bstride(t: torch.Tensor) -> int:
    return t.stride(0) if t.shape[0] > 1 else t[0].numel()


def _dec_cat(parts: Sequence[torch.Tensor], counter: str) -> torch.Tensor:
    """One DWT kernel launch a part, each into its channel range of one
    (B, 16 * sum(C), H/4, W/4) output."""
    lib = _build.library()
    b, _, h, w = parts[0].shape
    if h % 4 or w % 4:
        raise ValueError(f"wavelet_dec: spatial dims {(h, w)} not divisible "
                         "by 4")
    for p in parts:
        _check(p, "wavelet_dec", pixels=True)
        if p.shape[0] != b or p.shape[2:] != parts[0].shape[2:] or \
                p.device != parts[0].device:
            raise ValueError("wavelet_dec: parts differ in batch, size or "
                             "device")
    z = torch.empty((b, 16 * sum(p.shape[1] for p in parts), h // 4,
                     w // 4), dtype=torch.float32, device=parts[0].device)
    off = 0
    for p in parts:
        c = p.shape[1]
        out = z[:, off:off + 16 * c]
        _build.launch(lib, "wavelet_dec_f32", p.device, p.data_ptr(),
                      out.data_ptr(), b, c, h, w, _bstride(p), _bstride(out))
        launches[counter] += 1
        off += 16 * c
    return z


def _rec(z: torch.Tensor, counter: str) -> torch.Tensor:
    """One IWT kernel launch: (B, 16C, h, w) -> a new (B, C, 4h, 4w)."""
    lib = _build.library()
    _check(z, "wavelet_rec", pixels=False)
    b, fc, h, w = z.shape
    if fc % 16:
        raise ValueError(f"wavelet_rec: channel dim {fc} not divisible by 16")
    x = torch.empty((b, fc // 16, 4 * h, 4 * w), dtype=torch.float32,
                    device=z.device)
    _build.launch(lib, "wavelet_rec_f32", z.device, z.data_ptr(),
                  x.data_ptr(), b, fc // 16, 4 * h, 4 * w, _bstride(z),
                  _bstride(x))
    launches[counter] += 1
    return x


class WaveletDecCat(torch.autograd.Function):
    """DWTs of the parts, concatenated along channels; the backward runs
    the IWT kernel on each part's channel range of the gradient."""

    @staticmethod
    def forward(ctx, *parts):
        ctx.widths = [p.shape[1] for p in parts]
        return _dec_cat(parts, "wavelet_dec")

    @staticmethod
    def backward(ctx, gz):
        grads, off = [], 0
        for c, need in zip(ctx.widths, ctx.needs_input_grad):
            grads.append(_rec(kernel_layout(gz[:, off:off + 16 * c], False),
                              "wavelet_dec_backward") if need else None)
            off += 16 * c
        return tuple(grads)


class WaveletRec(torch.autograd.Function):
    """The IWT; the backward runs the DWT kernel on the gradient."""

    @staticmethod
    def forward(ctx, z):
        return _rec(z, "wavelet_rec")

    @staticmethod
    def backward(ctx, gx):
        return _dec_cat([kernel_layout(gx)], "wavelet_rec_backward")


def wavelet_dec_cat(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """(B, C_i, H, W) float32 parts -> (B, 16 * sum(C_i), H/4, W/4): each
    part's DWT (channel f*C_i + c) in its own channel range, in order."""
    if parts[0].device.type == "cpu":
        zs = [wavelet_dec_plain(p, 2) for p in parts]
        return zs[0] if len(zs) == 1 else torch.cat(zs, dim=1)
    return WaveletDecCat.apply(*parts)


def wavelet_dec_cuda(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) float32 -> (B, 16C, H/4, W/4), channel f*C + c."""
    return wavelet_dec_cat([x])


def wavelet_rec_cuda(z: torch.Tensor) -> torch.Tensor:
    """(B, 16C, h, w) float32 -> (B, C, 4h, 4w): the exact inverse."""
    if z.device.type == "cpu":
        return wavelet_rec_plain(z, 2)
    return WaveletRec.apply(z)
