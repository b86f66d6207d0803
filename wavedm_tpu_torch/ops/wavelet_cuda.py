"""Wrappers of the scale-2 Haar DWT/IWT CUDA kernels (``csrc/wavelet.cu``).

A CPU tensor runs the plain version (:func:`wavelet_dec_plain` /
:func:`wavelet_rec_plain`, reshape + basis matmul, differentiable as JAX's
``wavelet_dec`` is); a tensor on any other device launches the kernel or
raises.

Layouts: each image's (C, H, W) block must be contiguous, at any batch
stride (on the pixel side a multiple of 4 floats from a 16-byte aligned
start).  So a channel slice ``x[:, a:b]`` of a contiguous NCHW batch is
read in place, and :func:`wavelet_dec_cat` writes the DWTs of several such
slices straight into the channel ranges of one output: the UNet's
``wavelet_in_unet`` hook takes no copy and no ``torch.cat``.  One shape and
one stride tuple decide the layout and the batch strides the kernels get.

Routes on the card: with grad enabled and an input that requires a
gradient, a call goes through one of two ``torch.autograd.Function``\\ s
whose forward launches one kernel and whose backward launches the other on
the incoming gradient (a gradient in a layout the kernels do not take is
made contiguous first): the basis is orthonormal, so the adjoint of the DWT
is the IWT and the adjoint of the IWT is the DWT.  Otherwise (under
``torch.no_grad()``, or on inputs that need no gradient, as in every
restore) the wrapper launches the same kernel directly, counted the same,
and its output has no ``grad_fn``.  JAX's Pallas wavelet has no
``custom_vjp``: its gradient is XLA's transpose of the plain einsum, the
same linear map.

``launches`` counts the kernel launches since the last reset:
``wavelet_dec`` / ``wavelet_rec`` in forward passes, ``wavelet_dec_backward``
the IWT kernel run as a DWT's backward, ``wavelet_rec_backward`` the DWT
kernel run as an IWT's backward.  Each launch also records its
:func:`declared_work` with a work counter (``utils/work.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from wavedm_tpu_torch.ops import _build
from wavedm_tpu_torch.ops.wavelet_plain import (wavelet_dec_plain,
                                                wavelet_rec_plain)
from wavedm_tpu_torch.utils import work

__all__ = ["wavelet_dec_cuda", "wavelet_rec_cuda", "wavelet_dec_cat",
           "wavelet_dec_plain", "wavelet_rec_plain", "kernel_layout",
           "WaveletDecCat", "WaveletRec", "declared_work", "launches"]

launches = {"wavelet_dec": 0, "wavelet_rec": 0, "wavelet_dec_backward": 0,
            "wavelet_rec_backward": 0}


def declared_work(pixels: int) -> tuple:
    """(flops, xla_flops, bytes) of one DWT or IWT launch over ``pixels``
    float32 pixels (batch x channels x H x W on the pixel side): the plain
    version's 16x16 basis matmul, 32 flops a pixel in both conventions,
    and the pixels and as many coefficients, each read or written once."""
    return 32 * pixels, 32 * pixels, 8 * pixels


def _batch_stride(t: torch.Tensor, pixels: bool) -> Optional[int]:
    """The batch stride, in floats, at which the kernels take ``t`` as it
    lies (an image's size for a batch of one or none), or None where they
    do not: 4-D float32, each image contiguous, images apart by at least
    their size (and, on the pixel side, at a multiple of 4 floats from a
    16-byte aligned start)."""
    shape = t.shape
    if t.dtype is not torch.float32 or len(shape) != 4:
        return None
    b, c, h, w = shape
    size = c * h * w
    sb, sc, sh, sw = t.stride()
    if b == 0 or size == 0:
        return sb if b > 1 else size
    # each image contiguous by PyTorch's rule: dims of size 1 skipped
    expect = 1
    if w != 1:
        if sw != 1:
            return None
        expect = w
    if h != 1:
        if sh != expect:
            return None
        expect *= h
    if c != 1 and sc != expect:
        return None
    if b == 1:
        return size if not pixels or t.data_ptr() % 16 == 0 else None
    if sb < size or pixels and (sb % 4 or t.data_ptr() % 16):
        return None
    return sb


def kernel_layout(t: torch.Tensor, pixels: bool = True) -> torch.Tensor:
    """``t`` itself when the kernels take its layout, else a contiguous
    copy."""
    return t if _batch_stride(t, pixels) is not None else t.contiguous()


def _checked_stride(t: torch.Tensor, what: str, pixels: bool) -> int:
    stride = _batch_stride(t, pixels)
    if stride is None:
        if t.dtype != torch.float32:
            raise ValueError(f"{what}: expected float32, got {t.dtype}")
        raise ValueError(f"{what}: expected NCHW whose images are each "
                         "contiguous at a batch stride of 4k floats, got "
                         f"shape {tuple(t.shape)} strides {t.stride()}")
    return stride


def _dec_cat(parts: Sequence[torch.Tensor], counter: str) -> torch.Tensor:
    """One DWT kernel launch a part, each into its channel range of one
    (B, 16 * sum(C), H/4, W/4) output."""
    lib = _build.library()
    first = parts[0]
    b, _, h, w = first.shape
    if h % 4 or w % 4:
        raise ValueError(f"wavelet_dec: spatial dims {(h, w)} not divisible "
                         "by 4")
    strides = [_checked_stride(p, "wavelet_dec", True) for p in parts]
    for p in parts[1:]:
        if p.shape[0] != b or p.shape[2:] != first.shape[2:] or \
                p.device != first.device:
            raise ValueError("wavelet_dec: parts differ in batch, size or "
                             "device")
    channels = sum(p.shape[1] for p in parts)
    z = first.new_empty((b, 16 * channels, h // 4, w // 4))
    plane = (h // 4) * (w // 4)
    index, out = first.get_device(), z.data_ptr()
    for p, stride in zip(parts, strides):
        c = p.shape[1]
        # a batch of one passes its part's size as the output's batch stride
        _build.launch(lib, "wavelet_dec_f32", index, p.data_ptr(), out, b, c,
                      h, w, stride, 16 * (channels if b > 1 else c) * plane)
        launches[counter] += 1
        if work.active():
            work.record("kernel:" + counter, *declared_work(b * c * h * w))
        out += 4 * 16 * c * plane
    return z


def _rec(z: torch.Tensor, counter: str) -> torch.Tensor:
    """One IWT kernel launch: (B, 16C, h, w) -> a new (B, C, 4h, 4w)."""
    lib = _build.library()
    stride = _checked_stride(z, "wavelet_rec", False)
    b, fc, h, w = z.shape
    if fc % 16:
        raise ValueError(f"wavelet_rec: channel dim {fc} not divisible by 16")
    x = z.new_empty((b, fc // 16, 4 * h, 4 * w))
    _build.launch(lib, "wavelet_rec_f32", z.get_device(), z.data_ptr(),
                  x.data_ptr(), b, fc // 16, 4 * h, 4 * w, stride, fc * h * w)
    launches[counter] += 1
    if work.active():
        work.record("kernel:" + counter, *declared_work(x.numel()))
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
    if parts[0].is_cpu:
        zs = [wavelet_dec_plain(p, 2) for p in parts]
        return zs[0] if len(zs) == 1 else torch.cat(zs, dim=1)
    if torch.is_grad_enabled() and any(p.requires_grad for p in parts):
        return WaveletDecCat.apply(*parts)
    return _dec_cat(parts, "wavelet_dec")


def wavelet_dec_cuda(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) float32 -> (B, 16C, H/4, W/4), channel f*C + c."""
    return wavelet_dec_cat([x])


def wavelet_rec_cuda(z: torch.Tensor) -> torch.Tensor:
    """(B, 16C, h, w) float32 -> (B, C, 4h, 4w): the exact inverse."""
    if z.is_cpu:
        return wavelet_rec_plain(z, 2)
    if torch.is_grad_enabled() and z.requires_grad:
        return WaveletRec.apply(z)
    return _rec(z, "wavelet_rec")
