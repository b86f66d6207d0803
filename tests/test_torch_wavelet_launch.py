"""PyTorch port: how the wavelet wrappers launch the DWT/IWT kernels.

On the card a call launches its kernel directly under ``torch.no_grad()``
or on inputs that need no gradient, and goes through the autograd
Functions (``WaveletDecCat`` / ``WaveletRec``) only when grad is enabled
and an input requires it.  The kernels cannot run here, so the library's C
entries are replaced by a numpy emulation that reads and writes the raw
addresses and batch strides the wrapper hands ``_build.launch``, and the
inputs are host tensors of a subclass that does not report itself as on
the CPU, so the wrappers take the card's route.  The gradient route is
held to ``jax.vjp`` of JAX's ``wavelet_dec`` / ``wavelet_rec`` within 1e-6
(each output sums 16 terms of +-1/4 times inputs within [-3, 3]); the
direct route to the plain version within the same 1e-6 (the emulation
computes it an image at a time).

The layout rule (which tensors the kernels take as they lie, at which
batch stride) is decided from one shape and one stride tuple; it is held
here to the per-image-view rule it replaced, written out below.
"""

import contextlib
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavedm_tpu.ops.wavelet import wavelet_dec as jax_dec
from wavedm_tpu.ops.wavelet import wavelet_rec as jax_rec

from wavedm_tpu_torch.ops import _build, wavelet_cuda
from wavedm_tpu_torch.ops.wavelet import wavelet_dec_plain, wavelet_rec_plain


class OnCard(torch.Tensor):
    """A host tensor the wrappers route as a card's."""

    @property
    def is_cpu(self):
        return False


def on_card(t):
    return t.as_subclass(OnCard)


def _floats(ptr, n):
    """The n float32s at host address ``ptr``, as a writable numpy view."""
    return np.ctypeslib.as_array((ctypes.c_float * n).from_address(ptr))


@pytest.fixture
def emulated(monkeypatch):
    """The library's wavelet entries emulated in numpy at the addresses
    and batch strides the wrapper hands them; returns the calls made."""
    calls = []

    def launch(lib, entry, index, src, dst, b, c, h, w, s_bs, d_bs):
        calls.append((entry, src, dst, b, c, h, w, s_bs, d_bs))
        n = c * h * w
        for i in range(b):
            a = _floats(src + 4 * i * s_bs, n)
            out = _floats(dst + 4 * i * d_bs, n)
            if entry == "wavelet_dec_f32":
                res = wavelet_dec_plain(torch.from_numpy(a.reshape(
                    1, c, h, w)))
            else:
                res = wavelet_rec_plain(torch.from_numpy(a.reshape(
                    1, 16 * c, h // 4, w // 4)))
            out[:] = res.numpy().reshape(-1)

    monkeypatch.setattr(_build, "library", lambda: object())
    monkeypatch.setattr(_build, "launch", launch)
    for key in wavelet_cuda.launches:
        monkeypatch.setitem(wavelet_cuda.launches, key, 0)
    return calls


# ------------------------------------------------- the rule it replaced


def old_fits(t, pixels):
    """Whether the kernels took ``t`` as it lay, by per-image views."""
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


def old_bstride(t):
    return t.stride(0) if t.shape[0] > 1 else t[0].numel()


def _aligned(n, offset=0):
    """n zero floats starting ``offset`` floats past a 16-byte boundary."""
    buf = torch.zeros(n + offset + 4)
    start = (-buf.data_ptr() // 4) % 4
    return buf[start + offset:start + offset + n]


LAYOUTS = {
    "contiguous": lambda: torch.zeros(2, 3, 8, 8),
    "batch_1": lambda: torch.zeros(1, 3, 8, 8),
    "channel_slice": lambda: torch.zeros(2, 6, 8, 8)[:, 3:],
    "channel_slice_batch_1": lambda: torch.zeros(1, 6, 8, 8)[:, 1:4],
    "odd_channel_slice": lambda: torch.zeros(2, 5, 8, 4)[:, 1:],
    "batch_step": lambda: torch.zeros(4, 3, 8, 8)[::2],
    "channels_last": lambda: torch.zeros(2, 8, 8, 3).permute(0, 3, 1, 2),
    "transposed": lambda: torch.zeros(2, 3, 8, 8).transpose(2, 3),
    "expanded": lambda: torch.zeros(1, 3, 8, 8).expand(3, 3, 8, 8),
    "overlapping": lambda: _aligned(200).as_strided((2, 3, 4, 4),
                                                    (40, 16, 4, 1)),
    "unit_dims_any_stride": lambda: _aligned(512).as_strided(
        (2, 1, 1, 8), (16, 999, 77, 1)),
    "batch_stride_odd": lambda: _aligned(200).as_strided((2, 3, 4, 4),
                                                         (49, 16, 4, 1)),
    "start_off_16_bytes": lambda: _aligned(2 * 48, 1).view(2, 3, 4, 4),
    "start_off_16_bytes_batch_1": lambda: _aligned(48, 2).view(1, 3, 4, 4),
    "zero_batch": lambda: torch.zeros(0, 3, 8, 8),
    "zero_channels": lambda: torch.zeros(2, 0, 8, 8),
    "float64": lambda: torch.zeros(2, 3, 8, 8, dtype=torch.float64),
    "three_dims": lambda: torch.zeros(3, 8, 8),
}


@pytest.mark.parametrize("pixels", [True, False], ids=["pixels", "coeffs"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_batch_stride_from_shape_and_strides_is_the_old_rule(layout,
                                                             pixels):
    """Taken where the per-image-view rule took a layout, at its batch
    stride; refused where it refused.  A batch of none (which the old
    stride, indexing image 0, could not give) gets an image's size."""
    t = LAYOUTS[layout]()
    got = wavelet_cuda._batch_stride(t, pixels)
    assert (got is not None) == old_fits(t, pixels)
    if got is not None:
        if t.shape[0]:
            assert got == old_bstride(t)
        else:
            assert got == t.shape[1] * t.shape[2] * t.shape[3]
    kept = wavelet_cuda.kernel_layout(t, pixels)
    assert kept is t if got is not None else kept.is_contiguous()


# ------------------------------------------------------ the direct launch


ROUTES = {
    # grad enabled, an input that needs none
    "no_gradient_needed": (contextlib.nullcontext, False),
    # an input that would need one, under no_grad
    "no_grad": (torch.no_grad, True),
}
DEC_CASES = {
    "contiguous": (lambda x: x, (2, 3, 16, 24)),
    "channel_slice": (lambda x: x[:, 3:], (2, 6, 16, 24)),
    "batch_1": (lambda x: x, (1, 3, 16, 24)),
    "zero_batch": (lambda x: x, (0, 3, 16, 24)),
}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("case", list(DEC_CASES))
def test_dwt_launches_directly_without_autograd(emulated, case, route):
    """One launch, counted as a forward DWT, an output with no grad_fn,
    and the pointers and batch strides the Function route passes: the
    input where it lies at its batch stride, the output at its own."""
    take, shape = DEC_CASES[case]
    context, needs_grad = ROUTES[route]
    full = torch.from_numpy(np.random.default_rng(7).uniform(
        -1, 1, shape).astype(np.float32))
    x = take(on_card(full.clone()).requires_grad_(needs_grad))
    with context():
        z = wavelet_cuda.wavelet_dec_cuda(x)
    assert z.grad_fn is None and not z.requires_grad
    assert tuple(z.shape) == (shape[0], 48, 4, 6)
    b, c, h, w = x.shape
    # batch strides as the autograd route hands them (a batch of none: an
    # image's size, where the old per-image view raised)
    want_src = old_bstride(x) if b else c * h * w
    want_dst = old_bstride(z[:, :48]) if b else 16 * c * (h // 4) * (w // 4)
    assert emulated == [("wavelet_dec_f32", x.data_ptr(), z.data_ptr(), b,
                         c, h, w, want_src, want_dst)]
    assert wavelet_cuda.launches == {
        "wavelet_dec": 1, "wavelet_rec": 0, "wavelet_dec_backward": 0,
        "wavelet_rec_backward": 0}
    torch.testing.assert_close(torch.Tensor(z), wavelet_dec_plain(
        take(full).contiguous()), atol=1e-6, rtol=0)


REC_CASES = {
    "contiguous": (lambda z: z, (2, 48, 4, 6)),
    "channel_slice": (lambda z: z[:, 48:], (2, 96, 4, 6)),
    "batch_1": (lambda z: z, (1, 48, 4, 6)),
    "zero_batch": (lambda z: z, (0, 48, 4, 6)),
}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("case", list(REC_CASES))
def test_iwt_launches_directly_without_autograd(emulated, case, route):
    take, shape = REC_CASES[case]
    context, needs_grad = ROUTES[route]
    full = torch.from_numpy(np.random.default_rng(8).uniform(
        -1, 1, shape).astype(np.float32))
    z = take(on_card(full.clone()).requires_grad_(needs_grad))
    with context():
        x = wavelet_cuda.wavelet_rec_cuda(z)
    assert x.grad_fn is None and not x.requires_grad
    assert tuple(x.shape) == (shape[0], 3, 16, 24)
    b = shape[0]
    want_src = old_bstride(z) if b else 48 * 4 * 6
    want_dst = old_bstride(x) if b else 3 * 16 * 24
    assert emulated == [("wavelet_rec_f32", z.data_ptr(), x.data_ptr(), b,
                         3, 16, 24, want_src, want_dst)]
    assert wavelet_cuda.launches == {
        "wavelet_dec": 0, "wavelet_rec": 1, "wavelet_dec_backward": 0,
        "wavelet_rec_backward": 0}
    # the emulation runs the plain version an image at a time: its batched
    # matmul may round the last place otherwise
    torch.testing.assert_close(torch.Tensor(x), wavelet_rec_plain(
        take(full).contiguous()), atol=1e-6, rtol=0)


def test_two_parts_launch_directly_into_one_output(emulated):
    """The ``wavelet_in_unet`` hook's call under no_grad: two launches
    into the two channel ranges of one output, as the Function's."""
    x = on_card(torch.from_numpy(np.random.default_rng(9).uniform(
        -1, 1, (3, 6, 16, 24)).astype(np.float32)))
    with torch.no_grad():
        z = wavelet_cuda.wavelet_dec_cat([x[:, :3], x[:, 3:]])
    assert z.grad_fn is None
    assert [call[1:3] for call in emulated] == [
        (x.data_ptr(), z.data_ptr()), (x[:, 3:].data_ptr(),
                                       z[:, 48:].data_ptr())]
    assert [call[-2:] for call in emulated] == [(6 * 16 * 24, 96 * 4 * 6)] * 2
    assert wavelet_cuda.launches["wavelet_dec"] == 2


# ----------------------------------------------------- the autograd route


@pytest.mark.parametrize("shape", [(2, 6, 16, 24), (1, 6, 8, 12)])
def test_dwt_route_under_autograd_is_jax_vjp(emulated, shape):
    """Grad enabled and an input that requires it: the Function, whose
    backward (the IWT kernel on each part's channel range of the gradient)
    is ``jax.vjp`` of JAX's wavelet_dec."""
    rng = np.random.default_rng(10)
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    b, _, h, w = shape
    g = rng.uniform(-3, 3, (b, 96, h // 4, w // 4)).astype(np.float32)

    def jax_fn(a):
        return jnp.concatenate([jax_dec(a[:, :3], 2, "NCHW"),
                                jax_dec(a[:, 3:], 2, "NCHW")], axis=1)

    out, vjp = jax.vjp(jax_fn, jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = on_card(torch.from_numpy(x)).requires_grad_()
    z = wavelet_cuda.wavelet_dec_cat([xt[:, :3], xt[:, 3:]])
    assert type(z.grad_fn).__name__ == "WaveletDecCatBackward"
    np.testing.assert_allclose(torch.Tensor(z.detach()).numpy(),
                               np.asarray(out), atol=1e-6, rtol=0)
    z.backward(on_card(torch.from_numpy(g)))
    np.testing.assert_allclose(torch.Tensor(xt.grad).numpy(),
                               np.asarray(want), atol=1e-6, rtol=0)
    assert wavelet_cuda.launches == {
        "wavelet_dec": 2, "wavelet_rec": 0, "wavelet_dec_backward": 2,
        "wavelet_rec_backward": 0}


@pytest.mark.parametrize("shape", [(2, 48, 4, 6), (1, 48, 2, 3)])
def test_iwt_route_under_autograd_is_jax_vjp(emulated, shape):
    rng = np.random.default_rng(11)
    z = rng.uniform(-1, 1, shape).astype(np.float32)
    b, _, h, w = shape
    g = rng.uniform(-3, 3, (b, 3, 4 * h, 4 * w)).astype(np.float32)
    out, vjp = jax.vjp(lambda a: jax_rec(a, 2, "NCHW"), jnp.asarray(z))
    (want,) = vjp(jnp.asarray(g))
    zt = on_card(torch.from_numpy(z)).requires_grad_()
    x = wavelet_cuda.wavelet_rec_cuda(zt)
    assert type(x.grad_fn).__name__ == "WaveletRecBackward"
    np.testing.assert_allclose(torch.Tensor(x.detach()).numpy(),
                               np.asarray(out), atol=1e-6, rtol=0)
    x.backward(on_card(torch.from_numpy(g)))
    np.testing.assert_allclose(torch.Tensor(zt.grad).numpy(),
                               np.asarray(want), atol=1e-6, rtol=0)
    assert wavelet_cuda.launches == {
        "wavelet_dec": 0, "wavelet_rec": 1, "wavelet_dec_backward": 0,
        "wavelet_rec_backward": 1}
