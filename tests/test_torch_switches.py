"""PyTorch port: the UNet's switches that no shipped config turns on
(``wavelet_in_unet``, ``use_window``, ``use_fft``) against the JAX package,
and the DWT/IWT kernels' gradient and strided operands.

Both sides get the same weights (random, from numpy with a seed, carried
across by ``utils/convert.py``), the same inputs and the same noise (JAX's
own x_T draw and its train step's t and noise, handed to the port).

Tolerances, everything in float32:
- the UNet under ``use_window`` against ``tests/golden/unet_window.npz``
  and JAX: atol 2e-4, rtol 1e-3, the JAX package's own golden test's;
- the UNet under ``wavelet_in_unet`` against JAX: 1e-4 (summation order);
- the kernels' autograd Functions against ``jax.vjp`` of JAX's
  ``wavelet_dec`` / ``wavelet_rec``: 1e-6 (each output sums 16 terms of
  +-1/4 times inputs within [-3, 3]);
- ``fft_condition`` against JAX: amplitude rtol 1e-4 / atol 1e-3, phase
  within 2e-3 modulo 2 pi (see that test);
- a 2-step restore under each switch: 1e-4 absolute on images in [0, 1];
  one SGD train step: loss and gradient norm 1e-4 relative, every
  parameter within 1e-4 of its tensor's scale, and every parameter's
  gradient (JAX's momentum trace after one step) within 1e-4 of its own
  tensor's scale plus 1e-6 of the largest gradient in the network: that
  floor is for the leaves whose exact gradient is 0 (attention's key
  biases; biases in front of a GroupNorm of one channel a group), where
  both sides hold float noise.

Under ``use_fft`` the restore and train-step comparisons run JAX with the
phase of the exact spectrum (:func:`principal_fft_condition`, whose mask of
real bins this file writes out itself, independent of the port's):
the DC and Nyquist bins of a real image's FFT are real, but JAX's FFT
leaves rounding noise in their imaginary part (about 1e-9 of their
magnitude, its sign depending on the image), and where such a bin is
negative its phase reads -pi where the port's reads +pi.  The same angle,
but the UNet sees the number; ``test_fft_condition_matches_jax`` holds
the port to JAX's own ``fft_condition`` modulo 2 pi.

The Functions' forward and backward launch the CUDA kernels, which cannot
run here: those tests replace the library's C entries by a numpy
emulation that reads and writes the very addresses and batch strides the
wrapper passes, so the layout logic (slices read in place, outputs written
into channel ranges) is what is under test; the arithmetic is the plain
version's, which the card holds the kernels to (``chip_smoke.py``).
"""

import copy
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from wavedm_tpu.config import config_from_dict as jax_config_from_dict
from wavedm_tpu.diffusion import sampling as jax_sampling
from wavedm_tpu.diffusion.loss import antithetic_timesteps as jax_antithetic
from wavedm_tpu.diffusion.sampling import fft_condition as jax_fft_condition
from wavedm_tpu.inference.restoration import \
    DiffusiveRestoration as JaxRestoration
from wavedm_tpu.models.unet import DiffusionUNet as JaxUNet
from wavedm_tpu.models.unet import depth_to_space as jax_d2s
from wavedm_tpu.models.unet import space_to_depth as jax_s2d
from wavedm_tpu.ops.wavelet import wavelet_dec as jax_dec
from wavedm_tpu.ops.wavelet import wavelet_rec as jax_rec
from wavedm_tpu.training import train_step as jax_train_step
from wavedm_tpu.training.state import \
    create_train_state as jax_create_train_state
from wavedm_tpu.utils.checkpoint import save_checkpoint as jax_save

from wavedm_tpu_torch.config import config_from_dict
from wavedm_tpu_torch.diffusion.sampling import fft_condition, real_bins
from wavedm_tpu_torch.inference.loader import build_restorer, build_unet
from wavedm_tpu_torch.models.unet import (DiffusionUNet, conv_in_channels,
                                          depth_to_space, space_to_depth)
from wavedm_tpu_torch.ops import _build, wavelet_cuda
from wavedm_tpu_torch.ops.wavelet import wavelet_dec_plain, wavelet_rec_plain
from wavedm_tpu_torch.training.train_step import prepare_pixel_batch
from wavedm_tpu_torch.training.trainer import DiffusionTrainer
from wavedm_tpu_torch.utils.convert import unet_state_dict_from_flax
from wavedm_tpu_torch.utils.orbax_convert import convert_orbax_checkpoint

H, W = 64, 96
SEED = 4
BASE = {
    "model": {"ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1},
    "diffusion": {"num_diffusion_timesteps": 50},
    "sampling": {"sampling_timesteps": 2},
    "training": {"seed": SEED, "patch_n": 4},
    "optim": {"optimizer": "SGD", "lr": 1e-3},
}
PIXEL_MODEL = {"in_channels": 3, "use_other_channels": False,
               "other_channels_begin": 0, "use_gt_in_train": False}
# each switch at a small size: the UNet works on 8x8 (wavelet_in_unet: 32²
# patches; use_window: 16² patches in 2x2 tiles) or 16x16 (use_fft) inputs
SWITCHES = {
    "wavelet_in_unet": {
        "data": {"image_size": 32, "patch_size": 32, "wavelet": True,
                 "wavelet_in_unet": True},
        "model": dict(PIXEL_MODEL, out_ch=48, attn_resolutions=[16]),
        "sampling": {"grid_r": 16}},
    "use_window": {
        "data": {"image_size": 16, "patch_size": 16, "wavelet": False,
                 "use_window": True, "window_size": 2},
        "model": dict(PIXEL_MODEL, out_ch=12, attn_resolutions=[8]),
        "sampling": {"grid_r": 8}},
    "use_fft": {
        "data": {"image_size": 16, "patch_size": 16, "wavelet": False,
                 "use_fft": True},
        "model": dict(PIXEL_MODEL, in_channels=9, attn_resolutions=[8]),
        "sampling": {"grid_r": 8}},
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one thread: the suite runs several pytest-xdist workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raw(switch, **sections):
    raw = copy.deepcopy(BASE)
    for part in (SWITCHES[switch], sections):
        for name, values in part.items():
            raw.setdefault(name, {}).update(copy.deepcopy(values))
    return raw


def random_params(shapes, seed):
    """A parameter tree of ``shapes`` filled from numpy: kernels N(0,
    1/fan_in), norm scales 1 + N(0, 0.1^2), the rest N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        std = (1.0 / np.sqrt(np.prod(s.shape[:-1])) if name == "kernel"
               else 0.1)
        v = std * rng.standard_normal(s.shape)
        return jnp.asarray(v + (name == "scale"), jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_params(jcfg, seed=0):
    p = jcfg.data.image_size
    shapes = jax.eval_shape(
        JaxUNet.from_config(jcfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, p, p, jcfg.model.unet_in_channels)), jnp.zeros((1,)))
    return random_params(shapes["params"], seed)


def self_conjugate_bins(h, w):
    """(h, w) mask of the bins (u, v) with (u, v) = (-u, -v) mod (h, w),
    where a real image's FFT is real: u in {0, h/2}, v in {0, w/2} (the
    halves only for even sides), written out index by index."""
    mask = np.zeros((h, w), bool)
    for u in ({0, h // 2} if h % 2 == 0 else {0}):
        for v in ({0, w // 2} if w % 2 == 0 else {0}):
            mask[u, v] = True
    return mask


@pytest.mark.parametrize("h, w", [(16, 24), (15, 8), (7, 9), (2, 1)])
def test_real_bins_are_the_self_conjugate_bins(h, w):
    np.testing.assert_array_equal(real_bins(h, w), self_conjugate_bins(h, w))


def principal_fft_condition(cond):
    """JAX's ``fft_condition`` with the imaginary part of the
    self-conjugate bins set to 0: the principal phase of the exact
    spectrum."""
    f = jnp.fft.fft2(cond, axes=(1, 2))
    real = self_conjugate_bins(*cond.shape[1:3])[None, :, :, None]
    imag = jnp.where(real, 0.0, f.imag)
    return jnp.concatenate([cond, jnp.abs(f), jnp.arctan2(imag, f.real)],
                           axis=-1)


@pytest.fixture
def principal_jax_phase(monkeypatch):
    monkeypatch.setattr(jax_sampling, "fft_condition",
                        principal_fft_condition)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(
        0, 3, 1, 2)))


# ------------------------------------------------- kernels, emulated here


def _floats(ptr, n):
    """The n float32s at host address ``ptr``, as a writable numpy view."""
    return np.ctypeslib.as_array((ctypes.c_float * n).from_address(ptr))


@pytest.fixture
def emulated(monkeypatch):
    """The library's wavelet entries emulated in numpy at the addresses
    and batch strides the wrapper hands them; returns the calls made."""
    calls = []

    def launch(lib, entry, device, src, dst, b, c, h, w, s_bs, d_bs):
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


def test_strided_slices_are_read_and_written_in_place(emulated):
    """The hook's two DWTs read the channel slices of one contiguous batch
    where they lie and write into the two channel ranges of one output:
    two launches, no copy, and the result of the contiguous transform."""
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (3, 6, 16, 24)).astype(np.float32))
    z = wavelet_cuda.WaveletDecCat.apply(x[:, :3], x[:, 3:])
    want = torch.cat([wavelet_dec_plain(x[:, :3].contiguous()),
                      wavelet_dec_plain(x[:, 3:].contiguous())], dim=1)
    torch.testing.assert_close(z, want, atol=0, rtol=0)
    (e0, s0, d0, *_, sbs0, dbs0), (e1, s1, d1, *_, sbs1, dbs1) = emulated
    assert (e0, e1) == ("wavelet_dec_f32", "wavelet_dec_f32")
    assert (s0, s1) == (x.data_ptr(), x[:, 3:].data_ptr())
    assert (d0, d1) == (z.data_ptr(), z[:, 48:].data_ptr())
    assert sbs0 == sbs1 == 6 * 16 * 24 and dbs0 == dbs1 == 96 * 4 * 6
    assert wavelet_cuda.launches["wavelet_dec"] == 2


def test_strided_slice_dwt_equals_the_contiguous_one():
    """On the CPU the hook's slices go through the plain version as they
    lie, and give the DWT of contiguous copies."""
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (2, 9, 8, 12)).astype(np.float32))
    got = wavelet_cuda.wavelet_dec_cat([x[:, :3], x[:, 3:]])
    want = torch.cat([wavelet_dec_plain(x[:, :3].clone()),
                      wavelet_dec_plain(x[:, 3:].clone())], dim=1)
    assert tuple(got.shape) == (2, 144, 2, 3)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_layouts_the_kernels_refuse_raise(emulated):
    x = torch.zeros(2, 3, 8, 8)
    for bad in (x.permute(0, 1, 3, 2), x.to(torch.float64),
                torch.zeros(2, 3, 8, 8).expand(2, 3, 8, 8)[:, :, ::2]):
        with pytest.raises(ValueError):
            wavelet_cuda.WaveletDecCat.apply(bad)
    with pytest.raises(ValueError, match="not divisible by 16"):
        wavelet_cuda.WaveletRec.apply(torch.zeros(1, 8, 2, 2))
    assert not emulated
    # a gradient in another layout is made contiguous, then launched
    g = torch.zeros(1, 4, 4, 48).permute(0, 3, 1, 2)
    assert wavelet_cuda.kernel_layout(g, False).is_contiguous()
    # a channel slice is taken as it lies
    assert wavelet_cuda.kernel_layout(x[:, 1:]).data_ptr() == \
        x[:, 1:].data_ptr()


def test_dwt_function_gradient_is_jax_vjp(emulated):
    """The DWT Function's backward (the IWT kernel on each part's channel
    range of the gradient) against ``jax.vjp`` of JAX's wavelet_dec."""
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (2, 6, 16, 24)).astype(np.float32)
    g = rng.uniform(-3, 3, (2, 96, 4, 6)).astype(np.float32)

    def jax_fn(a):
        return jnp.concatenate([jax_dec(a[:, :3], 2, "NCHW"),
                                jax_dec(a[:, 3:], 2, "NCHW")], axis=1)

    out, vjp = jax.vjp(jax_fn, jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    z = wavelet_cuda.WaveletDecCat.apply(xt[:, :3], xt[:, 3:])
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(out),
                               atol=1e-6, rtol=0)
    z.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    assert wavelet_cuda.launches == {
        "wavelet_dec": 2, "wavelet_rec": 0, "wavelet_dec_backward": 2,
        "wavelet_rec_backward": 0}


def test_iwt_function_gradient_is_jax_vjp(emulated):
    """The IWT Function's backward (the DWT kernel on the gradient)
    against ``jax.vjp`` of JAX's wavelet_rec."""
    rng = np.random.default_rng(3)
    z = rng.uniform(-1, 1, (2, 48, 4, 6)).astype(np.float32)
    g = rng.uniform(-3, 3, (2, 3, 16, 24)).astype(np.float32)
    out, vjp = jax.vjp(lambda a: jax_rec(a, 2, "NCHW"), jnp.asarray(z))
    (want,) = vjp(jnp.asarray(g))
    zt = torch.from_numpy(z).requires_grad_()
    x = wavelet_cuda.WaveletRec.apply(zt)
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(out),
                               atol=1e-6, rtol=0)
    x.backward(torch.from_numpy(g))
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    assert wavelet_cuda.launches == {
        "wavelet_dec": 0, "wavelet_rec": 1, "wavelet_dec_backward": 0,
        "wavelet_rec_backward": 1}


def test_wrappers_raise_on_the_card_without_the_library(monkeypatch):
    """Under autograd too, a non-CPU tensor goes to the kernel: with no
    library the wrapper raises, with no fallback."""
    def no_library():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(_build, "library", no_library)
    x = torch.empty(1, 6, 8, 8, device="meta", requires_grad=True)
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        wavelet_cuda.wavelet_dec_cat([x[:, :3], x[:, 3:]])
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        wavelet_cuda.wavelet_rec_cuda(torch.empty(1, 48, 2, 2, device="meta",
                                                  requires_grad=True))


# ------------------------------------------------------------------ UNet


def test_space_to_depth_is_jax_tile_decomposition():
    x = np.random.default_rng(5).random((2, 5, 8, 12), dtype=np.float32)
    got = space_to_depth(torch.from_numpy(x), 2)
    want = jax_s2d(jnp.asarray(x.transpose(0, 2, 3, 1)), 2)
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1),
                                  np.asarray(want))
    np.testing.assert_array_equal(depth_to_space(got, 2).numpy(), x)
    np.testing.assert_array_equal(
        depth_to_space(torch.from_numpy(x[:, :4]), 2).numpy().transpose(
            0, 2, 3, 1),
        np.asarray(jax_d2s(jnp.asarray(x[:, :4].transpose(0, 2, 3, 1)), 2)))
    # tiles, not pixel_unshuffle's interleaved windows
    assert not torch.equal(got, F.pixel_unshuffle(torch.from_numpy(x), 2))


def test_unet_window_matches_golden_and_jax():
    z = np.load("tests/golden/unet_window.npz")
    sd = {k[4:]: torch.from_numpy(z[k]) for k in z.files
          if k.startswith("sd::")}
    model = DiffusionUNet(in_channels=24, out_ch=24, ch=32, ch_mult=(1, 2),
                          num_res_blocks=1, attn_resolutions=(),
                          resolution=16, use_window=True, window_size=2)
    model.load_state_dict(sd)
    with torch.no_grad():
        y = model(torch.from_numpy(z["x"]), torch.from_numpy(z["t"]))
    np.testing.assert_allclose(y.numpy(), z["y"], atol=2e-4, rtol=1e-3)
    jcfg = jax_config_from_dict(_raw("use_window"))
    params = jax_params(jcfg, 6)
    x = np.random.default_rng(6).uniform(-1, 1, (3, 16, 16, 6)).astype(
        np.float32)
    t = np.array([3.0, 20.0, 41.0], np.float32)
    want = JaxUNet.from_config(jcfg).apply({"params": params},
                                           jnp.asarray(x), jnp.asarray(t))
    cfg = config_from_dict(_raw("use_window"))
    model = DiffusionUNet.from_config(cfg)
    model.load_state_dict(unet_state_dict_from_flax(params, 2, 1))
    with torch.no_grad():
        y = model(_nchw(x), torch.from_numpy(t))
    np.testing.assert_allclose(y.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), atol=2e-4, rtol=1e-3)


def test_unet_wavelet_in_unet_matches_jax():
    """The DWT on entry and the IWT on exit, attention placed by the
    configured resolution (32: levels 32 and 16, so the UNet's 4x4 level
    has attention although it works on 8x8 and 4x4)."""
    jcfg = jax_config_from_dict(_raw("wavelet_in_unet"))
    params = jax_params(jcfg, 7)
    assert "down_1_attn_0" in params and "down_0_attn_0" not in params
    x = np.random.default_rng(7).uniform(-1, 1, (3, 32, 32, 6)).astype(
        np.float32)
    t = np.array([0.0, 17.0, 49.0], np.float32)
    want = JaxUNet.from_config(jcfg).apply({"params": params},
                                           jnp.asarray(x), jnp.asarray(t))
    model = DiffusionUNet.from_config(config_from_dict(_raw(
        "wavelet_in_unet")))
    model.load_state_dict(unet_state_dict_from_flax(params, 2, 1))
    with torch.no_grad():
        y = model(_nchw(x), torch.from_numpy(t))
    assert tuple(y.shape) == (3, 3, 32, 32)
    np.testing.assert_allclose(y.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("switch, data, model, width", [
    ("wavelet_in_unet", {}, {}, 96),
    ("use_window", {}, {}, 24),
    ("use_fft", {}, {}, 12),
    ("use_fft", {"use_window": True, "window_size": 4}, {"out_ch": 48}, 192),
    ("wavelet_in_unet", {"use_fft": True}, {"in_channels": 9}, 192),
], ids=["wavelet_in_unet", "use_window", "use_fft", "fft_window4",
        "wavelet_fft"])
def test_conv_in_width_and_tree_match_jax(switch, data, model, width):
    """conv_in's width from the config (flax infers it) and every
    parameter's shape equal the JAX tree's, so a converted tree loads."""
    raw = _raw(switch, data=data, model=model)
    cfg = config_from_dict(raw)
    assert conv_in_channels(cfg) == width
    with torch.device("meta"):
        sd = DiffusionUNet.from_config(cfg).state_dict()
    want = unet_state_dict_from_flax(jax_params(
        jax_config_from_dict(copy.deepcopy(raw))), 2, 1)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in want.items()}


# ------------------------------------------------------------ fft_condition


def test_fft_condition_matches_jax():
    """Amplitude and phase of each channel's 2-D FFT.  Phases compare
    modulo 2 pi: the DC and Nyquist bins of a real image's FFT are real,
    and where the two FFTs give their zero imaginary parts opposite signs
    a negative real part reads +pi on one side and -pi on the other, the
    same angle.  The difference is wrapped into [-pi, pi) before the
    2e-3 bound."""
    x = np.random.default_rng(8).uniform(-1, 1, (3, 3, 16, 24)).astype(
        np.float32)
    x[0, 0] = -0.5                           # a constant channel: DC only
    got = fft_condition(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_fft_condition(jnp.asarray(
        x.transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2)
    assert got.shape == want.shape == (3, 9, 16, 24)
    np.testing.assert_array_equal(got[:, :3], want[:, :3])
    np.testing.assert_allclose(got[:, 3:6], want[:, 3:6], rtol=1e-4,
                               atol=1e-3)
    dphase = np.mod(got[:, 6:] - want[:, 6:] + np.pi, 2 * np.pi) - np.pi
    # bins of zero amplitude have no phase to agree on
    live = want[:, 3:6] > 1e-3
    assert np.abs(dphase[live]).max() <= 2e-3
    # the port's phase is that of the exact spectrum: the real bins read
    # 0 or +pi
    real = np.broadcast_to(self_conjugate_bins(16, 24), got[:, 6:].shape)
    assert set(np.unique(got[:, 6:][real])) <= {0.0, np.float32(np.pi)}
    assert real.sum() == 3 * 3 * 4


# ------------------------------------------------------- restore and train


def _jax_restore(jcfg, params, images, whole_image=False):
    jrest = JaxRestoration(jcfg, JaxUNet.from_config(jcfg).apply, params)
    out, _ = jrest.restore_image(images, jax.random.PRNGKey(SEED))
    key_init, _ = jax.random.split(jax.random.PRNGKey(SEED))
    noise = np.asarray(jax.random.normal(
        key_init, images.shape[:3] + (jcfg.model.pred_channels,),
        jnp.float32))
    return out, noise


@pytest.mark.parametrize("switch, whole_image", [
    ("wavelet_in_unet", False), ("use_window", False), ("use_fft", False),
    ("use_fft", True)],
    ids=["wavelet_in_unet", "use_window", "use_fft", "use_fft_whole_image"])
def test_restore_matches_jax(switch, whole_image, principal_jax_phase):
    """A 2-step restore of two 64x96 images on the pixel path (JAX's
    route for each switch; no HFRM under wavelet_in_unet), tiled or over
    the whole image."""
    raw = _raw(switch, sampling={"whole_image": whole_image})
    jcfg = jax_config_from_dict(copy.deepcopy(raw))
    params = jax_params(jcfg, 9)
    images = np.random.default_rng(9).random((2, H, W, 3), dtype=np.float32)
    want, noise = _jax_restore(jcfg, params, images)
    rest = build_restorer(config_from_dict(raw),
                          unet_state_dict_from_flax(params, 2, 1),
                          device="cpu")
    assert rest.hfrm is None
    out, aux = rest.restore_image_device(images, noise=_nchw(noise))
    assert out.shape == (2, H, W, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    np.testing.assert_array_equal(aux.numpy(), images)


@pytest.mark.parametrize("switch", list(SWITCHES))
def test_train_step_matches_jax(switch, principal_jax_phase):
    """One SGD step of ``DiffusionTrainer`` under each switch against
    JAX's jitted step, JAX's t and noise injected (under
    wavelet_in_unet the IWT's gradient flows back through the DWT's
    adjoint)."""
    raw = _raw(switch)
    jcfg = jax_config_from_dict(copy.deepcopy(raw))
    params = jax_params(jcfg, 10)
    jstep = jax_train_step.make_train_step(
        jcfg, JaxUNet.from_config(jcfg).apply, donate=False)
    jstate = jax_create_train_state(params, jcfg.optim,
                                    jax.random.PRNGKey(1))
    n, p = 4, jcfg.data.patch_size
    batch = np.random.default_rng(11).random((n, p, p, 6), dtype=np.float32)
    _, key_t, key_e = jax.random.split(jstate.rng, 3)
    t = np.asarray(jax_antithetic(key_t, n, 50))
    e = np.asarray(jax.random.normal(key_e, (n, p, p, 3), jnp.float32))
    jstate, jm = jstep(jstate, jnp.asarray(batch))

    trainer = DiffusionTrainer(config_from_dict(raw), device="cpu",
                               log_fn=lambda s: None)
    trainer.model.load_state_dict(unet_state_dict_from_flax(params, 2, 1))
    m = trainer.train_step(trainer.state, batch,
                           t=torch.from_numpy(t.copy()), e=_nchw(e))
    for name in ("loss", "mse_loss", "loss_per_pixel", "grad_norm"):
        got, want = float(getattr(m, name)), float(getattr(jm, name))
        assert abs(got - want) <= 1e-4 * abs(want), name
    got_sd = trainer.model.state_dict()
    for k, w in unet_state_dict_from_flax(jstate.params, 2, 1).items():
        assert float((got_sd[k] - w).abs().max()) <= 1e-4 * float(
            w.abs().max()), k
    # each leaf's gradient: SGD's momentum trace after one step is it
    (trace,) = [s.trace for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda s: hasattr(s, "trace"))
        if hasattr(s, "trace")]
    want_g = unet_state_dict_from_flax(trace, 2, 1)
    g_all = max(float(g.abs().max()) for g in want_g.values())
    for k, p in trainer.model.named_parameters():
        err = float((p.grad - want_g[k]).abs().max())
        assert err <= 1e-4 * float(want_g[k].abs().max()) + 1e-6 * g_all, k


def test_prepare_pixel_batch_appends_the_fft_conditioning():
    raw = _raw("use_fft")
    x = np.random.default_rng(12).random((2, 16, 16, 6), dtype=np.float32)
    got = prepare_pixel_batch(torch.from_numpy(x), config_from_dict(raw))
    want = np.asarray(jax_train_step.prepare_pixel_batch(
        jnp.asarray(x), jax_config_from_dict(raw))).transpose(0, 3, 1, 2)
    assert tuple(got.shape) == (2, 12, 16, 16)
    np.testing.assert_allclose(got[:, :6].numpy(), want[:, :6], rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_array_equal(got[:, 9:].numpy(), want[:, 9:])


# ------------------------------------------------------------ converters


@pytest.mark.parametrize("switch", ["wavelet_in_unet", "use_window"])
def test_converters_carry_the_wider_conv_in(switch, tmp_path):
    """A UNet whose conv_in is 96 (wavelet_in_unet) or 24 (use_window)
    channels wide comes through a JAX Orbax checkpoint and through a
    ``.pth.tar`` file, weights unchanged."""
    raw = _raw(switch)
    jcfg = jax_config_from_dict(copy.deepcopy(raw))
    cfg = config_from_dict(raw)
    params = jax_params(jcfg, 13)
    jstate = jax_create_train_state(params, jcfg.optim,
                                    jax.random.PRNGKey(2))
    jax_save(str(tmp_path / "orbax"), jstate, epoch=0)
    info = convert_orbax_checkpoint(str(tmp_path / "orbax"),
                                    str(tmp_path / "conv"), cfg)
    want = unet_state_dict_from_flax(params, 2, 1)
    torch.save({"state_dict": want}, tmp_path / "ref.pth.tar")
    for path in (info["path"], str(tmp_path / "ref.pth.tar")):
        unet = build_unet(cfg, path, device="cpu")
        assert unet.conv_in.weight.shape[1] == conv_in_channels(cfg)
        for k, v in unet.state_dict().items():
            assert torch.equal(v, want[k]), k
