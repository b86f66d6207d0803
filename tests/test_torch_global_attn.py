"""PyTorch port: the global-attention path (``raindrop_wavelet_global.yaml``:
``DiffusionUNetGlobal``, the sampler's ``use_global``, the whole-image
training crops) against the JAX package.

Reduced geometry: a 128x192 image (a 32x48 wavelet grid, 8x8 patches at
stride 4: 77 patches), a UNet of width 32 with two levels, T = 50, a small
HFRM.  The global branch then cross-attends 6 to 15 whole-image tokens a
level.  Weights are random, from numpy with a seed, carried across by
``utils/convert.py``; inputs and noise come from numpy or are JAX's own
draws handed to the port.

Tolerances: float32 on both sides, summation order only.  Module outputs
are held to 1e-5 of their scale, the UNet forward to 1e-4 of its scale, a
restore to 1e-4 absolute (images in [0, 1]); after one SGD step the loss
and gradient norm agree to 1e-4 relative and every parameter to 1e-4 of
its tensor's scale.  The port's micro-batched chain at B = 2 is held to
its own unbatched chain within 1e-5 (the same arithmetic in other batch
shapes).
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from wavedm_tpu.config import config_from_dict as jax_config_from_dict
from wavedm_tpu.data import raindrop as jax_raindrop
from wavedm_tpu.diffusion.loss import antithetic_timesteps as jax_antithetic
from wavedm_tpu.inference.restoration import \
    DiffusiveRestoration as JaxRestoration
from wavedm_tpu.models.hfrm import HFRM as JaxHFRM
from wavedm_tpu.models.unet_global import AttnGlobal as JaxAttnGlobal
from wavedm_tpu.models.unet_global import \
    DiffusionUNetGlobal as JaxUNetGlobal
from wavedm_tpu.training import train_step as jax_train_step
from wavedm_tpu.training.state import \
    create_train_state as jax_create_train_state
from wavedm_tpu.utils.checkpoint import save_checkpoint as jax_save

from wavedm_tpu_torch.config import config_from_dict
from wavedm_tpu_torch.data import raindrop
from wavedm_tpu_torch.inference.loader import build_restorer
from wavedm_tpu_torch.models.layers import ConvTranspose2d
from wavedm_tpu_torch.models.unet_global import (AttnGlobal,
                                                 DiffusionUNetGlobal)
from wavedm_tpu_torch.training.train_step import prepare_global_batch
from wavedm_tpu_torch.training.trainer import DiffusionTrainer
from wavedm_tpu_torch.utils.convert import (_attn_global, _conv_transpose,
                                            hfrm_state_dict_from_flax,
                                            unet_global_state_dict_from_flax)
from wavedm_tpu_torch.utils.images import write_png
from wavedm_tpu_torch.utils.orbax_convert import convert_orbax_checkpoint

H, W, P = 128, 192, 8
SEED = 3
RAW = {
    "data": {"image_size": P, "patch_size": 4 * P, "global_attn": True},
    "model": {"ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1,
              "attn_resolutions": [4]},
    "diffusion": {"num_diffusion_timesteps": 50},
    "sampling": {"sampling_timesteps": 3, "grid_r": 4},
    "hfrm": {"dim": 8, "enc_blk_nums": [1, 1], "middle_blk_num": 1,
             "dec_blk_nums": [1, 1]},
    "training": {"seed": SEED, "patch_n": 4},
    "optim": {"optimizer": "SGD", "lr": 1e-3},
}
QUIET = dict(device="cpu", log_fn=lambda s: None)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one thread: the suite runs several pytest-xdist workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raw(**sections):
    raw = copy.deepcopy(RAW)
    for name, values in sections.items():
        raw.setdefault(name, {}).update(values)
    return raw


def random_params(shapes, seed):
    """A parameter tree of ``shapes`` (from ``jax.eval_shape``) filled from
    numpy: kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.1^2), the rest
    N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        std = (1.0 / np.sqrt(np.prod(s.shape[:-1])) if name == "kernel"
               else 0.1)
        v = std * rng.standard_normal(s.shape)
        return jnp.asarray(v + (name == "scale"), jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_config_from_dict(_raw())
    shapes = jax.eval_shape(JaxUNetGlobal.from_config(jcfg).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, P, P, 96)),
                            jnp.zeros((1,)), jnp.zeros((1, 16, 16, 48)))
    hshapes = jax.eval_shape(JaxHFRM.from_config(jcfg).init,
                             jax.random.PRNGKey(1), jnp.zeros((1, H, W, 3)))
    return (random_params(shapes["params"], 0),
            random_params(hshapes["params"], 1))


def _unet_sd(uparams):
    return unet_global_state_dict_from_flax(uparams, 2, 1)


def _hfrm_sd(hparams):
    return hfrm_state_dict_from_flax(hparams, (1, 1), 1, (1, 1))


# ------------------------------------------------------------------ modules


@pytest.mark.parametrize("bg", [6, 2, 1], ids=["own", "per_image", "one"])
def test_attn_global_matches_jax(bg):
    """Bg < B: each image's tokens go to its own consecutive patches (JAX's
    ``jnp.repeat``, torch's ``repeat_interleave``); ``global_index`` names
    the same assignment explicitly."""
    rng = np.random.default_rng(bg)
    xp = rng.standard_normal((6, 8, 8, 32)).astype(np.float32)
    xg = rng.standard_normal((bg, 24, 40, 32)).astype(np.float32)
    jm = JaxAttnGlobal()
    params = random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                          xp, xg)["params"], 2)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, xp, xg))
    tm = AttnGlobal(32)
    sd = {}
    _attn_global(sd, "m", params)
    tm.load_state_dict({k[2:]: v for k, v in sd.items()})
    with torch.no_grad():
        got = nhwc(tm(nchw(xp), nchw(xg)))
        index = torch.arange(bg).repeat_interleave(6 // bg)
        by_index = nhwc(tm(nchw(xp), nchw(xg), index))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)
    np.testing.assert_array_equal(by_index, got)


def test_transposed_conv_is_flax_2h_minus_2():
    """Flax's ConvTranspose(4x4, stride 2, padding ((1, 1), (1, 1))) maps
    15x23 to 28x44; the port's ConvTranspose2d(k=4, s=2, padding=2) with
    the converted (flipped) kernel gives the same values, where padding=1
    would give 30x46."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 15, 23, 16)).astype(np.float32)
    jm = fnn.ConvTranspose(8, (4, 4), strides=(2, 2),
                           padding=((1, 1), (1, 1)))
    params = random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                          x)["params"], 3)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, x))
    assert want.shape == (2, 28, 44, 8)
    sd = {}
    _conv_transpose(sd, "m", params)
    tm = ConvTranspose2d(16, 8, 4, stride=2, padding=2)
    tm.load_state_dict({k[2:]: v for k, v in sd.items()})
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
        assert tuple(torch.nn.functional.conv_transpose2d(
            nchw(x), tm.weight, stride=2, padding=1).shape[2:]) == (30, 46)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("bg", [2, 4], ids=["broadcast", "own"])
def test_global_unet_forward_matches_jax(weights, bg):
    uparams, _ = weights
    jcfg = jax_config_from_dict(_raw())
    rng = np.random.default_rng(10 + bg)
    x = rng.standard_normal((4, P, P, 96)).astype(np.float32)
    t = np.array([3.0, 17.0, 30.0, 49.0], np.float32)
    g = rng.standard_normal((bg, 32, 48, 48)).astype(np.float32)
    want = np.asarray(jax.jit(JaxUNetGlobal.from_config(jcfg).apply)(
        {"params": uparams}, x, t, g))
    cfg = config_from_dict(_raw())
    model = DiffusionUNetGlobal.from_config(cfg)
    model.load_state_dict(_unet_sd(uparams))
    with torch.no_grad():
        got = nhwc(model(nchw(x), torch.from_numpy(t), nchw(g)))
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_prepare_global_batch_matches_jax():
    total = np.random.default_rng(11).random((2, 64, 96, 3),
                                             dtype=np.float32)
    want = np.asarray(jax_train_step.prepare_global_batch(
        jnp.asarray(total), jax_config_from_dict(_raw())))
    got = prepare_global_batch(torch.from_numpy(total),
                               config_from_dict(_raw()))
    assert got.shape == (2, 48, 16, 24)
    np.testing.assert_allclose(nhwc(got), want, atol=1e-6)


# ------------------------------------------------------------------ train


def test_global_train_step_matches_jax(weights):
    """One SGD step of ``DiffusionTrainer`` on (crops, total) batches
    (through the fused ResnetBlock op) against JAX's jitted step, JAX's t
    and noise injected."""
    uparams, _ = weights
    jcfg = jax_config_from_dict(_raw())
    jstep = jax_train_step.make_train_step(
        jcfg, JaxUNetGlobal.from_config(jcfg).apply, donate=False)
    jstate = jax_create_train_state(uparams, jcfg.optim,
                                    jax.random.PRNGKey(1))
    rng = np.random.default_rng(12)
    crops = rng.random((4, 4 * P, 4 * P, 6), dtype=np.float32)
    total = rng.random((1, 64, 96, 3), dtype=np.float32)
    _, key_t, key_e = jax.random.split(jstate.rng, 3)
    t = np.array(jax_antithetic(key_t, 4, 50))
    e = np.asarray(jax.random.normal(key_e, (4, P, P, 3), jnp.float32))
    jstate, jm = jstep(jstate, (jnp.asarray(crops), jnp.asarray(total)))

    cfg = config_from_dict(_raw(parallel={"fused_resblock": True}))
    trainer = DiffusionTrainer(cfg, **QUIET)
    trainer.model.load_state_dict(_unet_sd(uparams))
    m = trainer.train_step(trainer.state, (crops, total),
                           t=torch.from_numpy(t), e=nchw(e))
    for name in ("loss", "mse_loss", "loss_per_pixel", "grad_norm"):
        got, want = float(getattr(m, name)), float(getattr(jm, name))
        assert abs(got - want) <= 1e-4 * abs(want), name
    got_sd = trainer.model.state_dict()
    for k, w in _unet_sd(jstate.params).items():
        assert float((got_sd[k] - w).abs().max()) <= 1e-4 * float(
            w.abs().max()), k


def test_grad_accum_is_refused():
    cfg = config_from_dict(_raw(training={"grad_accum": 2}))
    with pytest.raises(ValueError, match="grad_accum"):
        DiffusionTrainer(cfg, **QUIET)


def test_global_crops_match_jax(tmp_path):
    """Streamed (crops, totals) batches equal JAX's PIL path: the total is
    the input LANCZOS-resized to 720x480, once per image."""
    rng = np.random.default_rng(13)
    for i in range(2):
        for folder, name in (("input", f"{i}_rain.png"),
                             ("gt", f"{i}_clean.png")):
            path = tmp_path / "raindrop" / "train" / folder / name
            os.makedirs(path.parent, exist_ok=True)
            write_png(str(path), rng.integers(0, 256, (40, 56, 3),
                                              dtype=np.uint8))
    raw = {"data": {"image_size": 4, "patch_size": 16, "global_attn": True,
                    "data_dir": str(tmp_path)},
           "training": {"patch_n": 2, "batch_size": 2, "seed": 7}}
    want = list(jax_raindrop.RainDrop(jax_config_from_dict(raw))
                .train_batches(0, use_native=False))
    got = list(raindrop.RainDrop(config_from_dict(raw)).train_batches(0))
    assert len(got) == len(want) == 1
    (crops, totals), (jcrops, jtotals) = got[0], want[0]
    assert totals.shape == (2, 480, 720, 3)
    np.testing.assert_array_equal(crops, jcrops)
    np.testing.assert_array_equal(totals, jtotals)


# ------------------------------------------------------------------ restore


def _jax_restorer(weights, **sampling):
    uparams, hparams = weights
    jcfg = jax_config_from_dict(_raw(sampling=sampling))
    return JaxRestoration(jcfg, JaxUNetGlobal.from_config(jcfg).apply,
                          uparams, JaxHFRM.from_config(jcfg).apply, hparams)


def _port_restorer(weights, **sections):
    uparams, hparams = weights
    return build_restorer(config_from_dict(_raw(**sections)),
                          _unet_sd(uparams), _hfrm_sd(hparams), device="cpu")


def _jax_noise(b):
    key_init, _ = jax.random.split(jax.random.PRNGKey(SEED))
    return np.asarray(jax.random.normal(key_init, (b, H // 4, W // 4, 3),
                                        jnp.float32))


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(14).random((2, H, W, 3), dtype=np.float32)


@pytest.mark.parametrize("route", ["plain", "fused_resblock"])
def test_global_restore_matches_jax(weights, images, route):
    """One image (B = 1), where JAX hands every patch the image's tokens."""
    want, want_hfrm = _jax_restorer(weights).restore_image(
        images[:1], jax.random.PRNGKey(SEED))
    parallel = {} if route == "plain" else {route: True}
    rest = _port_restorer(weights, parallel=parallel)
    out, hfrm_out = rest.restore_image_device(images[:1],
                                              noise=nchw(_jax_noise(1)))
    assert out.shape == (1, H, W, 3)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(hfrm_out.numpy(), np.asarray(want_hfrm),
                               atol=1e-5)


def test_micro_batched_global_chain(weights, images):
    """Two images in micro-batches of 3 patches give the port's unbatched
    result: every patch attends to its own image.  JAX's micro-batched
    chain does not: it spreads both images' tokens over each chunk by
    position (a chunk of 2 gives one patch each image's), so its result
    moves, and a chunk that two images do not divide fails its assert."""
    noise = nchw(_jax_noise(2))
    whole, _ = _port_restorer(weights).restore_image_device(images,
                                                            noise=noise)
    chunked, _ = _port_restorer(
        weights, sampling={"patch_micro_batch": 3}).restore_image_device(
        images, noise=noise)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), atol=1e-5)

    key = jax.random.PRNGKey(SEED)
    jwhole, _ = _jax_restorer(weights).restore_image(images, key)
    np.testing.assert_allclose(whole.numpy(), jwhole, atol=1e-4)
    jchunked, _ = _jax_restorer(weights, patch_micro_batch=2).restore_image(
        images, key)
    assert float(np.abs(jchunked - jwhole).max()) > 1e-2
    with pytest.raises(AssertionError):
        _jax_restorer(weights, patch_micro_batch=3).restore_image(images,
                                                                  key)


def test_whole_image_chain_with_global_attn_raises(weights, images):
    rest = _port_restorer(weights, sampling={"whole_image": True})
    with pytest.raises(ValueError, match="whole_image \\+ global_attn"):
        rest.restore_image(images[:1])


# ------------------------------------------------------------------ convert


def test_orbax_global_checkpoint_converts(weights, tmp_path):
    """A JAX checkpoint of the global UNet converts through
    ``unet_global_state_dict_from_flax`` and serves; a config without
    ``global_attn`` refuses it."""
    uparams, hparams = weights
    jcfg = jax_config_from_dict(_raw())
    state = jax_create_train_state(uparams, jcfg.optim, jax.random.PRNGKey(1))
    src = str(tmp_path / "jax_ckpt")
    jax_save(src, state, epoch=2)
    cfg = config_from_dict(_raw())
    info = convert_orbax_checkpoint(src, str(tmp_path / "port"), cfg)
    assert (info["kind"], info["epoch"]) == ("unet", 2)
    rest = build_restorer(cfg, info["path"], _hfrm_sd(hparams), device="cpu")
    got = rest.unet.state_dict()
    for k, w in _unet_sd(uparams).items():
        assert torch.equal(got[k], w), k
    plain = config_from_dict(_raw(data={"global_attn": False}))
    with pytest.raises(ValueError, match="global_attn"):
        convert_orbax_checkpoint(src, str(tmp_path / "no"), plain)
    assert not os.path.exists(str(tmp_path / "no.pth.tar"))
