"""PyTorch port: the pixel-space path (``raindrop.yaml``: ``data.wavelet:
false``, 6 UNet input channels, no HFRM) against the JAX package.

Reduced geometry: 16x16 pixel patches of a 32x48 image at stride 8 (15
patches), a UNet of width 32 with two levels, T = 50.  Both sides get the
same weights (random, from numpy with a seed, carried across by
``utils/convert.py``), the same images and the same noise: JAX's own x_T
draw and its train step's t and noise, handed to the port.

Tolerances: everything runs in float32, where the two sides differ by
summation order only.  A restore is held to 1e-4 absolute (images in
[0, 1]), through the plain layers and through each kernel route
(``fused_groupnorm``, ``fused_resblock``: their plain versions here).
After one SGD step the loss and gradient norm agree to 1e-4 relative and
every parameter to 1e-4 of its tensor's scale.
"""

import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavedm_tpu.config import config_from_dict as jax_config_from_dict
from wavedm_tpu.diffusion.loss import antithetic_timesteps as jax_antithetic
from wavedm_tpu.inference.restoration import \
    DiffusiveRestoration as JaxRestoration
from wavedm_tpu.models.unet import DiffusionUNet as JaxUNet
from wavedm_tpu.training import train_step as jax_train_step
from wavedm_tpu.training.state import \
    create_train_state as jax_create_train_state

from wavedm_tpu_torch.config import PROFILES, config_from_dict, load_config
from wavedm_tpu_torch.inference.loader import build_restorer
from wavedm_tpu_torch.training.train_step import prepare_pixel_batch
from wavedm_tpu_torch.training.trainer import DiffusionTrainer
from wavedm_tpu_torch.utils import metrics as M
from wavedm_tpu_torch.utils.convert import unet_state_dict_from_flax

H, W, P = 32, 48, 16
SEED = 3
RAW = {
    "data": {"image_size": P, "patch_size": P, "wavelet": False},
    "model": {"in_channels": 3, "use_other_channels": False,
              "other_channels_begin": 0, "use_gt_in_train": False,
              "ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1,
              "attn_resolutions": [8]},
    "diffusion": {"num_diffusion_timesteps": 50},
    "sampling": {"sampling_timesteps": 5, "grid_r": 8},
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
        if name == "kernel":
            std = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
        else:
            std = 0.1
        v = std * rng.standard_normal(s.shape)
        return jnp.asarray(v + (name == "scale"), jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def uparams():
    jcfg = jax_config_from_dict(_raw())
    shapes = jax.eval_shape(JaxUNet.from_config(jcfg).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, P, P, 6)), jnp.zeros((1,)))
    return random_params(shapes["params"], 0)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(5).random((2, H, W, 3), dtype=np.float32)


@pytest.fixture(scope="module")
def jax_restore(uparams, images):
    jcfg = jax_config_from_dict(_raw())
    jrest = JaxRestoration(jcfg, JaxUNet.from_config(jcfg).apply, uparams)
    out, aux = jrest.restore_image(images, jax.random.PRNGKey(SEED))
    key_init, _ = jax.random.split(jax.random.PRNGKey(SEED))
    noise = np.asarray(jax.random.normal(key_init, images.shape,
                                         jnp.float32))
    return out, np.asarray(aux), noise


@pytest.mark.parametrize("route", ["plain", "fused_groupnorm",
                                   "fused_resblock"])
def test_pixel_restore_matches_jax(uparams, images, jax_restore, route):
    want, want_aux, noise = jax_restore
    parallel = {} if route == "plain" else {route: True}
    cfg = config_from_dict(_raw(parallel=parallel))
    rest = build_restorer(cfg, unet_state_dict_from_flax(uparams, 2, 1),
                          device="cpu")
    assert rest.hfrm is None
    out, aux = rest.restore_image_device(
        images, noise=torch.from_numpy(noise.transpose(0, 3, 1, 2).copy()))
    assert out.shape == (2, H, W, 3)
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
    np.testing.assert_allclose(out.numpy(), want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(aux.numpy(), want_aux)   # the cond image


def test_restore_scores_the_pairs(uparams):
    """``restore()`` restores the cond half of each pair, two at a time,
    and scores it against the gt half."""
    cfg = config_from_dict(_raw())
    rest = build_restorer(cfg, unet_state_dict_from_flax(uparams, 2, 1),
                          device="cpu")
    pairs = np.random.default_rng(6).random((2, H, W, 6), dtype=np.float32)
    res = rest.restore([(p, f"p{i}") for i, p in enumerate(pairs)],
                       eval_batch=2)
    out, _ = rest.restore_image(pairs[..., :3])      # the same seeded draw
    want = np.mean([M.psnr_torch(p[..., 3:], o) for p, o in zip(pairs, out)])
    assert res["n_images"] == 2
    assert res["psnr_torch"] == pytest.approx(want, rel=1e-6)


def test_pixel_train_step_matches_jax(uparams):
    """One SGD step of ``DiffusionTrainer`` on the pixel domain (through
    the fused ResnetBlock op) against JAX's jitted step, JAX's t and noise
    injected."""
    jcfg = jax_config_from_dict(_raw())
    jstep = jax_train_step.make_train_step(
        jcfg, JaxUNet.from_config(jcfg).apply, donate=False)
    jstate = jax_create_train_state(uparams, jcfg.optim,
                                    jax.random.PRNGKey(1))
    n = 4
    batch = np.random.default_rng(7).random((n, P, P, 6), dtype=np.float32)
    _, key_t, key_e = jax.random.split(jstate.rng, 3)
    t = np.asarray(jax_antithetic(key_t, n, 50))
    e = np.asarray(jax.random.normal(key_e, (n, P, P, 3), jnp.float32))
    jstate, jm = jstep(jstate, jnp.asarray(batch))

    cfg = config_from_dict(_raw(parallel={"fused_resblock": True}))
    trainer = DiffusionTrainer(cfg, **QUIET)
    trainer.model.load_state_dict(unet_state_dict_from_flax(uparams, 2, 1))
    m = trainer.train_step(
        trainer.state, batch, t=torch.from_numpy(t.copy()),
        e=torch.from_numpy(e.transpose(0, 3, 1, 2).copy()))
    for name in ("loss", "mse_loss", "loss_per_pixel", "grad_norm"):
        got, want = float(getattr(m, name)), float(getattr(jm, name))
        assert abs(got - want) <= 1e-4 * abs(want), name
    want_sd = unet_state_dict_from_flax(jstate.params, 2, 1)
    got_sd = trainer.model.state_dict()
    for k, w in want_sd.items():
        assert float((got_sd[k] - w).abs().max()) <= 1e-4 * float(
            w.abs().max()), k


def test_prepare_pixel_batch_is_the_scaled_pair():
    x = np.random.default_rng(8).random((2, P, P, 6), dtype=np.float32)
    got = prepare_pixel_batch(torch.from_numpy(x), config_from_dict(_raw()))
    assert got.is_contiguous()      # the fused kernel takes no other layout
    want = np.asarray(jax_train_step.prepare_pixel_batch(
        jnp.asarray(x), jax_config_from_dict(_raw())))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               atol=1e-7)


@pytest.mark.parametrize("name, path", [
    ("pixel", "raindrop.yaml"), ("global", "raindrop_wavelet_global.yaml"),
    ("lap", "raindrop_lap.yaml")])
def test_variant_profiles_are_the_shipped_configs(name, path):
    """The built-in profiles, which need no yaml, equal the JAX package's
    YAML files of the three variant paths, field by field."""
    yaml_path = os.path.join(os.path.dirname(__file__), os.pardir,
                             "wavedm_tpu", "configs", path)
    assert dataclasses.asdict(PROFILES[name]()) == dataclasses.asdict(
        load_config(yaml_path))
