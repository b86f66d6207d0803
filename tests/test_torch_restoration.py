"""PyTorch port: the whole restoration slice against the JAX
``DiffusiveRestoration``, with ``parallel.fused_groupnorm: true`` (the Pallas
GroupNorm runs in the interpreter here; the port's wrapper runs its plain
version on the CPU).

Reduced geometry of tests/test_reference_chain_parity.py: 64x96 pixels ->
16x24 wavelet grid, 8x8 patches at stride 4 (15 patches), T = 50, small
UNet and HFRM, two images as one 30-patch batch.  Both sides get the same
weights (carried across by utils/convert.py) and the same x_T: JAX's own
draw, reproduced here as its ``prep`` makes it, handed to the port as
``noise=``.

Tolerances: in float32 (both profiles) the two sides differ only by
summation order (~1e-6 per UNet pass), which the chain carries to ~1e-5:
held to 1e-4.  The production profile as shipped runs the networks in
bfloat16, where the two frameworks round activations at slightly different
points; with random weights that noise reaches ~0.1 on both sides, so the port's
gap to JAX is held to twice JAX's own bfloat16-vs-float32 gap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavedm_tpu.config import config_from_dict as jax_config_from_dict
from wavedm_tpu.inference.restoration import \
    DiffusiveRestoration as JaxRestoration
from wavedm_tpu.models.hfrm import HFRM as JaxHFRM
from wavedm_tpu.models.unet import DiffusionUNet as JaxUNet

from wavedm_tpu_torch.config import config_from_dict
from wavedm_tpu_torch.inference.loader import build_hfrm, build_unet
from wavedm_tpu_torch.inference.restoration import DiffusiveRestoration
from wavedm_tpu_torch.utils.convert import (hfrm_state_dict_from_flax,
                                            unet_state_dict_from_flax)

H, W, P = 64, 96, 8
SEED = 3


def _raw(profile):
    raw = {
        "data": {"image_size": P, "patch_size": 4 * P},
        "model": {"ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1,
                  "attn_resolutions": [4]},
        "diffusion": {"num_diffusion_timesteps": 50},
        "hfrm": {"dim": 8, "enc_blk_nums": [1, 1], "middle_blk_num": 1,
                 "dec_blk_nums": [1, 1]},
        "training": {"seed": SEED},
        "parallel": {"fused_groupnorm": True},
    }
    if profile == "reference":
        raw["sampling"] = {"sampling_timesteps": 10, "grid_r": 4,
                           "x0_pred_index": -5}
    else:
        raw["sampling"] = {"sampling_timesteps": 10, "grid_r": 4,
                           "t_start": 30, "init_ll": "hfrm",
                           "x0_pred_index": -1}
        raw["parallel"]["compute_dtype"] = "bfloat16"
    return raw


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_config_from_dict(_raw("reference"))
    unet = JaxUNet.from_config(jcfg)
    uparams = jax.jit(unet.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, P, P, 96)),
                                 jnp.zeros((1,)))["params"]
    hfrm = JaxHFRM.from_config(jcfg)
    hparams = jax.jit(hfrm.init)(jax.random.PRNGKey(1),
                                 jnp.zeros((1, H, W, 3)))["params"]
    rng = np.random.default_rng(4)
    hparams = jax.tree_util.tree_map_with_path(
        lambda path, v: jnp.asarray(0.5 * rng.standard_normal(v.shape), v.dtype)
        if path[-1].key in ("beta", "gamma") else v, hparams)
    return uparams, hparams


def _jax_noise(b):
    key_init, _ = jax.random.split(jax.random.PRNGKey(SEED))
    return np.asarray(jax.random.normal(key_init, (b, H // 4, W // 4, 3),
                                        jnp.float32))


@pytest.fixture(scope="module")
def runs(weights):
    """(profile, dtype) -> (jax out, jax hfrm, port out, port hfrm)."""
    uparams, hparams = weights
    cond = np.random.default_rng(5).random((2, H, W, 3)).astype(np.float32)
    noise = torch.from_numpy(_jax_noise(2).transpose(0, 3, 1, 2).copy())
    cache = {}

    def run(profile, dtype):
        if (profile, dtype) not in cache:
            raw = _raw(profile)
            raw["parallel"]["compute_dtype"] = dtype
            jcfg = jax_config_from_dict(raw)
            jrest = JaxRestoration(jcfg, JaxUNet.from_config(jcfg).apply,
                                   uparams, JaxHFRM.from_config(jcfg).apply,
                                   hparams)
            ref, ref_hfrm = jrest.restore_image(cond,
                                                jax.random.PRNGKey(SEED))
            cfg = config_from_dict(raw)
            rest = DiffusiveRestoration(
                cfg,
                build_unet(cfg, unet_state_dict_from_flax(uparams, 2, 1),
                           "cpu"),
                build_hfrm(cfg, hfrm_state_dict_from_flax(hparams, (1, 1), 1,
                                                          (1, 1)), "cpu"),
                device="cpu")
            out, out_hfrm = rest.restore_image(cond, noise=noise)
            assert out.shape == (2, H, W, 3) and np.isfinite(out).all()
            assert out.min() >= 0.0 and out.max() <= 1.0
            cache[(profile, dtype)] = (ref, np.asarray(ref_hfrm), out,
                                       out_hfrm.numpy())
        return cache[(profile, dtype)]

    return run


@pytest.mark.parametrize("profile", ["reference", "production"])
def test_restoration_matches_jax_f32(runs, profile):
    ref, ref_hfrm, out, out_hfrm = runs(profile, "float32")
    np.testing.assert_allclose(out_hfrm, ref_hfrm, atol=1e-4)
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_production_profile_bf16_matches_jax(runs):
    """The production profile as shipped (bfloat16): the port's gap to JAX
    is held to twice JAX's own bfloat16-vs-float32 gap, the rounding noise
    bfloat16 brings to this network (two independent roundings of the same
    float32 result differ by at most the sum of their errors)."""
    ref32, ref32_hfrm, _, _ = runs("production", "float32")
    ref, ref_hfrm, out, out_hfrm = runs("production", "bfloat16")
    for ours, theirs, exact in ((out, ref, ref32),
                                (out_hfrm, ref_hfrm, ref32_hfrm)):
        noise = float(np.abs(theirs - exact).max())
        assert 0 < noise < 0.5
        assert float(np.abs(ours - theirs).max()) <= 2 * noise


def test_batch_equals_single_images(weights):
    """B images as one B*K patch batch give each image's own restoration."""
    cfg = config_from_dict(_raw("reference"))
    uparams, hparams = weights
    rest = DiffusiveRestoration(
        cfg, build_unet(cfg, unet_state_dict_from_flax(uparams, 2, 1), "cpu"),
        build_hfrm(cfg, hfrm_state_dict_from_flax(hparams, (1, 1), 1, (1, 1)),
                   "cpu"), device="cpu")
    cond = np.random.default_rng(6).random((2, H, W, 3)).astype(np.float32)
    noise = torch.randn(2, 3, H // 4, W // 4,
                        generator=torch.Generator().manual_seed(0))
    both, _ = rest.restore_image(cond, noise=noise)
    for i in range(2):
        one, _ = rest.restore_image(cond[i], noise=noise[i:i + 1])
        np.testing.assert_allclose(one[0], both[i], atol=1e-5)


def test_default_noise_comes_from_the_seed(weights):
    cfg = config_from_dict(_raw("production"))
    rest = DiffusiveRestoration(cfg, build_unet(cfg, None, "cpu"),
                                build_hfrm(cfg, None, "cpu"), device="cpu")
    cond = np.random.default_rng(7).random((H, W, 3)).astype(np.float32)
    a, _ = rest.restore_image(cond)
    b, _ = rest.restore_image(cond)
    c, _ = rest.restore_image(cond,
                              generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 0
