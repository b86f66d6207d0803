"""PyTorch port: schedules, DDIM constants, the patch grid and the tiled
sampler against the JAX package.

The sampler comparison runs both chains in float32 from the same x_T and
the same weights (carried across by utils/convert.py).  Ten steps over
T = 50 divide by sqrt(alpha_bar) down to ~0.37, so the float32 round-off of
the two UNets (~1e-6, tests/test_torch_models.py) grows to ~1e-5; the
chain is held to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavedm_tpu.diffusion import sampling as jax_sampling
from wavedm_tpu.diffusion import schedules as jax_schedules
from wavedm_tpu.models.unet import DiffusionUNet as JaxUNet

from wavedm_tpu_torch.diffusion import sampling, schedules
from wavedm_tpu_torch.models.unet import DiffusionUNet
from wavedm_tpu_torch.utils.convert import unet_state_dict_from_flax


@pytest.mark.parametrize("name", ["linear", "quad", "const", "jsd", "sigmoid"])
def test_beta_schedules_match_jax(name):
    kw = dict(beta_start=1e-4, beta_end=2e-2, num_diffusion_timesteps=1000)
    np.testing.assert_array_equal(schedules.get_beta_schedule(name, **kw),
                                  jax_schedules.get_beta_schedule(name, **kw))


def test_alpha_bars_and_timesteps_match_jax():
    betas = schedules.get_beta_schedule("linear", beta_start=1e-4,
                                        beta_end=2e-2,
                                        num_diffusion_timesteps=1000)
    ab = schedules.alpha_bars(torch.as_tensor(betas, dtype=torch.float32))
    ab_j = jax_schedules.alpha_bars(jnp.asarray(betas, jnp.float32))
    assert ab.dtype == torch.float32 and float(ab[0]) == 1.0
    np.testing.assert_allclose(ab.numpy(), np.asarray(ab_j), rtol=2e-6)
    np.testing.assert_array_equal(schedules.ddim_timesteps(1000, 25),
                                  jax_schedules.ddim_timesteps(1000, 25))
    assert list(schedules.ddim_timesteps(1000, 25)[:3]) == [0, 40, 80]


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_coeffs_match_jax(eta):
    betas = np.linspace(1e-4, 2e-2, 1000)
    seq = np.arange(0, 300, 30)
    ours = sampling._ddim_coeffs(torch.as_tensor(betas, dtype=torch.float32),
                                 seq, eta)
    ref = jax_sampling._ddim_coeffs(jnp.asarray(betas, jnp.float32), seq, eta)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6,
                                   atol=1e-7)


def test_flagship_grid_and_count_mask():
    """720x480 -> a 120x180 wavelet grid holding 45 patches of 64 at
    grid_r 16."""
    corners = sampling.overlapping_grid_corners(120, 180, 64, 16)
    assert corners == jax_sampling.overlapping_grid_corners(120, 180, 64, 16)
    assert len(corners) == 45
    mask = sampling._count_mask(corners, 120, 180, 64)
    np.testing.assert_array_equal(
        mask, jax_sampling._count_mask(corners, 120, 180, 64))
    assert mask.min() >= 1 and mask.sum() == 45 * 64 * 64


UNET_KW = dict(in_channels=96, out_ch=3, ch=32, ch_mult=(1, 2),
               num_res_blocks=1, attn_resolutions=(4,), resolution=8)


@pytest.mark.parametrize("x0_keep", [None, -5])
def test_tiled_sampler_matches_jax(x0_keep):
    h, w, p, r = 16, 24, 8, 4
    seq = np.arange(0, 50, 5)
    betas = np.linspace(1e-4, 2e-2, 50).astype(np.float32)
    jmodel = JaxUNet(**UNET_KW)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, p, p, 96)),
                                  jnp.zeros((1,)))["params"]
    rng = np.random.default_rng(0)
    x_t = rng.standard_normal((2, h, w, 3)).astype(np.float32)
    cond = rng.uniform(-1, 1, (2, h, w, 48)).astype(np.float32)
    other = rng.uniform(-1, 1, (2, h, w, 45)).astype(np.float32)

    geom = dict(image_shape=(h, w), patch_size=p, grid_r=r, seq=seq,
                pred_channels=3, use_other=True, x0_keep=x0_keep)
    jsample = jax_sampling.make_overlapping_sampler(
        lambda prm, x, t: jmodel.apply({"params": prm}, x, t),
        betas=jnp.asarray(betas), **geom)
    jf, jx0 = jsample(jnp.asarray(x_t), jnp.asarray(cond), jnp.asarray(other),
                      params=params)

    model = DiffusionUNet(**UNET_KW).eval()
    model.load_state_dict(unet_state_dict_from_flax(params, 2, 1))
    nchw = lambda a: torch.from_numpy(a.transpose(0, 3, 1, 2).copy())
    sample = sampling.make_overlapping_sampler(
        model, betas=torch.from_numpy(betas), **geom)
    xf, x0 = sample(nchw(x_t), nchw(cond), nchw(other))

    assert x0.shape[0] == (1 if x0_keep is not None else len(seq))
    np.testing.assert_allclose(xf.numpy(),
                               np.asarray(jf).transpose(0, 3, 1, 2), atol=1e-4)
    np.testing.assert_allclose(x0.numpy(),
                               np.asarray(jx0).transpose(0, 1, 4, 2, 3),
                               atol=1e-4)


@pytest.mark.parametrize("option", [
    dict(solver="dpmpp2m", eta=0.5), dict(solver="heun"),
    dict(pred_type="x0"), dict(mesh=object()), dict(patch_micro_batch=-8),
])
def test_unported_options_raise(option):
    """Settings that JAX refuses or cannot run (a stochastic dpmpp2m, an
    unknown solver or parameterization, a negative micro-batch) and a mesh
    that is not the port's ``DataMesh`` raise ValueError (the patch-parallel
    chain itself: ``tests/test_torch_parallel.py``)."""
    with pytest.raises(ValueError):
        sampling.make_overlapping_sampler(
            lambda x, t: x, image_shape=(16, 16), patch_size=8, grid_r=4,
            seq=np.arange(0, 50, 5), betas=torch.linspace(1e-4, 2e-2, 50),
            pred_channels=3, **option)
