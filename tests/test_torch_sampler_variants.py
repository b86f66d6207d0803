"""PyTorch port: the rest of the sampler against the JAX package --
DPM-Solver++(2M), eta > 0, v-prediction, patch micro-batches, and the
whole-image chain.

The chains with a UNet run both sides in float32 from the same x_T and the
same weights (carried across by utils/convert.py), as
tests/test_torch_sampling.py does, and are held to the same 1e-4.  JAX and
torch draw different random numbers, so at eta > 0 JAX's own per-image
draws are reproduced here (its key path, step by step) and handed to the
port as ``step_noise``.  The algebraic checks mirror tests/test_dpmpp.py,
tests/test_v_prediction.py and tests/test_truncated_sampling.py on the
port alone, with their tolerances.
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

H, W, P, R = 16, 24, 8, 4
SEQ = np.arange(0, 50, 5)
BETAS50 = np.linspace(1e-4, 2e-2, 50).astype(np.float32)
BETAS = torch.as_tensor(schedules.get_beta_schedule(
    "linear", beta_start=1e-4, beta_end=0.02, num_diffusion_timesteps=1000),
    dtype=torch.float32)
UNET_KW = dict(out_ch=3, ch=32, ch_mult=(1, 2), num_res_blocks=1,
               attn_resolutions=(4,), resolution=8)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread here: the suite runs several pytest-xdist
    workers on a few cores, where these small ops on a thread per core in
    every worker run ~100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.numpy().transpose(*range(t.dim() - 3), -2, -1, -3)


def test_compute_alpha_matches_jax():
    t = np.array([-1, 0, 7, 499, 999])
    ours = schedules.compute_alpha(BETAS, torch.as_tensor(t))
    ref = jax_schedules.compute_alpha(jnp.asarray(BETAS.numpy()),
                                      jnp.asarray(t))
    assert float(ours[0]) == 1.0
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=2e-6)


@pytest.mark.parametrize("seq", [schedules.ddim_timesteps(1000, 8),
                                 np.arange(0, 300, 30), np.array([0, 500])],
                         ids=["ddim8", "truncated10", "two_steps"])
def test_dpmpp2m_coeffs_match_jax(seq):
    ours = sampling._dpmpp2m_coeffs(BETAS, seq)
    ref = jax_sampling._dpmpp2m_coeffs(jnp.asarray(BETAS.numpy()), seq)
    for a, b in zip(ours, ref):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)
    em1, c2 = ours[4], ours[5]
    assert float(em1[-1]) == -1.0 and float(c2[0]) == float(c2[-1]) == 0.0


@pytest.fixture(scope="module")
def unet96():
    """A small 96-channel-input UNet in both frameworks, same weights."""
    jmodel = JaxUNet(in_channels=96, **UNET_KW)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, P, P, 96)),
                                  jnp.zeros((1,)))["params"]
    model = DiffusionUNet(in_channels=96, **UNET_KW).eval()
    model.load_state_dict(unet_state_dict_from_flax(params, 2, 1))
    return jmodel, params, model


def _jax_tiled_step_noise(rng, n_steps, b, shape):
    """The per-step, per-image draws of JAX's tiled sampler at eta > 0, as
    (T, B, C, H, W): each step splits the carried key, then one subkey per
    image."""
    key, out = rng, []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        draws = [jax.random.normal(k, shape, jnp.float32)
                 for k in jax.random.split(sub, b)]
        out.append(np.stack([np.asarray(d) for d in draws]))
    return nchw(np.stack(out).reshape((-1,) + shape)).reshape(
        (n_steps, b, shape[-1], shape[0], shape[1]))


@pytest.mark.parametrize("variant", [
    dict(solver="dpmpp2m"), dict(pred_type="v"), dict(eta=0.5),
    dict(patch_micro_batch=4),
], ids=["dpmpp2m", "v", "eta0.5", "micro_batch4"])
def test_tiled_variant_matches_jax(unet96, variant):
    """2 images, 15 patches each: the 30-patch batch in chunks of 4 leaves
    a short last chunk of 2."""
    jmodel, params, model = unet96
    rng = np.random.default_rng(0)
    x_t = rng.standard_normal((2, H, W, 3)).astype(np.float32)
    cond = rng.uniform(-1, 1, (2, H, W, 48)).astype(np.float32)
    other = rng.uniform(-1, 1, (2, H, W, 45)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    geom = dict(image_shape=(H, W), patch_size=P, grid_r=R, seq=SEQ,
                pred_channels=3, use_other=True, **variant)
    jsample = jax_sampling.make_overlapping_sampler(
        lambda prm, x, t: jmodel.apply({"params": prm}, x, t),
        betas=jnp.asarray(BETAS50), **geom)
    jf, jx0 = jsample(jnp.asarray(x_t), jnp.asarray(cond),
                      jnp.asarray(other), key, params=params)

    calls = []
    model_fn = lambda x, t: calls.append(x.shape[0]) or model(x, t)
    sample = sampling.make_overlapping_sampler(
        model_fn, betas=torch.from_numpy(BETAS50), **geom)
    step_noise = (_jax_tiled_step_noise(key, len(SEQ), 2, (H, W, 3))
                  if variant.get("eta") else None)
    xf, x0 = sample(nchw(x_t), nchw(cond), nchw(other),
                    step_noise=step_noise)

    mb = variant.get("patch_micro_batch")
    assert calls[:8] == ([4] * 7 + [2] if mb else [30] * 8)
    np.testing.assert_allclose(nhwc(xf), np.asarray(jf), atol=1e-4)
    np.testing.assert_allclose(nhwc(x0), np.asarray(jx0), atol=1e-4)


@pytest.fixture(scope="module")
def unet6():
    """The same small UNet taking [cond(3) | x_t(3)]."""
    jmodel = JaxUNet(in_channels=6, **UNET_KW)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(1),
                                  jnp.zeros((1, P, P, 6)),
                                  jnp.zeros((1,)))["params"]
    model = DiffusionUNet(in_channels=6, **UNET_KW).eval()
    model.load_state_dict(unet_state_dict_from_flax(params, 2, 1))
    return jmodel, params, model


@pytest.mark.parametrize("variant", [
    dict(), dict(solver="dpmpp2m"), dict(pred_type="v"),
], ids=["ddim", "dpmpp2m", "v"])
def test_whole_image_chain_matches_jax(unet6, variant):
    """ddim_sample over whole 16x24 images."""
    jmodel, params, model = unet6
    rng = np.random.default_rng(1)
    x_t = rng.standard_normal((2, H, W, 3)).astype(np.float32)
    cond = rng.uniform(-1, 1, (2, H, W, 3)).astype(np.float32)
    jf, jx0 = jax_sampling.ddim_sample(
        lambda xx, tt: jmodel.apply({"params": params}, xx, tt),
        jnp.asarray(x_t), jnp.asarray(cond), SEQ, jnp.asarray(BETAS50),
        **variant)
    xf, x0 = sampling.ddim_sample(model, nchw(x_t), nchw(cond), SEQ,
                                  torch.from_numpy(BETAS50), **variant)
    assert x0.shape == (len(SEQ), 2, 3, H, W)
    np.testing.assert_allclose(nhwc(xf), np.asarray(jf), atol=1e-4)
    np.testing.assert_allclose(nhwc(x0), np.asarray(jx0), atol=1e-4)


def _linear_model(x, t):
    """Per-pixel affine in x: [cond(2) | x_t(2)] -> (N, 2, H, W)."""
    return 0.1 * x[:, :2] + 0.01 * x[:, 2:4] + 0.001 * t[:, None, None, None]


def _v_of_eps(model):
    """The v-model algebraically equivalent to an eps-model:
    v = (e - sqrt(1-a) x_t) / sqrt(a)."""
    def v_model(x, t):
        a = schedules.compute_alpha(BETAS, t.long())[:, None, None, None]
        return (model(x, t) - torch.sqrt(1 - a) * x[:, 2:4]) / torch.sqrt(a)
    return v_model


def _inputs(seed, h=8, w=8, b=1):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, 2, h, w, generator=g),
            torch.randn(b, 2, h, w, generator=g))


def test_second_order_beats_ddim_at_few_steps():
    """eps exact for the smooth data prediction x0(x) = X0 + 0.3 tanh(x):
    the only error is the solver's.  Against DDIM at 800 steps (the same
    ODE, near exact), dpmpp2m at 12 steps lands much closer than DDIM at
    12 (JAX measured 0.021 vs 0.065)."""
    x, cond = _inputs(1)
    target = _inputs(2)[0] * 0.5

    def model(xx, tt):
        a = schedules.compute_alpha(BETAS, tt.long())[:, None, None, None]
        x0 = target + 0.3 * torch.tanh(xx[:, 2:4])
        return (xx[:, 2:4] - torch.sqrt(a) * x0) / torch.sqrt(1 - a)

    exact, _ = sampling.ddim_sample(model, x, cond,
                                    schedules.ddim_timesteps(1000, 800), BETAS)
    seq12 = schedules.ddim_timesteps(1000, 12)
    dd12, _ = sampling.ddim_sample(model, x, cond, seq12, BETAS)
    dp12, _ = sampling.ddim_sample(model, x, cond, seq12, BETAS,
                                   solver="dpmpp2m")
    err_dd = float((dd12 - exact).abs().max())
    err_dp = float((dp12 - exact).abs().max())
    assert err_dp < err_dd / 2, (err_dp, err_dd)


@pytest.mark.parametrize("solver", ["ddim", "dpmpp2m"])
def test_tiled_matches_whole_image_for_affine_model(solver):
    """Overlap averaging is exact for a per-pixel affine model."""
    x, cond = _inputs(3, H, W)
    seq = schedules.ddim_timesteps(1000, 6)
    s = sampling.make_overlapping_sampler(
        _linear_model, image_shape=(H, W), patch_size=P, grid_r=R, seq=seq,
        betas=BETAS, pred_channels=2, solver=solver)
    xf_t, x0_t = s(x, cond)
    xf_w, x0_w = sampling.ddim_sample(_linear_model, x, cond, seq, BETAS,
                                      solver=solver)
    torch.testing.assert_close(xf_t, xf_w, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(x0_t, x0_w, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("tiled", [False, True], ids=["whole", "tiled"])
@pytest.mark.parametrize("solver", ["ddim", "dpmpp2m"])
def test_chain_invariant_under_v_reparameterization(solver, tiled):
    """The v-model equivalent to an eps-model gives the eps trajectory."""
    x, cond = _inputs(4, H, W)
    seq = schedules.ddim_timesteps(1000, 6)
    if tiled:
        run = lambda fn, **kw: sampling.make_overlapping_sampler(
            fn, image_shape=(H, W), patch_size=P, grid_r=R, seq=seq,
            betas=BETAS, pred_channels=2, solver=solver, **kw)(x, cond)
    else:
        run = lambda fn, **kw: sampling.ddim_sample(
            fn, x, cond, seq, BETAS, solver=solver, **kw)
    xf_e, x0_e = run(_linear_model)
    xf_v, x0_v = run(_v_of_eps(_linear_model), pred_type="v")
    torch.testing.assert_close(xf_v, xf_e, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(x0_v, x0_e, atol=1e-4, rtol=1e-4)


def test_micro_batches_equal_one_batch():
    x, cond = _inputs(5, H, W, b=2)
    seq = schedules.ddim_timesteps(1000, 4)
    out = [sampling.make_overlapping_sampler(
        _linear_model, image_shape=(H, W), patch_size=P, grid_r=R, seq=seq,
        betas=BETAS, pred_channels=2, patch_micro_batch=mb)(x, cond)[0]
        for mb in (0, 7, 64)]
    torch.testing.assert_close(out[1], out[0], atol=1e-6, rtol=0)
    torch.testing.assert_close(out[2], out[0], atol=1e-6, rtol=0)


def test_truncated_chain_recovers_its_target():
    """A perfect model on a truncated [0, 300) chain started from the
    noised target brings it back (tests/test_truncated_sampling.py)."""
    h, w = 24, 32
    g = torch.Generator().manual_seed(3)
    x_tar = torch.randn(1, 2, h, w, generator=g) * 2
    seq = np.arange(0, 300, 30, dtype=np.int32)

    def perfect_model(x, t):
        a = schedules.compute_alpha(BETAS, t.long())[:, None, None, None]
        return (x[:, 2:4] - torch.sqrt(a) * x[:, :2]) / torch.sqrt(1 - a)

    sampler = sampling.make_overlapping_sampler(
        perfect_model, image_shape=(h, w), patch_size=16, grid_r=8, seq=seq,
        betas=BETAS, pred_channels=2)
    a_s = float(schedules.compute_alpha(BETAS, [int(seq[-1])])[0])
    noise = torch.randn(x_tar.shape, generator=g)
    xf, _ = sampler(x_tar * a_s ** 0.5 + noise * (1 - a_s) ** 0.5, x_tar)
    torch.testing.assert_close(xf, x_tar, atol=5e-3, rtol=1e-3)


def test_eta_noise_comes_from_the_generator():
    """eta > 0: the same generator seed gives the same chain, another seed
    another; an injected step_noise must have the chain's shape."""
    x, cond = _inputs(6, H, W, b=2)
    seq = schedules.ddim_timesteps(1000, 4)
    s = sampling.make_overlapping_sampler(
        _linear_model, image_shape=(H, W), patch_size=P, grid_r=R, seq=seq,
        betas=BETAS, pred_channels=2, eta=0.5)
    a = s(x, cond, generator=torch.Generator().manual_seed(1))[0]
    b = s(x, cond, generator=torch.Generator().manual_seed(1))[0]
    c = s(x, cond, generator=torch.Generator().manual_seed(2))[0]
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert float((a - c).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="step_noise"):
        s(x, cond, step_noise=torch.zeros(3, 2, 2, H, W))
