"""PyTorch port: the Laplacian-pyramid path (``raindrop_lap.yaml``:
``data.lap``) against the JAX package.

Reduced geometry: 32x32 training crops (the UNet trains on their 8x8
coarse level, two UNet levels), a 64x96 [cond | gt] pair restored over its
16x24 coarse level with 8x8 patches at stride 4 (15 patches), T = 50.
Weights are random, from numpy with a seed, carried across by
``utils/convert.py``; inputs and noise come from numpy or are JAX's own
draws handed to the port.

Tolerances: float32 on both sides, summation order only.  The pyramid is
held to the reference's golden within 1e-5 and to JAX within 1e-6, module
outputs to 1e-5 of their scale, a restore to 1e-4 absolute (images in
[0, 1]).  After one step the losses agree to 1e-4 relative, the UNet's
SGD-stepped parameters and the translator's Adam moments to 1e-4 of each
tensor's scale.  The translator's parameters take Adam's first step, about
+-lr for every element whatever its gradient, so an element whose gradient
is float noise may step either way: at most one in a thousand elements of
a tensor (at least one) may miss the 1e-4 bound, none by more than 10 lr
(``tests/test_torch_training.py`` holds Adam the same way).
"""

import copy
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from wavedm_tpu.config import config_from_dict as jax_config_from_dict
from wavedm_tpu.diffusion.loss import antithetic_timesteps as jax_antithetic
from wavedm_tpu.inference.restoration import \
    DiffusiveRestoration as JaxRestoration
from wavedm_tpu.models.laplacian import LapHighTrans as JaxLapHighTrans
from wavedm_tpu.models.laplacian import \
    LaplacianPyramid as JaxLaplacianPyramid
from wavedm_tpu.models.unet import DiffusionUNet as JaxUNet
from wavedm_tpu.training import lap as jax_lap
from wavedm_tpu.training import train_step as jax_train_step
from wavedm_tpu.training.state import \
    create_train_state as jax_create_train_state
from wavedm_tpu.utils.checkpoint import save_checkpoint as jax_save

from wavedm_tpu_torch.cli import restore as restore_cli
from wavedm_tpu_torch.config import config_from_dict
from wavedm_tpu_torch.inference.loader import build_restorer
from wavedm_tpu_torch.inference.server import RestorationServer
from wavedm_tpu_torch.models.laplacian import LapHighTrans, LaplacianPyramid
from wavedm_tpu_torch.training import lap
from wavedm_tpu_torch.training.trainer import DiffusionTrainer
from wavedm_tpu_torch.utils import metrics as M
from wavedm_tpu_torch.utils.convert import (lap_state_dict_from_flax,
                                            unet_state_dict_from_flax)
from wavedm_tpu_torch.utils.initializers import apply_weights_init
from wavedm_tpu_torch.utils.orbax_convert import convert_orbax_checkpoint

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
H, W, P = 64, 96, 8
SEED = 3
RAW = {
    "data": {"image_size": P, "patch_size": 32, "wavelet": False,
             "lap": True},
    "model": {"in_channels": 3, "use_other_channels": False,
              "other_channels_begin": 0, "use_gt_in_train": False,
              "ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1,
              "attn_resolutions": [4]},
    "diffusion": {"num_diffusion_timesteps": 50},
    "sampling": {"sampling_timesteps": 3, "grid_r": 4},
    "training": {"seed": SEED, "patch_n": 4, "n_epochs": 10},
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
def uparams():
    jcfg = jax_config_from_dict(_raw())
    shapes = jax.eval_shape(JaxUNet.from_config(jcfg).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, P, P, 6)),
                            jnp.zeros((1,)))
    return random_params(shapes["params"], 0)


def _jax_lap_state(seed):
    model = jax_lap.make_lap_model()
    pyr = [jnp.zeros((1, 32 // 2 ** i, 32 // 2 ** i, 3))
           for i in range(jax_lap.LAP_NUM_HIGH + 1)]
    params = random_params(jax.eval_shape(model.init, jax.random.PRNGKey(0),
                                          pyr)["params"], seed)
    opt_state = jax_lap.make_lap_optimizer().init(params)
    return jax_lap.LapState(params=params, opt_state=opt_state)


# ------------------------------------------------------------------ modules


def test_pyramid_matches_the_golden():
    """The reference's pyramid (3 high bands of a 40x56 image, odd sizes
    from 10x14 down) and its reconstruction."""
    data = np.load(os.path.join(GOLDEN, "lap_small.npz"))
    pyr = LaplacianPyramid(3).decompose(torch.from_numpy(data["x"]))
    for i in range(4):
        np.testing.assert_allclose(pyr[i].numpy(), data[f"pyr{i}"],
                                   atol=1e-5, rtol=1e-4, err_msg=f"level {i}")
    np.testing.assert_allclose(LaplacianPyramid(3).reconstruct(pyr).numpy(),
                               data["rec"], atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("hw", [(32, 48), (37, 53)], ids=["even", "odd"])
def test_pyramid_matches_jax(hw):
    """Odd sizes take the nearest resize at half-pixel centres."""
    x = np.random.default_rng(1).uniform(-1, 1, (2, *hw, 6)).astype(
        np.float32)
    want = JaxLaplacianPyramid(2).decompose(jnp.asarray(x))
    got = LaplacianPyramid(2).decompose(nchw(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=1e-6)
    rec = LaplacianPyramid(2).reconstruct(got)
    np.testing.assert_allclose(nhwc(rec), x, atol=1e-5)


def test_lap_high_trans_matches_jax():
    x = np.random.default_rng(2).uniform(-1, 1, (2, 37, 53, 3)).astype(
        np.float32)
    pyr = JaxLaplacianPyramid(2).decompose(jnp.asarray(x))
    jm = JaxLapHighTrans(res_num=3, res_dim=32, num_high=2)
    params = random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                          pyr)["params"], 3)
    want = jax.jit(jm.apply)({"params": params}, pyr)
    tm = lap.make_lap_model()
    tm.load_state_dict(lap_state_dict_from_flax(params))
    with torch.no_grad():
        got = tm([nchw(p) for p in pyr])
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(nhwc(g), w, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("epoch", [0, 1, 25, 99, 100])
def test_lap_lr_for_epoch_matches_jax(epoch):
    got = lap.lap_lr_for_epoch(epoch, 100)
    assert got == jax_lap.lap_lr_for_epoch(epoch, 100)
    assert got == pytest.approx(2e-4 * (1 + math.cos(math.pi * epoch / 100))
                                / 2)


def test_kaiming_init_draws_fan_in_normals():
    model = apply_weights_init(LapHighTrans(3, 32, 2), "kaiming",
                               torch.Generator().manual_seed(0))
    w = model.trans_high.res_0.conv1.weight.detach()   # (32, 64, 3, 3)
    assert float(w.std()) == pytest.approx(math.sqrt(2 / (64 * 9)), rel=0.05)
    assert all(float(m.bias.abs().max()) == 0.0 for m in model.modules()
               if isinstance(m, torch.nn.Conv2d))
    with pytest.raises(NotImplementedError, match="kaiming"):
        apply_weights_init(model, "orthogonal", torch.Generator())


# ------------------------------------------------------------------ train


def _adam_moments(opt_state):
    for s in opt_state:
        if isinstance(s, optax.ScaleByAdamState):
            return s
    raise AssertionError(f"no Adam state in {opt_state}")


def test_lap_train_step_matches_jax(uparams):
    """One step of ``DiffusionTrainer`` on the Laplacian domain (through
    the fused ResnetBlock op): the translator's Adam step on the summed
    per-level MSEs and the UNet's SGD step on the coarse level, against
    JAX's jitted step, JAX's t and noise injected."""
    jcfg = jax_config_from_dict(_raw())
    jstep = jax_train_step.make_train_step(
        jcfg, JaxUNet.from_config(jcfg).apply, donate=False)
    jstate = jax_create_train_state(uparams, jcfg.optim,
                                    jax.random.PRNGKey(1))
    jlap = _jax_lap_state(4)
    lap_lr = jax_lap.lap_lr_for_epoch(0, 10)
    n = 4
    batch = np.random.default_rng(5).random((n, 32, 32, 6), dtype=np.float32)
    _, key_t, key_e = jax.random.split(jstate.rng, 3)
    t = np.array(jax_antithetic(key_t, n, 50))
    e = np.asarray(jax.random.normal(key_e, (n, P, P, 3), jnp.float32))
    jstate2, jlap2, jm = jstep(jstate, jlap, jnp.asarray(batch), lap_lr)

    cfg = config_from_dict(_raw(parallel={"fused_resblock": True}))
    trainer = DiffusionTrainer(cfg, **QUIET)
    trainer.model.load_state_dict(unet_state_dict_from_flax(uparams, 2, 1))
    trainer.lap_state.model.load_state_dict(
        lap_state_dict_from_flax(jlap.params))
    m = trainer.train_step(trainer.state, trainer.lap_state, batch,
                           lap.lap_lr_for_epoch(0, 10),
                           t=torch.from_numpy(t), e=nchw(e))
    for name in ("loss", "mse_loss", "loss_per_pixel", "grad_norm",
                 "loss_trans"):
        got, want = float(getattr(m, name)), float(getattr(jm, name))
        assert abs(got - want) <= 1e-4 * abs(want), name
    # JAX's quirk, kept: the 8x8-level loss over the 8x8 config image size
    assert float(m.loss_per_pixel) == pytest.approx(float(m.loss) / (3 * 64))

    got_sd = trainer.model.state_dict()
    for k, w in unet_state_dict_from_flax(jstate2.params, 2, 1).items():
        assert float((got_sd[k] - w).abs().max()) <= 1e-4 * float(
            w.abs().max()), k
    tm, opt = trainer.lap_state.model, trainer.lap_state.optimizer
    named = dict(tm.named_parameters())
    adam = _adam_moments(jlap2.opt_state)
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        for k, w in lap_state_dict_from_flax(tree).items():
            got = opt.state[named[k]][key]
            assert float((got - w).abs().max()) <= 1e-4 * float(
                w.abs().max()), (key, k)
    for k, w in lap_state_dict_from_flax(jlap2.params).items():
        diff = (named[k].detach() - w).abs()
        bad = diff > 1e-4 * float(w.abs().max())
        assert int(bad.sum()) <= max(1, w.numel() // 1000), k
        assert float(diff.max()) <= 10 * lap_lr, k


def test_lap_checkpoint_round_trip(tmp_path):
    """The translator's parameters and Adam moments are saved beside the
    UNet state and restored; the resumed run takes the same next step."""
    cfg = config_from_dict(_raw())
    trainer = DiffusionTrainer(cfg, **QUIET)
    batch = np.random.default_rng(6).random((4, 32, 32, 6), dtype=np.float32)
    trainer.fit(lambda epoch: [batch, batch], max_steps=2)
    path = trainer.save(str(tmp_path / "lap"))
    resumed = DiffusionTrainer(cfg, **QUIET)
    resumed.resume(path)
    for a, b in ((trainer.lap_state, resumed.lap_state),):
        for k, v in a.model.state_dict().items():
            assert torch.equal(v, b.model.state_dict()[k]), k
        sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
        assert sa["param_groups"] == sb["param_groups"]
        for i, s in sa["state"].items():
            assert all(torch.equal(v, sb["state"][i][k])
                       for k, v in s.items())
    m1 = trainer.train_step(trainer.state, trainer.lap_state, batch, 1e-4)
    m2 = resumed.train_step(resumed.state, resumed.lap_state, batch, 1e-4)
    assert float(m1.loss) == float(m2.loss)
    assert float(m1.loss_trans) == float(m2.loss_trans)


def test_orbax_lap_checkpoint_converts(uparams, tmp_path):
    """A JAX lap checkpoint (the translator as its ``lap`` extra tree, Adam
    moments non-zero after one step) converts, and the port's trainer
    resumes the translator from it exactly."""
    jcfg = jax_config_from_dict(_raw())
    jstep = jax_train_step.make_train_step(
        jcfg, JaxUNet.from_config(jcfg).apply, donate=False)
    jstate = jax_create_train_state(uparams, jcfg.optim,
                                    jax.random.PRNGKey(1))
    batch = np.random.default_rng(7).random((4, 32, 32, 6), dtype=np.float32)
    jstate, jlap, _ = jstep(jstate, _jax_lap_state(8), jnp.asarray(batch),
                            2e-4)
    src = str(tmp_path / "jax_lap")
    jax_save(src, jstate, epoch=1, extra_arrays={"lap": jlap})
    cfg = config_from_dict(_raw())
    info = convert_orbax_checkpoint(src, str(tmp_path / "port"), cfg)
    trainer = DiffusionTrainer(cfg, **QUIET)
    trainer.resume(info["path"])
    named = dict(trainer.lap_state.model.named_parameters())
    for k, w in lap_state_dict_from_flax(jlap.params).items():
        assert torch.equal(named[k].detach(), w), k
    adam = _adam_moments(jlap.opt_state)
    state = trainer.lap_state.optimizer.state
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        for k, w in lap_state_dict_from_flax(tree).items():
            assert torch.equal(state[named[k]][key], w), (key, k)
            assert float(state[named[k]]["step"]) == 1.0
    with pytest.raises(ValueError, match="data.lap"):
        convert_orbax_checkpoint(src, str(tmp_path / "no"), config_from_dict(
            _raw(data={"lap": False, "image_size": 32})))


# ------------------------------------------------------------------ restore


@pytest.fixture(scope="module")
def pairs():
    return np.random.default_rng(9).random((2, H, W, 6), dtype=np.float32)


@pytest.fixture(scope="module")
def jax_restore(uparams, pairs):
    jcfg = jax_config_from_dict(_raw())
    jrest = JaxRestoration(jcfg, JaxUNet.from_config(jcfg).apply, uparams)
    out, aux = jrest.restore_image(pairs, jax.random.PRNGKey(SEED))
    key_init, _ = jax.random.split(jax.random.PRNGKey(SEED))
    noise = np.asarray(jax.random.normal(key_init, (2, H // 4, W // 4, 3),
                                         jnp.float32))
    return out, np.asarray(aux), noise


@pytest.mark.parametrize("route", ["plain", "fused_groupnorm"])
def test_lap_restore_matches_jax(uparams, pairs, jax_restore, route):
    """The coarse-level chain and the reconstruction from the degraded high
    bands and the ground truth's low band."""
    want, want_aux, noise = jax_restore
    parallel = {} if route == "plain" else {route: True}
    rest = build_restorer(config_from_dict(_raw(parallel=parallel)),
                          unet_state_dict_from_flax(uparams, 2, 1),
                          device="cpu")
    assert rest.hfrm is None
    out, aux = rest.restore_image_device(pairs, noise=nchw(noise))
    assert out.shape == (2, H, W, 3)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(aux.numpy(), want_aux)


def test_restore_scores_the_whole_pairs(uparams, pairs):
    rest = build_restorer(config_from_dict(_raw()),
                          unet_state_dict_from_flax(uparams, 2, 1),
                          device="cpu")
    res = rest.restore([(p, f"p{i}") for i, p in enumerate(pairs)],
                       eval_batch=2)
    out, _ = rest.restore_image(pairs)            # the same seeded draw
    want = np.mean([M.psnr_torch(p[..., 3:], o) for p, o in zip(pairs, out)])
    assert res["psnr_torch"] == pytest.approx(want, rel=1e-6)


def test_a_lone_image_is_refused(uparams, pairs, tmp_path):
    """The Laplacian path needs the [cond | gt] pair: a 3-channel image, the
    restore CLI and the server raise, naming the reason."""
    rest = build_restorer(config_from_dict(_raw()), None, device="cpu")
    with pytest.raises(ValueError, match="6-channel"):
        rest.restore_image(pairs[..., :3])
    with pytest.raises(ValueError, match="ground truth"):
        RestorationServer(rest, batch=1)
    config = os.path.join(os.path.dirname(GOLDEN), os.pardir, "wavedm_tpu",
                          "configs", "raindrop_lap.yaml")
    with pytest.raises(ValueError, match="ground truth"):
        restore_cli.main(["--config", config, "--device", "cpu", "--input",
                          str(tmp_path), "--out", str(tmp_path / "out")])
