"""PyTorch port: stage 1's aux models (TLC pooling, WDNet and its PatchGAN
discriminator, SAM, the VGG19 perceptual loss) and the GAN + perceptual
HFRM step, against the JAX package and the reference goldens.

Both sides get the same weights (random, from numpy with a seed, carried
across by ``utils/convert.py``) and the same inputs.  Tolerances, all in
float32 where the two sides differ by summation order only:
- WDNet and SAM against ``tests/golden/{wdnet,sam}_small.npz``: the JAX
  package's own golden tests' (2e-4 / 1e-3 and 1e-4 / 1e-3), and against
  JAX: 1e-4 of the output's scale;
- TLC pooling: 1e-5 (JAX's test of the same function); HFRM(tlc=...):
  1e-5 of the output's scale;
- VGG19 taps and the discriminator: 1e-4 relative; the perceptual loss:
  1e-4 relative;
- one GAN + perceptual ``HFRMTrainer`` step against JAX's ``gan_step_fn``:
  both losses 1e-4 relative, every parameter of both networks within
  1e-4 of its tensor's scale, except the discriminator's parameters whose
  gradient is float noise (|g| < 1e-6: the biases before its
  InstanceNorms, whose exact gradient is 0, and a few weights), where
  Adam's first step lr * g / (|g| + 1e-8) turns the noise into up to a
  whole step of either sign: there within 2 * lr.  Since that first step
  is about lr * sign(g) whatever |g| is, the step's gradients are also
  held leaf by leaf to JAX's (its first moment mu / (1 - b1)): within
  1e-4 of the leaf's scale plus 1e-6 of the network's largest gradient,
  the floor for those noise leaves.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavedm_tpu.config import config_from_dict as jax_config_from_dict
from wavedm_tpu.models.hfrm import HFRM as JaxHFRM
from wavedm_tpu.models.sam import SAM as JaxSAM
from wavedm_tpu.models.sam import IRNNLayer as JaxIRNN
from wavedm_tpu.models.vgg_loss import VGG19Features as JaxVGG
from wavedm_tpu.models.vgg_loss import perceptual_loss as jax_perceptual
from wavedm_tpu.models.wdnet import RRDB as JaxRRDB
from wavedm_tpu.models.wdnet import Discriminator as JaxDiscriminator
from wavedm_tpu.models.wdnet import SEBlock as JaxSEBlock
from wavedm_tpu.models.wdnet import WDNet as JaxWDNet
from wavedm_tpu.ops.tlc import local_avg_pool as jax_local_avg_pool
from wavedm_tpu.ops.tlc import tlc_kernel as jax_tlc_kernel
from wavedm_tpu.training import hfrm_trainer as jax_hfrm_trainer

from wavedm_tpu_torch.config import config_from_dict
from wavedm_tpu_torch.models.hfrm import HFRM
from wavedm_tpu_torch.models.sam import SAM, IRNNLayer
from wavedm_tpu_torch.models.vgg_loss import (VGG19Features, perceptual_loss,
                                              vgg19_features_state_dict)
from wavedm_tpu_torch.models.wdnet import RRDB, Discriminator, SEBlock, WDNet
from wavedm_tpu_torch.ops.tlc import local_avg_pool, tlc_kernel
from wavedm_tpu_torch.training.hfrm_trainer import HFRMTrainer
from wavedm_tpu_torch.utils.convert import (
    discriminator_state_dict_from_flax, hfrm_state_dict_from_flax,
    rrdb_state_dict_from_flax, sam_state_dict_from_flax,
    vgg19_state_dict_from_flax, wdnet_state_dict_from_flax)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
TINY = {"hfrm": {"dim": 4, "enc_blk_nums": [1, 1], "middle_blk_num": 1,
                 "dec_blk_nums": [1, 1]}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one thread: the suite runs several pytest-xdist workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_params(shapes, seed, scale=0.1):
    """A tree of ``shapes`` filled from numpy: conv and dense kernels
    N(0, 1/fan_in), everything else N(1 or 0, scale^2) (1 for the IRNN
    weights and HFRM's beta/gamma, so their paths matter)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            std, mean = 1.0 / np.sqrt(np.prod(s.shape[:-1])), 0.0
        else:
            std = scale
            mean = float(name.endswith("_weight") or name in ("beta",
                                                              "gamma"))
        return jnp.asarray(mean + std * rng.standard_normal(s.shape),
                           jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _shapes(module, *args):
    return jax.eval_shape(module.init, jax.random.PRNGKey(0),
                          *args)["params"]


def _nhwc(x):
    return jnp.asarray(np.asarray(x).transpose(0, 2, 3, 1))


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


def _golden(name):
    z = np.load(os.path.join(GOLDEN, name))
    sd = {k[4:]: torch.from_numpy(z[k]) for k in z.files
          if k.startswith("sd::")}
    return z, sd


def _close(got, want, rel):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(np.asarray(got) - np.asarray(want)).max()) <= \
        rel * scale


# ------------------------------------------------------------------- TLC


@pytest.mark.parametrize("shape, kernel", [
    ((2, 3, 10, 12), (4, 4)), ((1, 2, 9, 16), (3, 5)),
    ((1, 4, 6, 6), (6, 6)), ((2, 2, 8, 5), (20, 2))],
    ids=["square", "odd", "global", "clipped"])
def test_local_avg_pool_matches_jax(shape, kernel):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = local_avg_pool(torch.from_numpy(x), kernel)
    want = _nchw(jax_local_avg_pool(_nhwc(x), kernel))
    assert tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_tlc_kernel_rule_matches_jax():
    for args in (((480, 720), (256, 256), (256, 256)),
                 ((512, 512), (256, 256), (128, 128)),
                 ((30, 45), (64, 64), (16, 16))):
        assert tlc_kernel(*args) == jax_tlc_kernel(*args)


@pytest.mark.parametrize("size", [16, 32], ids=["train_size", "larger"])
def test_hfrm_tlc_matches_jax(size):
    """HFRM(tlc=((16, 16), (size, size))) at ``size``: global pooling at
    the training size, local windows beyond it, as in JAX."""
    kw = dict(dim=8, mid_blk_num=1, enc_blk_nums=(1, 1), dec_blk_nums=(1, 1))
    tlc = ((16, 16), (size, size))
    jmodel = JaxHFRM(tlc=tlc, **kw)
    params = random_params(_shapes(jmodel, jnp.zeros((1, 16, 16, 3))), 1)
    x = np.random.default_rng(1).random((2, 3, size, size),
                                        dtype=np.float32)
    want = _nchw(jmodel.apply({"params": params}, _nhwc(x)))
    model = HFRM(tlc=tlc, **kw)
    model.load_state_dict(hfrm_state_dict_from_flax(
        params, kw["enc_blk_nums"], 1, kw["dec_blk_nums"]))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    _close(got, want, 1e-5)
    if size > 16:        # the local windows change the output
        with torch.no_grad():
            plain = HFRM(**kw)
            plain.load_state_dict(model.state_dict())
            assert float((plain(torch.from_numpy(x)).numpy() - got).__abs__()
                         .max()) > 1e-4


# ----------------------------------------------------------- WDNet, SAM


def test_wdnet_matches_golden_and_jax():
    z, sd = _golden("wdnet_small.npz")
    model = WDNet()
    model.load_state_dict(sd)
    with torch.no_grad():
        y = model(torch.from_numpy(z["x"]))
    np.testing.assert_allclose(y.numpy(), z["y"], atol=2e-4, rtol=1e-3)
    params = random_params(_shapes(JaxWDNet(), jnp.zeros((1, 8, 8, 48))), 2)
    x = np.random.default_rng(2).standard_normal((2, 48, 8, 12)).astype(
        np.float32)
    model.load_state_dict(wdnet_state_dict_from_flax(params))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    _close(got, _nchw(JaxWDNet().apply({"params": params}, _nhwc(x))), 1e-4)


def test_sam_matches_golden_and_jax():
    z, sd = _golden("sam_small.npz")
    model = SAM(64, 16)
    model.load_state_dict(sd)
    with torch.no_grad():
        y = model(torch.from_numpy(z["x"]))
    np.testing.assert_allclose(y.numpy(), z["y"], atol=1e-4, rtol=1e-3)
    jmodel = JaxSAM(out_channels=16)
    params = random_params(_shapes(jmodel, jnp.zeros((1, 8, 10, 64))), 3)
    x = np.random.default_rng(3).standard_normal((2, 64, 8, 10)).astype(
        np.float32)
    model.load_state_dict(sam_state_dict_from_flax(params))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    _close(got, _nchw(jmodel.apply({"params": params}, _nhwc(x))), 1e-4)


def test_irnn_sweeps_match_jax():
    """All eight directional sweeps, with weights away from 1 (the
    diagonals read ``down_weight``, as in the reference)."""
    jlayer = JaxIRNN()
    x = np.random.default_rng(4).standard_normal((2, 3, 5, 7)).astype(
        np.float32)
    params = {k: jnp.asarray(v, jnp.float32) for k, v in zip(
        ("left_weight", "right_weight", "up_weight", "down_weight",
         "zuoshang_weight", "zuoxia_weight", "youshang_weight",
         "youxia_weight"), (0.7, -0.4, 1.3, 0.9, 2.0, 2.0, 2.0, 2.0))}
    want = jlayer.apply({"params": params}, _nhwc(x))
    layer = IRNNLayer()
    layer.load_state_dict({k: torch.tensor(float(v))
                           for k, v in params.items()})
    with torch.no_grad():
        got = layer(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _nchw(w), atol=1e-6, rtol=0)


def test_rrdb_matches_jax():
    """Running residual adds, ``out3 * 0.2 + deli(x)``, and the SAM it
    builds but never calls."""
    x = np.random.default_rng(5).standard_normal((1, 64, 8, 8)).astype(
        np.float32)
    params = random_params(_shapes(JaxRRDB(), _nhwc(x)), 5)
    want = _nchw(JaxRRDB().apply({"params": params}, _nhwc(x)))
    model = RRDB()
    model.load_state_dict(rrdb_state_dict_from_flax(params))
    with torch.no_grad():
        _close(model(torch.from_numpy(x)).numpy(), want, 1e-4)


def test_seblock_matches_jax():
    x = np.random.default_rng(6).standard_normal((2, 24, 5, 7)).astype(
        np.float32)
    params = random_params(_shapes(JaxSEBlock(), _nhwc(x)), 6)
    want = _nchw(JaxSEBlock().apply({"params": params}, _nhwc(x)))
    model = SEBlock(24)
    model.load_state_dict({
        f"{n}.{k}": torch.from_numpy(np.asarray(
            params[n]["kernel"]).T.copy() if k == "weight"
            else np.asarray(params[n]["bias"]))
        for n in ("fc1", "fc2") for k in ("weight", "bias")})
    with torch.no_grad():
        _close(model(torch.from_numpy(x)).numpy(), want, 1e-5)


def test_discriminator_matches_jax():
    jd = JaxDiscriminator()
    a = np.random.default_rng(6).random((2, 3, 64, 48), dtype=np.float32)
    b = np.random.default_rng(7).random((2, 3, 64, 48), dtype=np.float32)
    params = random_params(_shapes(jd, _nhwc(a), _nhwc(b)), 6)
    want = _nchw(jd.apply({"params": params}, _nhwc(a), _nhwc(b)))
    d = Discriminator()
    d.load_state_dict(discriminator_state_dict_from_flax(params))
    with torch.no_grad():
        got = d(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (2, 1, 4, 3)
    _close(got, want, 1e-4)


# ------------------------------------------------------------------- VGG


def test_vgg_features_and_perceptual_loss_match_jax():
    jvgg = JaxVGG()
    params = random_params(_shapes(jvgg, jnp.zeros((1, 16, 16, 3))), 8)
    rng = np.random.default_rng(8)
    x, y = (rng.random((2, 3, 32, 48), dtype=np.float32) * 255
            for _ in range(2))
    jx = jvgg.apply({"params": params}, _nhwc(x))
    jy = jvgg.apply({"params": params}, _nhwc(y))
    vgg = VGG19Features()
    vgg.load_state_dict(vgg19_state_dict_from_flax(params))
    with torch.no_grad():
        tx, ty = vgg(torch.from_numpy(x)), vgg(torch.from_numpy(y))
        loss = float(perceptual_loss(tx, ty))
    assert list(tx) == ["relu1", "relu2", "relu3", "relu4", "relu5"]
    for name in tx:
        _close(tx[name].numpy(), _nchw(jx[name]), 1e-4)
    want = float(jax_perceptual(jx, jy))
    assert abs(loss - want) <= 1e-4 * want


def test_a_torchvision_vgg19_state_dict_loads_as_it_stands():
    """The whole torchvision ``vgg19`` state_dict (convs past relu5_2 and
    the classifier included) loads strictly after the converter, which
    keeps exactly the layers the features use."""
    want = VGG19Features().state_dict()
    full = {k: torch.randn(v.shape) for k, v in want.items()}
    full.update({"features.32.weight": torch.zeros(512, 512, 3, 3),
                 "features.34.bias": torch.zeros(512),
                 "classifier.0.weight": torch.zeros(4096, 25088)})
    model = VGG19Features()
    model.load_state_dict(vgg19_features_state_dict(
        {k: v.numpy() for k, v in full.items()}))
    for k, v in model.state_dict().items():
        assert torch.equal(v, full[k]), k


# -------------------------------------------------------- the HFRM step


def _jax_gan_trainer(raw):
    jcfg = jax_config_from_dict(copy.deepcopy(raw))
    return jax_hfrm_trainer.HFRMTrainer(jcfg, use_mesh=False,
                                        log_fn=lambda s: None)


def _adam_mu(opt_state):
    """The first moment of the one Adam in an optax state."""
    (mu,) = [s.mu for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")]
    return mu


def test_gan_perceptual_step_matches_jax():
    """One ``HFRMTrainer`` step with ``use_gan`` (lambda 0.5) and
    ``use_perceptual`` against JAX's ``gan_step_fn``: the generator's and
    the discriminator's loss, and both updated parameter trees.  The
    generator starts from the identity-centre weights on both sides, the
    discriminator and VGG from JAX's draws carried across."""
    raw = copy.deepcopy(TINY)
    raw["hfrm"].update(use_gan=True, use_perceptual=True, lambda_gan=0.5)
    jt = _jax_gan_trainer(raw)
    batch = np.random.default_rng(9).random((2, 32, 48, 6), dtype=np.float32)
    disc0 = discriminator_state_dict_from_flax(jt.disc_state.params)
    vgg_sd = vgg19_state_dict_from_flax(jt.vgg_params)
    jstate, jdisc, (jloss, jpsnr, jdloss) = jt._step(
        jt.state, jt.disc_state, jnp.asarray(batch))

    tr = HFRMTrainer(config_from_dict(raw), device="cpu",
                     log_fn=lambda s: None)
    tr.disc_state.model.load_state_dict(disc0)
    tr.vgg.load_state_dict(vgg_sd)
    loss, psnr = tr.train_step(batch)
    for got, want in ((loss, jloss), (tr.d_loss, jdloss), (psnr, jpsnr)):
        assert abs(float(got) - float(want)) <= 1e-4 * abs(float(want))
    h = TINY["hfrm"]
    want_g = hfrm_state_dict_from_flax(jstate.params, h["enc_blk_nums"], 1,
                                       h["dec_blk_nums"])
    got_sd = tr.model.state_dict()
    for k, w in want_g.items():
        assert float((got_sd[k] - w).abs().max()) <= 1e-4 * max(
            float(w.abs().max()), 1e-30), k
    lr = tr.cfg.hfrm.lr
    for k, p in tr.disc_state.model.named_parameters():
        w = discriminator_state_dict_from_flax(jdisc.params)[k]
        diff = (p.detach() - w).abs()
        noise = p.grad.abs() < 1e-6
        assert bool((diff[~noise] <= 1e-4 * w.abs().max()).all()), k
        assert float(diff.max()) <= 2 * lr, k
    # each leaf's gradient: Adam's first moment after one step is
    # (1 - b1) g, on both sides
    for model, jopt, conv in (
            (tr.model, jstate.opt_state, lambda t: hfrm_state_dict_from_flax(
                t, h["enc_blk_nums"], 1, h["dec_blk_nums"])),
            (tr.disc_state.model, jdisc.opt_state,
             discriminator_state_dict_from_flax)):
        want_g = conv(jax.tree_util.tree_map(lambda m: m / 0.5,
                                             _adam_mu(jopt)))
        g_all = max(float(g.abs().max()) for g in want_g.values())
        for k, p in model.named_parameters():
            err = float((p.grad - want_g[k]).abs().max())
            assert err <= 1e-4 * float(want_g[k].abs().max()) + \
                1e-6 * g_all, k
    # the discriminator moved, the frozen VGG did not
    assert any(not torch.equal(v, disc0[k])
               for k, v in tr.disc_state.model.state_dict().items())
    assert all(torch.equal(v, vgg_sd[k]) for k, v in tr.vgg.state_dict()
               .items())
    assert tr.disc_state.step == int(jdisc.step) == 1


def test_gan_state_is_saved_and_resumed(tmp_path):
    raw = copy.deepcopy(TINY)
    raw["hfrm"].update(use_gan=True)
    cfg = config_from_dict(raw)
    tr = HFRMTrainer(cfg, device="cpu", log_fn=lambda s: None)
    batch = np.random.default_rng(10).random((2, 32, 32, 6),
                                             dtype=np.float32)
    tr.fit(lambda epoch: iter([batch, batch]), max_steps=2,
           ckpt_dir=str(tmp_path))
    fresh = HFRMTrainer(cfg, device="cpu", log_fn=lambda s: None)
    fresh.resume(str(tmp_path / "lastest.pth.tar"))
    assert fresh.disc_state.step == tr.disc_state.step == 2
    for k, v in tr.disc_state.model.state_dict().items():
        assert torch.equal(fresh.disc_state.model.state_dict()[k], v), k
    a = tr.disc_state.optimizer.state_dict()["state"]
    b = fresh.disc_state.optimizer.state_dict()["state"]
    assert all(torch.equal(a[i]["exp_avg_sq"], b[i]["exp_avg_sq"])
               for i in a)


def test_orbax_checkpoint_carries_the_discriminator(tmp_path):
    """A JAX stage-1 checkpoint with its discriminator (``extra_arrays``)
    converts into a file whose ``disc`` entry the port's trainer
    resumes."""
    from wavedm_tpu_torch.utils.orbax_convert import convert_orbax_checkpoint

    raw = copy.deepcopy(TINY)
    raw["hfrm"].update(use_gan=True)
    jt = _jax_gan_trainer(raw)
    batch = np.random.default_rng(11).random((2, 32, 32, 6),
                                             dtype=np.float32)
    jt.fit(lambda epoch: iter([batch]), max_steps=1,
           ckpt_dir=str(tmp_path / "jax"))
    cfg = config_from_dict(raw)
    info = convert_orbax_checkpoint(str(tmp_path / "jax" / "lastest"),
                                    str(tmp_path / "conv"), cfg)
    tr = HFRMTrainer(cfg, device="cpu", log_fn=lambda s: None)
    tr.resume(info["path"])
    want = discriminator_state_dict_from_flax(jt.disc_state.params)
    for k, v in tr.disc_state.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert tr.disc_state.step == 1
    state = tr.disc_state.optimizer.state_dict()["state"]
    assert len(state) == len(want) and all(
        float(s["step"]) == 1.0 for s in state.values())


def test_cli_trains_with_both_terms(tmp_path, capsys):
    from wavedm_tpu_torch.cli import train_hfrm

    args = ["--config", "production", "--device", "cpu", "--smoke",
            "--max-steps", "1", "--ckpt-dir", str(tmp_path)]
    for ov in ("hfrm.dim=4", "hfrm.enc_blk_nums=[1,1]",
               "hfrm.dec_blk_nums=[1,1]", "hfrm.middle_blk_num=1",
               "hfrm.use_gan=true", "hfrm.use_perceptual=true"):
        args += ["--set", ov]
    assert train_hfrm.main(args) == 0
    assert "at step 1" in capsys.readouterr().out
    obj = torch.load(tmp_path / "lastest.pth.tar", weights_only=True)
    assert obj["disc"]["step"] == 1
