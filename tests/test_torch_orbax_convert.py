"""PyTorch port: the JAX package's Orbax checkpoints served and resumed
through ``utils/orbax_convert.py``, on the CPU at a tiny size.

Every checkpoint here is a real one: JAX trains (or updates its optimizer)
and writes it with ``wavedm_tpu.utils.checkpoint.save_checkpoint``.

- A diffusion UNet after 2 Adam steps (non-zero moments) and a stage-1
  HFRM after 1 step convert; the port restores from the converted files
  within 1e-4 of JAX restoring from the Orbax directories (float32, same
  x_T), and the weights and EMA carry over exactly.
- One more train step on both sides, with JAX's t and noise injected into
  the port's step, agrees within ``tests/test_torch_training.py``'s bound
  for one step (1e-4 of each tensor's scale; under Adam a parameter or EMA
  element whose gradient is float noise may step either way: at most one
  in a thousand, by at most 10 lr).
- amsgrad's ``nu_max`` becomes ``max_exp_avg_sq``, RMSProp's ``nu``
  ``square_avg``, SGD's ``trace`` ``momentum_buffer``, exactly.
- A tree of another model, an optimizer the mapping cannot carry, an
  optimizer other than the config's and weights of another shape raise,
  and write nothing.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from wavedm_tpu.config import config_from_dict as jax_config_from_dict
from wavedm_tpu.diffusion.loss import antithetic_timesteps as jax_antithetic
from wavedm_tpu.inference.loader import build_restorer as jax_build_restorer
from wavedm_tpu.models.unet import DiffusionUNet as JaxUNet
from wavedm_tpu.training import train_step as jax_train_step
from wavedm_tpu.training.hfrm_trainer import HFRMTrainer as JaxHFRMTrainer
from wavedm_tpu.training.state import \
    create_train_state as jax_create_train_state
from wavedm_tpu.training.state import make_optimizer as jax_make_optimizer
from wavedm_tpu.utils.checkpoint import save_checkpoint as jax_save

from wavedm_tpu_torch.cli import convert_orbax
from wavedm_tpu_torch.config import config_from_dict
from wavedm_tpu_torch.inference.loader import build_hfrm, build_restorer
from wavedm_tpu_torch.training.hfrm_trainer import HFRMTrainer
from wavedm_tpu_torch.training.trainer import DiffusionTrainer
from wavedm_tpu_torch.utils.convert import (hfrm_state_dict_from_flax,
                                            unet_state_dict_from_flax)
from wavedm_tpu_torch.utils.orbax_convert import convert_orbax_checkpoint

SEED = 61
# tests/test_torch_training.py's config (width 64: see its docstring)
RAW = {
    "data": {"image_size": 8, "patch_size": 32},
    "model": {"use_gt_in_train": True, "ch": 64, "ch_mult": [1, 2],
              "num_res_blocks": 1, "attn_resolutions": [4]},
    "diffusion": {"num_diffusion_timesteps": 50},
    "hfrm": {"dim": 8, "enc_blk_nums": [1, 1], "middle_blk_num": 1,
             "dec_blk_nums": [1, 1]},
    "training": {"seed": SEED},
    "sampling": {"sampling_timesteps": 3, "grid_r": 4},
}
N_CROPS = 8
QUIET = dict(device="cpu", log_fn=lambda s: None)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raw(**sections):
    raw = copy.deepcopy(RAW)
    for name, values in sections.items():
        raw.setdefault(name, {}).update(values)
    return raw


def _configs(raw):
    return (jax_config_from_dict(copy.deepcopy(raw)),
            config_from_dict(copy.deepcopy(raw)).validate())


def _unet_sd(tree):
    return unet_state_dict_from_flax(tree, 2, 1)


def _jax_draws(rng_key, steps):
    """The t and noise draws the JAX step makes from its state's key."""
    draws = []
    for _ in range(steps):
        rng_key, key_t, key_e = jax.random.split(rng_key, 3)
        draws.append((np.asarray(jax_antithetic(key_t, N_CROPS, 50)),
                      np.asarray(jax.random.normal(key_e, (N_CROPS, 8, 8, 3),
                                                   jnp.float32))))
    return draws


@pytest.fixture(scope="module")
def unet_params():
    jcfg, _ = _configs(RAW)
    return jax.jit(JaxUNet.from_config(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 96)),
        jnp.zeros((1,)))["params"]


@pytest.fixture(scope="module")
def trained(unet_params, tmp_path_factory):
    """JAX: 2 UNet steps saved, then a third; 1 HFRM step saved.  Both
    checkpoints converted."""
    root = tmp_path_factory.mktemp("orbax")
    jcfg, cfg = _configs(RAW)
    jstep = jax_train_step.make_train_step(
        jcfg, JaxUNet.from_config(jcfg).apply, donate=False)
    jstate = jax_create_train_state(unet_params, jcfg.optim,
                                    jax.random.PRNGKey(1))
    draws = _jax_draws(jstate.rng, 3)
    batch = np.random.default_rng(2).random((N_CROPS, 32, 32, 6),
                                            dtype=np.float32)
    for _ in range(2):
        jstate, _ = jstep(jstate, jnp.asarray(batch))
    jax_save(str(root / "unet"), jstate, epoch=1)
    saved = jstate
    jstate3, m3 = jstep(jstate, jnp.asarray(batch))

    hfrm = JaxHFRMTrainer(jcfg, use_mesh=False, log_fn=lambda s: None)
    pair = np.random.default_rng(3).random((2, 32, 48, 6), dtype=np.float32)
    hfrm.fit(lambda epoch: iter([pair]), max_steps=1,
             ckpt_dir=str(root / "hfrm"))

    out = {"unet": convert_orbax_checkpoint(str(root / "unet"),
                                            str(root / "unet.pth.tar"), cfg),
           "hfrm": convert_orbax_checkpoint(str(root / "hfrm" / "lastest"),
                                            str(root / "hfrm"), cfg)}
    return dict(root=root, saved=saved, draws=draws, batch=batch,
                jstate3=jstate3, m3=m3, hfrm=hfrm, out=out)


def test_converted_files(trained):
    out = trained["out"]
    assert out["unet"]["kind"] == "unet" and out["unet"]["step"] == 2
    assert out["unet"]["epoch"] == 1 and out["unet"]["optimizer"] == "Adam"
    assert out["hfrm"]["kind"] == "hfrm" and out["hfrm"]["step"] == 1
    assert out["hfrm"]["path"].endswith("hfrm.pth.tar")
    obj = torch.load(out["unet"]["path"], map_location="cpu",
                     weights_only=True)
    saved = trained["saved"]
    for key, tree in (("state_dict", saved.params), ("ema_helper",
                                                     saved.ema)):
        want = _unet_sd(tree)
        assert obj[key].keys() == want.keys()
        assert all(torch.equal(obj[key][k], want[k]) for k in want), key
    assert obj["pred_type"] == "eps" and obj["generator"] == SEED
    mu = _unet_sd(saved.opt_state[0].mu)
    assert float(mu["conv_in.weight"].abs().max()) > 0      # real moments
    first = obj["optimizer"]["state"][0]
    assert float(first["step"]) == 2.0
    assert torch.equal(first["exp_avg"], mu["temb.dense.0.weight"])


def test_converted_checkpoint_restores_like_jax(trained):
    jcfg, cfg = _configs(RAW)
    root = trained["root"]
    cond = np.random.default_rng(5).random((2, 32, 48, 3), dtype=np.float32)
    jrest = jax_build_restorer(jcfg, str(root / "unet"),
                               str(root / "hfrm" / "lastest"))
    ref, ref_hfrm = jrest.restore_image(cond)
    key_init, _ = jax.random.split(jax.random.PRNGKey(SEED))
    noise = np.asarray(jax.random.normal(key_init, (2, 8, 12, 3)))
    rest = build_restorer(cfg, trained["out"]["unet"]["path"],
                          trained["out"]["hfrm"]["path"], device="cpu")
    out, out_hfrm = rest.restore_image(
        cond, noise=torch.from_numpy(noise.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(out_hfrm.numpy(), np.asarray(ref_hfrm),
                               atol=1e-4)
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_converted_hfrm_loads_and_resumes(trained):
    _, cfg = _configs(RAW)
    path = trained["out"]["hfrm"]["path"]
    jstate = trained["hfrm"].state
    want = hfrm_state_dict_from_flax(jstate.params, (1, 1), 1, (1, 1))
    got = build_hfrm(cfg, path, "cpu").state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    trainer = HFRMTrainer(cfg, **QUIET)
    trainer.resume(path)
    assert trainer.state.step == 1 and trainer.epoch == 0
    assert trainer.best_psnr == trained["hfrm"].best_psnr
    mu = hfrm_state_dict_from_flax(jstate.opt_state[0].mu, (1, 1), 1, (1, 1))
    params = dict(trainer.model.named_parameters())
    opt = trainer.state.optimizer.state
    assert all(torch.equal(opt[params[k]]["exp_avg"], mu[k]) for k in mu)
    assert float(opt[params["conv_in.weight"]]["step"]) == 1.0


def test_one_more_step_matches_jax(trained):
    _, cfg = _configs(RAW)
    trainer = DiffusionTrainer(cfg, **QUIET)
    trainer.resume(trained["out"]["unet"]["path"])
    assert trainer.state.step == 2
    assert torch.equal(trainer.state.generator.get_state(),
                       torch.Generator().manual_seed(SEED).get_state())
    t, e = trained["draws"][2]
    m = trainer.train_step(trainer.state, trained["batch"],
                           t=torch.from_numpy(t.copy()),
                           e=torch.from_numpy(e.transpose(0, 3, 1, 2).copy()))
    assert trainer.state.step == 3
    jm, jstate = trained["m3"], trained["jstate3"]
    for name in ("loss", "grad_norm"):
        ours, theirs = float(getattr(m, name)), float(getattr(jm, name))
        assert abs(ours - theirs) <= 1e-4 * abs(theirs), name
    named = dict(trainer.model.named_parameters())
    opt = trainer.state.optimizer.state
    trees = {"params": (_unet_sd(jstate.params), lambda k: named[k], True),
             "ema": (_unet_sd(jstate.ema), lambda k: trainer.state.ema[k],
                     True)}
    for key, tree in (("exp_avg", jstate.opt_state[0].mu),
                      ("exp_avg_sq", jstate.opt_state[0].nu)):
        trees[key] = (_unet_sd(tree),
                      lambda k, key=key: opt[named[k]][key], False)
    grad_norm = float(m.grad_norm)
    for what, (want, get, sign_noise) in trees.items():
        for k, w in want.items():
            if k.endswith(".k.bias"):      # no gradient (the softmax)
                assert float(named[k].grad.abs().max()) <= 1e-6 * grad_norm
                continue
            diff = (get(k).detach() - w).abs()
            bad = diff > 1e-4 * float(w.abs().max())
            if sign_noise:
                assert int(bad.sum()) <= max(1, w.numel() // 1000), (what, k)
                assert float(diff.max()) <= 10 * cfg.optim.lr * 3, (what, k)
            else:
                assert not bool(bad.any()), (what, k, float(diff.max()))


def _updated_state(params, optim, steps=1):
    """A JAX train state whose optimizer took ``steps`` updates on fixed
    random gradients (the optimizer tree a run of that optimizer saves)."""
    jcfg, _ = _configs(_raw(optim=optim))
    tx = jax_make_optimizer(jcfg.optim)
    state = jax_create_train_state(params, jcfg.optim, jax.random.PRNGKey(1))
    rng = np.random.default_rng(7)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape), p.dtype), params)
    update = jax.jit(tx.update)
    opt_state = state.opt_state
    for _ in range(steps):
        _, opt_state = update(grads, opt_state, params)
    return state.replace(opt_state=opt_state, step=state.step + steps)


@pytest.mark.parametrize("optim,moments", [
    ({"optimizer": "Adam", "amsgrad": True, "weight_decay": 0.01},
     {"exp_avg": "mu", "exp_avg_sq": "nu", "max_exp_avg_sq": "nu_max"}),
    ({"optimizer": "RMSProp", "lr": 1e-4}, {"square_avg": "nu"}),
    ({"optimizer": "SGD", "lr": 1e-5}, {"momentum_buffer": "trace"}),
], ids=["adam_amsgrad", "rmsprop", "sgd"])
def test_optimizer_moments_map_exactly(unet_params, tmp_path, optim,
                                       moments):
    _, cfg = _configs(_raw(optim=optim))
    jstate = _updated_state(unet_params, optim, steps=2)
    jax_save(str(tmp_path / "ckpt"), jstate)
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(_raw(optim=optim)))
    assert convert_orbax.main(["--config", str(tmp_path / "cfg.yaml"),
                               str(tmp_path / "ckpt"),
                               str(tmp_path / "out")]) == 0
    trainer = DiffusionTrainer(cfg, **QUIET)
    trainer.resume(str(tmp_path / "out.pth.tar"))
    named = dict(trainer.model.named_parameters())
    (state,) = [s if isinstance(s, dict) else s._asdict()
                for s in jstate.opt_state
                if set(moments.values()) <= set(getattr(s, "_fields", s))]
    for key, field in moments.items():
        want = _unet_sd(state[field])
        assert float(max(v.abs().max() for v in want.values())) > 0
        for k, w in want.items():
            assert torch.equal(trainer.state.optimizer.state[named[k]][key],
                               w), (key, k)
    steps = {float(s["step"]) for s in trainer.state.optimizer.state.values()
             if "step" in s}
    assert steps == (set() if optim["optimizer"] == "SGD" else {2.0})


def _lion_state(params):
    jcfg, _ = _configs(RAW)
    state = jax_create_train_state(params, jcfg.optim, jax.random.PRNGKey(1))
    return state.replace(opt_state=optax.chain(
        optax.scale_by_lion(), optax.scale_by_learning_rate(1e-4)).init(
            params))


@pytest.mark.parametrize("case,match", [
    ("other_model", "not a checkpoint of the diffusion UNet or of HFRM"),
    ("lion", "cannot be carried"),
    ("config_says_sgd", "holds Adam state, the config's optimizer is SGD"),
    ("other_width", "do not fit"),
])
def test_unknown_trees_raise_and_write_nothing(unet_params, trained,
                                               tmp_path, case, match):
    src, raw = str(tmp_path / "ckpt"), RAW
    if case == "other_model":
        jax_save(src, _updated_state({"head": {"kernel": jnp.ones((3, 4))}},
                                     {"optimizer": "Adam"}))
    elif case == "lion":
        jax_save(src, _lion_state(unet_params))
    else:                       # the Adam UNet checkpoint, another config
        src = str(trained["root"] / "unet")
        raw = (_raw(optim={"optimizer": "SGD"}) if case == "config_says_sgd"
               else _raw(model={"ch": 32}))
    with pytest.raises(ValueError, match=match):
        convert_orbax_checkpoint(src, str(tmp_path / "out"),
                                 _configs(raw)[1])
    assert not [f for f in os.listdir(tmp_path) if f.startswith("out")]
