"""PyTorch port: stage-2 diffusion training against the JAX package.

The loss, the wavelet batch preparation and whole train steps run on both
sides with the same weights (carried across by ``utils/convert.py``), the
same batch and the same t and noise (the JAX step's own draws, replayed
into the port's step).  Everything runs in float32 on the CPU.

Tolerances: the loss and the batch agree to 1e-5 relative (elementwise
float32 math in another order).  After one and three steps, the loss, the
gradient norm, every parameter, optimizer moment and EMA tensor agree to
1e-4 of that tensor's scale: the convolutions' summation order differs by
~1e-6 relative.

Two kinds of value are held differently, because their result is decided
by float noise, on both sides alike:
- Adam and RMSProp step each element by about +-lr whatever the size of
  its gradient, so an element whose (weight-decayed) gradient is within
  float error of zero may step either way.  Under them, at most one
  element in a thousand of a parameter or EMA tensor (at least one) may
  miss the 1e-4 bound, and none by more than the optimizer's largest
  step, 10 lr a step.  The moments, linear or quadratic in the gradient,
  are held to the bound everywhere, and SGD's parameters too.
- The attention key bias adds the same q.b_k to every logit of a row,
  which the softmax removes, so its gradient is identically zero: the test
  asserts that it is (below 1e-6 of the gradient norm) instead of
  comparing noise.  The model is 64 channels wide (not tiny_config's 32)
  for the same reason: with one channel per GroupNorm group, a bias added
  before the norm has no gradient either.
"""

import copy
import dataclasses
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
from wavedm_tpu.diffusion.loss import \
    noise_estimation_loss as jax_noise_estimation_loss
from wavedm_tpu.models.hfrm import HFRM as JaxHFRM
from wavedm_tpu.models.unet import DiffusionUNet as JaxUNet
from wavedm_tpu.training import train_step as jax_train_step
from wavedm_tpu.training.state import \
    create_train_state as jax_create_train_state
from wavedm_tpu.training.train_step import \
    prepare_wavelet_batch as jax_prepare_wavelet_batch

from wavedm_tpu_torch.cli import train_diffusion as cli
from wavedm_tpu_torch.config import config_from_dict
from wavedm_tpu_torch.diffusion.loss import (antithetic_timesteps,
                                             noise_estimation_loss)
from wavedm_tpu_torch.models.hfrm import HFRM
from wavedm_tpu_torch.models.unet import DiffusionUNet
from wavedm_tpu_torch.training.state import create_train_state
from wavedm_tpu_torch.training.train_step import (make_train_step,
                                                  prepare_wavelet_batch)
from wavedm_tpu_torch.training.trainer import DiffusionTrainer
from wavedm_tpu_torch.utils.convert import (hfrm_state_dict_from_flax,
                                            unet_state_dict_from_flax)
from wavedm_tpu_torch.utils.images import write_png

# tests/test_train_step.py's tiny_config at width 64, with a small HFRM
RAW = {
    "data": {"image_size": 8, "patch_size": 32, "wavelet": True},
    "model": {"in_channels": 48, "out_ch": 3, "pred_channels": 3,
              "use_other_channels": True, "other_channels_begin": 3,
              "use_gt_in_train": True, "ch": 64, "ch_mult": [1, 2],
              "num_res_blocks": 1, "attn_resolutions": [4], "dropout": 0.0},
    "diffusion": {"num_diffusion_timesteps": 50},
    "hfrm": {"dim": 8, "enc_blk_nums": [1, 1], "middle_blk_num": 1,
             "dec_blk_nums": [1, 1]},
}
N_CROPS = 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: the suite runs several pytest-xdist workers on
    a few cores, where this file's small ops on a thread per core ran its
    cases ~10x slower than alone."""
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
            config_from_dict(copy.deepcopy(raw)))


def _batch(seed=2, n=N_CROPS):
    return np.random.default_rng(seed).random((n, 32, 32, 6),
                                              dtype=np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def unet_params():
    jcfg, _ = _configs(RAW)
    return jax.jit(JaxUNet.from_config(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 96)),
        jnp.zeros((1,)))["params"]


# ------------------------------------------------------------------ loss


@pytest.mark.parametrize("snr_gamma", [0.0, 5.0])
@pytest.mark.parametrize("pred_type", ["eps", "v"])
def test_noise_estimation_loss_matches_jax(pred_type, snr_gamma):
    rng = np.random.default_rng(7)
    x0 = rng.standard_normal((4, 8, 8, 96)).astype(np.float32)
    e = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    t = np.array([0, 13, 30, 49])
    mix = (rng.standard_normal((96, 3)) * 0.1).astype(np.float32)
    betas = np.linspace(1e-4, 0.02, 50, dtype=np.float32)
    kw = dict(inp_channels=48, pred_channels=3, use_other_channels=True,
              pred_type=pred_type, snr_gamma=snr_gamma)

    def jax_model(x, tt):
        return jnp.einsum("bhwc,cd->bhwd", x, mix) * (1 + tt / 50)[:, None,
                                                                   None, None]

    def torch_model(x, tt):
        return torch.einsum("bchw,cd->bdhw", x, torch.from_numpy(mix)) * (
            1 + tt / 50)[:, None, None, None]

    want = jax_noise_estimation_loss(jax_model, jnp.asarray(x0),
                                     jnp.asarray(t), jnp.asarray(e),
                                     jnp.asarray(betas), **kw)
    got = noise_estimation_loss(
        torch_model, torch.from_numpy(x0.transpose(0, 3, 1, 2).copy()),
        torch.from_numpy(t), torch.from_numpy(e.transpose(0, 3, 1, 2).copy()),
        torch.from_numpy(betas), **kw)
    for g, w in zip(got[:2], want[:2]):
        assert _rel(g.numpy(), w) <= 1e-5
    for g, w in zip(got[2:], want[2:]):
        assert _rel(g.numpy().transpose(0, 2, 3, 1), w) <= 1e-5


def test_antithetic_timesteps_mirror():
    gen = torch.Generator().manual_seed(0)
    t = antithetic_timesteps(gen, 7, 50)
    half = 7 // 2 + 1
    assert t.shape == (7,)
    assert torch.equal(t[half:], 49 - t[:7 - half])
    assert int(t.min()) >= 0 and int(t.max()) < 50
    # the JAX draw has the same structure (its random bits differ)
    tj = np.asarray(jax_antithetic(jax.random.PRNGKey(0), 7, 50))
    np.testing.assert_array_equal(tj[half:], 49 - tj[:7 - half])


# ------------------------------------------------------------------ batch


@pytest.mark.parametrize("use_gt", [True, False], ids=["gt", "hfrm"])
def test_prepare_wavelet_batch_matches_jax(use_gt):
    jcfg, cfg = _configs(_raw(model={"use_gt_in_train": use_gt}))
    x = _batch(5, n=2)
    hfrm_fn = hfrm = None
    if not use_gt:
        jhfrm = JaxHFRM.from_config(jcfg)
        hp = jax.jit(jhfrm.init)(jax.random.PRNGKey(1),
                                 jnp.zeros((1, 32, 32, 3)))["params"]
        rng = np.random.default_rng(4)
        hp = jax.tree_util.tree_map_with_path(
            lambda path, v: jnp.asarray(0.5 * rng.standard_normal(v.shape),
                                        v.dtype)
            if path[-1].key in ("beta", "gamma") else v, hp)
        hfrm_fn = lambda xx: jhfrm.apply({"params": hp}, xx)   # noqa: E731
        hfrm = HFRM.from_config(cfg).eval()
        hfrm.load_state_dict(hfrm_state_dict_from_flax(hp, (1, 1), 1, (1, 1)))
    want = np.asarray(jax_prepare_wavelet_batch(jnp.asarray(x), jcfg,
                                                hfrm_fn))
    got = prepare_wavelet_batch(torch.from_numpy(x), cfg, hfrm)
    assert got.shape == (2, 96, 8, 8)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               atol=1e-5 * float(np.abs(want).max()))
    if not use_gt:
        with pytest.raises(ValueError, match="requires an hfrm"):
            prepare_wavelet_batch(torch.from_numpy(x), cfg, None)


# ------------------------------------------------------------------ steps


def _jax_draws(rng_key, steps, n=N_CROPS):
    """The t and noise draws the JAX step makes from its state's key."""
    draws = []
    for _ in range(steps):
        rng_key, key_t, key_e = jax.random.split(rng_key, 3)
        t = jax_antithetic(key_t, n, 50)
        e = jax.random.normal(key_e, (n, 8, 8, 3), jnp.float32)
        draws.append((np.asarray(t), np.asarray(e)))
    return draws


def _jax_moments(opt_state):
    """The optax moment trees, keyed by the torch optimizer's state names."""
    for s in opt_state:
        if isinstance(s, dict) and "nu_max" in s:
            return {"exp_avg": s["mu"], "exp_avg_sq": s["nu"],
                    "max_exp_avg_sq": s["nu_max"]}
        if isinstance(s, optax.ScaleByAdamState):
            return {"exp_avg": s.mu, "exp_avg_sq": s.nu}
        if isinstance(s, optax.ScaleByRmsState):
            return {"square_avg": s.nu}
        if isinstance(s, optax.TraceState):
            return {"momentum_buffer": s.trace}
    raise AssertionError(f"no moments in {opt_state}")


def _torch_rmsprop_semantics(monkeypatch, optim):
    """The JAX package's RMSProp is optax.scale_by_rms, whose default puts
    eps inside the square root: g / sqrt(nu + eps), where torch (and the
    port) divide by sqrt(nu) + eps.  The two part for gradients below
    ~1e-4, so the JAX side runs with torch's placement here."""
    wd = [optax.add_decayed_weights(optim.weight_decay)] \
        if optim.weight_decay else []
    tx = optax.chain(*wd, optax.scale_by_rms(decay=0.99, eps=1e-8,
                                             eps_in_sqrt=False),
                     optax.scale_by_learning_rate(optim.lr))
    monkeypatch.setattr(jax_train_step, "make_optimizer", lambda _: tx)


OPTIMIZERS = {
    "adam": {"optimizer": "Adam"},
    "adam_amsgrad_wd": {"optimizer": "Adam", "amsgrad": True,
                        "weight_decay": 0.01},
    "rmsprop": {"optimizer": "RMSProp", "lr": 1e-4, "weight_decay": 0.01},
    "sgd": {"optimizer": "SGD", "lr": 1e-5},
}
ADAPTIVE = ("Adam", "RMSProp")


@pytest.fixture(scope="module")
def jax_runs(unet_params):
    """opt -> (draws, states, metrics) of three JAX steps, made once."""
    cache = {}

    def run(opt):
        if opt not in cache:
            jcfg, _ = _configs(_raw(optim=OPTIMIZERS[opt],
                                    parallel={"fused_resblock": True}))
            with pytest.MonkeyPatch.context() as mp:
                if opt == "rmsprop":
                    _torch_rmsprop_semantics(mp, jcfg.optim)
                jstep = jax_train_step.make_train_step(
                    jcfg, JaxUNet.from_config(jcfg).apply, donate=False)
            jstate = jax_create_train_state(unet_params, jcfg.optim,
                                            jax.random.PRNGKey(1))
            draws = _jax_draws(jstate.rng, 3)
            states, metrics = [], []
            for _ in range(3):
                jstate, m = jstep(jstate, jnp.asarray(_batch()))
                states.append(jstate)
                metrics.append(m)
            cache[opt] = draws, states, metrics
        return cache[opt]

    return run


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_train_steps_match_jax(unet_params, jax_runs, opt, steps):
    _, cfg = _configs(_raw(optim=OPTIMIZERS[opt],
                           parallel={"fused_resblock": True}))
    draws, states, jmetrics = jax_runs(opt)
    draws, jstate, jmetrics = draws[:steps], states[steps - 1], \
        jmetrics[:steps]
    batch = _batch()

    model = DiffusionUNet.from_config(cfg, keep_f32_params=True)
    model.load_state_dict(unet_state_dict_from_flax(unet_params, 2, 1))
    state = create_train_state(model, cfg.optim, cfg.training.seed)
    step = make_train_step(cfg, model)
    for (t, e), jm in zip(draws, jmetrics):
        m = step(state, batch, t=torch.from_numpy(t.copy()),
                 e=torch.from_numpy(e.transpose(0, 3, 1, 2).copy()))
        for name in ("loss", "mse_loss", "loss_per_pixel", "grad_norm"):
            assert _rel(float(getattr(m, name)),
                        float(getattr(jm, name))) <= 1e-4, name
    assert state.step == steps
    named = dict(model.named_parameters())
    adaptive = cfg.optim.optimizer in ADAPTIVE

    trees = {"params": (unet_state_dict_from_flax(jstate.params, 2, 1),
                        lambda k: named[k], adaptive),
             "ema": (unet_state_dict_from_flax(jstate.ema, 2, 1),
                     lambda k: state.ema[k], adaptive)}
    for key, tree in _jax_moments(jstate.opt_state).items():
        trees[key] = (unet_state_dict_from_flax(tree, 2, 1),
                      lambda k, key=key: state.optimizer.state[named[k]][key],
                      False)
    grad_norm = float(m.grad_norm)
    for what, (want, get, sign_noise) in trees.items():
        assert want.keys() == named.keys(), what
        for k, w in want.items():
            if k.endswith(".k.bias"):      # zero gradient: see the docstring
                assert float(named[k].grad.abs().max()) <= 1e-6 * grad_norm
                continue
            diff = (get(k).detach() - w).abs()
            bad = diff > 1e-4 * float(w.abs().max())
            if sign_noise:                 # see the docstring
                assert int(bad.sum()) <= max(1, w.numel() // 1000), (what, k)
                assert float(diff.max()) <= 10 * cfg.optim.lr * steps, (what, k)
            else:
                assert not bool(bad.any()), (what, k, float(diff.max()))


def test_grad_accum_equals_one_pass(unet_params):
    _, cfg1 = _configs(_raw(optim=OPTIMIZERS["sgd"]))
    _, cfg2 = _configs(_raw(optim=OPTIMIZERS["sgd"],
                            training={"grad_accum": 2}))
    batch = _batch(9)
    t, e = _jax_draws(jax.random.PRNGKey(3), 1)[0]
    t = torch.from_numpy(t.copy())
    e = torch.from_numpy(e.transpose(0, 3, 1, 2).copy())
    out = []
    for cfg in (cfg1, cfg2):
        model = DiffusionUNet.from_config(cfg, keep_f32_params=True)
        model.load_state_dict(unet_state_dict_from_flax(unet_params, 2, 1))
        state = create_train_state(model, cfg.optim, 0)
        m = make_train_step(cfg, model)(state, batch, t=t, e=e)
        out.append((m, model.state_dict()))
    (m1, sd1), (m2, sd2) = out
    for name in ("loss", "mse_loss", "grad_norm"):
        assert _rel(float(getattr(m2, name)), float(getattr(m1, name))) <= 1e-5
    for k in sd1:      # the key bias has no gradient: see the docstring
        if not k.endswith(".k.bias"):
            assert _rel(sd2[k].numpy(), sd1[k].numpy()) <= 1e-5, k


def test_hfrm_weights_required_without_gt():
    _, cfg = _configs(_raw(model={"use_gt_in_train": False}))
    with pytest.raises(ValueError, match="frozen HFRM"):
        DiffusionTrainer(cfg, device="cpu")
    hfrm_sd = HFRM.from_config(cfg).state_dict()
    trainer = DiffusionTrainer(cfg, hfrm_state_dict=hfrm_sd, device="cpu",
                               log_fn=lambda s: None)
    assert not any(p.requires_grad for p in trainer.hfrm.parameters())
    trainer.fit(cli.smoke_batches(cfg, n_batches=2), max_steps=2)
    assert trainer.state.step == 2


# ------------------------------------------------------------------ trainer


def _same_state(a, b):
    for x, y in ((a.model.state_dict(), b.model.state_dict()), (a.ema, b.ema)):
        assert x.keys() == y.keys()
        assert all(torch.equal(x[k], y[k]) for k in x)
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    for i, s in oa["state"].items():
        assert all(torch.equal(v, ob["state"][i][k]) for k, v in s.items())
    assert a.step == b.step
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_fit_save_resume_round_trip(tmp_path):
    _, cfg = _configs(_raw(parallel={"fused_resblock": True}))
    quiet = dict(device="cpu", log_fn=lambda s: None)
    trainer = DiffusionTrainer(cfg, **quiet)
    p0 = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    metrics = tmp_path / "metrics.jsonl"
    history = trainer.fit(cli.smoke_batches(cfg), max_steps=10,
                          ckpt_dir=str(tmp_path / "ckpts"),
                          metrics_path=str(metrics))
    assert trainer.state.step == 10 and len(history) == 1
    assert np.isfinite(history[0].loss)
    assert metrics.read_text().count("\n") == 1
    moved = [k for k, v in trainer.model.state_dict().items()
             if not torch.equal(v, p0[k])]
    assert len(moved) == len(p0)
    assert len(list((tmp_path / "ckpts").iterdir())) == 1   # after step 1

    path = trainer.save(str(tmp_path / "snap"))
    resumed = DiffusionTrainer(cfg, **quiet)
    resumed.resume(path)
    _same_state(trainer.state, resumed.state)
    # the restored generator draws the same t and noise: same next step
    batch = _batch(11)
    trainer.train_step(trainer.state, batch)
    resumed.train_step(resumed.state, batch)
    _same_state(trainer.state, resumed.state)


def test_resume_refuses_another_pred_type(tmp_path):
    _, cfg = _configs(RAW)
    trainer = DiffusionTrainer(cfg, device="cpu", log_fn=lambda s: None)
    path = trainer.save(str(tmp_path / "eps"))
    _, cfg_v = _configs(_raw(training={"pred_type": "v"}))
    other = DiffusionTrainer(cfg_v, device="cpu", log_fn=lambda s: None)
    with pytest.raises(ValueError, match="pred_type"):
        other.resume(path)


def test_resumed_run_already_at_its_stop_takes_no_step(tmp_path):
    """The port's fit returns before any step when a resumed run is already
    at its stop (the JAX trainer takes one more step first)."""
    _, cfg = _configs(RAW)
    quiet = dict(device="cpu", log_fn=lambda s: None)
    trainer = DiffusionTrainer(cfg, **quiet)
    trainer.fit(cli.smoke_batches(cfg), max_steps=2)
    path = trainer.save(str(tmp_path / "at_stop"))
    resumed = DiffusionTrainer(cfg, **quiet)
    resumed.resume(path)
    assert resumed.fit(cli.smoke_batches(cfg), max_steps=2) == []
    assert resumed.state.step == 2
    _same_state(trainer.state, resumed.state)


def test_serving_loader_refuses_another_pred_type(tmp_path):
    """build_unet reads the pred_type a port checkpoint was trained with
    and raises on a mismatch; a reference file without the key is eps."""
    from wavedm_tpu_torch.inference.loader import build_unet

    _, cfg = _configs(RAW)
    _, cfg_v = _configs(_raw(training={"pred_type": "v"}))
    trainer = DiffusionTrainer(cfg_v, device="cpu", log_fn=lambda s: None)
    v_path = trainer.save(str(tmp_path / "v"))
    assert build_unet(cfg_v, v_path, "cpu").training is False
    with pytest.raises(ValueError, match="pred_type='v'"):
        build_unet(cfg, v_path, "cpu")
    with pytest.raises(ValueError, match="pred_type='v'"):
        build_unet(cfg, v_path, "cpu", ema=True)
    ref_path = str(tmp_path / "reference.pth.tar")
    torch.save({"state_dict": trainer.model.state_dict()}, ref_path)
    build_unet(cfg, ref_path, "cpu")
    with pytest.raises(ValueError, match="pred_type='eps'"):
        build_unet(cfg_v, ref_path, "cpu")


def test_cli_smoke(tmp_path, capsys):
    raw = _raw(parallel={"fused_resblock": True})
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(raw))
    rc = cli.main(["--config", str(path), "--smoke", "--max-steps", "2",
                   "--device", "cpu", "--set", "training.patch_n=4",
                   "--ckpt-dir", str(tmp_path / "ckpts")])
    assert rc == 0
    assert "smoke training done at step 2" in capsys.readouterr().out
    rc = cli.main(["--config", str(path), "--smoke", "--max-steps", "3",
                   "--device", "cpu", "--set", "training.patch_n=4",
                   "--ckpt-dir", str(tmp_path / "ckpts"), "--resume", "auto"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "loaded checkpoint" in out and "done at step 3" in out
    # without --smoke it reads the RainDrop train split of data.data_dir
    with pytest.raises(FileNotFoundError, match="raindrop"):
        cli.main(["--config", str(path), "--device", "cpu", "--set",
                  f"data.data_dir={tmp_path / 'none'}"])


def test_smoke_batches_assemble_crops_as_the_jax_script():
    _, cfg = _configs(RAW)
    batches = list(cli.smoke_batches(cfg)(0))
    assert len(batches) == 10
    assert all(b.shape == (8, 32, 32, 6) and b.dtype == np.float32
               for b in batches)
    assert 0.0 <= min(b.min() for b in batches) <= max(
        b.max() for b in batches) <= 1.0
    assert dataclasses.asdict(cfg)["training"]["patch_n"] == 8


# ------------------------------------------------- validation, RainDrop CLI


def _fake_steps(trainer, metrics):
    """Replace a trainer's step by one that only counts."""
    def step(state, batch):
        if hasattr(state, "replace"):             # JAX's immutable state
            return state.replace(step=state.step + 1), metrics
        state.step += 1
        return metrics
    return step


def test_validate_fn_fires_where_jax_fit_calls_it(monkeypatch):
    """Validation every 3 steps and snapshots every 4 over 10 steps of two
    epochs: the same hook calls at the same steps as JAX's fit, each before
    that step's snapshot."""
    from wavedm_tpu.training import trainer as jax_trainer
    from wavedm_tpu_torch.training.train_step import StepMetrics

    raw = _raw(training={"validation_freq": 3, "snapshot_freq": 4})
    jcfg, cfg = _configs(raw)
    runs = []
    one = torch.tensor(1.0)
    for cls, kw, cfg_ in (
            (jax_trainer.DiffusionTrainer, dict(use_mesh=False), jcfg),
            (DiffusionTrainer, dict(device="cpu"), cfg)):
        events = []
        monkeypatch.setattr(cls, "save", lambda self, path, events=events:
                            events.append(("save", int(self.state.step))))
        trainer = cls(cfg_, **kw, log_fn=lambda s: None)
        trainer.train_step = _fake_steps(trainer, StepMetrics(one, one, one,
                                                              one))
        trainer.fit(lambda epoch: iter([None] * 6), max_steps=10,
                    ckpt_dir="unused",
                    validate_fn=lambda state, step, events=events:
                    events.append(("validate", step)))
        runs.append(events)
    assert runs[0] == runs[1]
    assert [s for kind, s in runs[1] if kind == "validate"] == [3, 6, 9]


def _write_raindrop(root, n_train=3, n_test=2):
    rng = np.random.default_rng(0)
    for split, n in (("train", n_train), ("raindrop_test", n_test)):
        for i in range(n):
            for folder, name in (("input", f"{i}_rain.png"),
                                 ("gt", f"{i}_clean.png")):
                path = root / "raindrop" / split / folder / name
                path.parent.mkdir(parents=True, exist_ok=True)
                write_png(str(path), rng.integers(0, 256, (64, 96, 3),
                                                  dtype=np.uint8))


def test_cli_trains_on_raindrop_and_validates(tmp_path, capsys,
                                              monkeypatch):
    """The real-data path over a tmp RainDrop tree, with the frozen HFRM
    from a stage-1 checkpoint: validation at step 2 restores two test
    pairs and dumps them; the streamed PIL-order and device-cache paths
    train to the same weights (the native crop stream, which the CLI
    takes by default where the data library builds, draws other crops by
    design and is switched off here).  Without HFRM weights validation is
    skipped."""
    from wavedm_tpu_torch.data import raindrop
    from wavedm_tpu_torch.training.hfrm_trainer import HFRMTrainer

    monkeypatch.setattr(raindrop.native_loader, "available", lambda: False)

    _write_raindrop(tmp_path)
    raw = _raw(model={"use_gt_in_train": False},
               data={"data_dir": str(tmp_path)},
               training={"patch_n": 2, "batch_size": 1,
                         "validation_freq": 2, "snapshot_freq": 2},
               sampling={"sampling_timesteps": 2, "grid_r": 8})
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(raw))
    _, cfg = _configs(raw)
    hfrm_ckpt = HFRMTrainer(cfg, device="cpu", log_fn=lambda s: None).save(
        str(tmp_path), "lastest")
    sds = []
    for cache in ("false", "true"):
        ckpts, val = tmp_path / f"ckpts_{cache}", tmp_path / f"val_{cache}"
        assert cli.main(["--config", str(path), "--device", "cpu",
                         "--max-steps", "2", "--hfrm-ckpt", hfrm_ckpt,
                         "--ckpt-dir", str(ckpts), "--val-folder", str(val),
                         "--set", f"data.device_cache={cache}"]) == 0
        out = capsys.readouterr().out
        assert "[validate @ 2] psnr" in out and "done at step 2" in out
        assert sorted(os.listdir(val / "step2")) == sorted(
            f"{i}_rain_{k}.png" for i in range(2)
            for k in ("output", "cond", "gt"))
        sds.append(torch.load(ckpts / "RainDrop_epoch1_ddpm.pth.tar",
                              map_location="cpu", weights_only=True))
    for key in ("state_dict", "ema_helper"):
        assert all(torch.equal(v, sds[1][key][k])
                   for k, v in sds[0][key].items())

    ref = _raw(data={"data_dir": str(tmp_path)},
               training={"patch_n": 2, "validation_freq": 1})
    path.write_text(yaml.safe_dump(ref))
    assert cli.main(["--config", str(path), "--device", "cpu",
                     "--max-steps", "1", "--ckpt-dir",
                     str(tmp_path / "ref")]) == 0
    assert "[validate @ 1] skipped: no HFRM checkpoint" in \
        capsys.readouterr().out
