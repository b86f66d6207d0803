"""PyTorch port: stage-1 HFRM training against the JAX package.

The identity-centre init and the trainer's starting weights are held to
the JAX package bit for bit.  Three train steps from that start on the
same batches are held to JAX's: loss and PSNR to 1e-5 relative, every
parameter to 1e-5 of that tensor's largest magnitude (float32 on both
sides; the convolutions sum in another order, and Adam turns that into
steps of different size only where a gradient is near float noise).  The
checkpoint gate is held to JAX's by recording what each trainer saves, and
when.  Everything runs on the CPU at a small size (dim 8, one block a
level), with torch on one thread.
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
from wavedm_tpu.models.wdnet import apply_identity_center_init
from wavedm_tpu.training import hfrm_trainer as jax_hfrm_trainer

from wavedm_tpu_torch.cli import train_hfrm as cli
from wavedm_tpu_torch.config import config_from_dict
from wavedm_tpu_torch.inference.loader import build_hfrm, init_random_
from wavedm_tpu_torch.models.hfrm import HFRM, HFRMBlock, identity_center_init_
from wavedm_tpu_torch.training import hfrm_trainer
from wavedm_tpu_torch.training.hfrm_trainer import HFRMTrainer
from wavedm_tpu_torch.utils.convert import hfrm_state_dict_from_flax
from wavedm_tpu_torch.utils.images import write_png

RAW = {"hfrm": {"dim": 8, "enc_blk_nums": [1, 1], "middle_blk_num": 1,
                "dec_blk_nums": [1, 1]}}
ARCH = dict(enc_blk_nums=(1, 1), mid_blk_num=1, dec_blk_nums=(1, 1))
QUIET = dict(log_fn=lambda msg: None)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: several pytest-xdist workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raw(**hfrm):
    raw = copy.deepcopy(RAW)
    raw["hfrm"].update(hfrm)
    return raw


def _configs(raw):
    return (jax_config_from_dict(copy.deepcopy(raw)),
            config_from_dict(copy.deepcopy(raw)))


def _sd(params):
    return hfrm_state_dict_from_flax(params, **ARCH)


def _batches(n, seed=3, shape=(2, 32, 48, 6)):
    rng = np.random.default_rng(seed)
    return [rng.random(shape, dtype=np.float32) for _ in range(n)]


def _equal_sd(a, b):
    assert a.keys() == b.keys()
    return all(torch.equal(a[k], b[k]) for k in a)


# ------------------------------------------------------------------ init


def test_identity_center_init_matches_jax():
    jcfg, cfg = _configs(RAW)
    params = jax.jit(JaxHFRM.from_config(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    want = _sd(apply_identity_center_init(params))
    model = HFRM.from_config(cfg)
    init_random_(model, torch.Generator().manual_seed(1))
    for m in model.modules():          # nonzero scales, to be reset
        if isinstance(m, HFRMBlock):
            m.beta.data.fill_(0.5)
            m.gamma.data.fill_(-0.5)
    assert _equal_sd(identity_center_init_(model).state_dict(), want)
    # a depthwise conv: only its first output channel sees its input
    w = model.encoders[0][0].conv2.weight
    assert w[0, 0, 1, 1] == 1 and w.abs().sum() == 1


@pytest.fixture(scope="module")
def jax_run():
    """JAX's trainer: its starting weights, then three steps on
    ``_batches(3)`` with the loss and PSNR of each."""
    jcfg, _ = _configs(RAW)
    jt = jax_hfrm_trainer.HFRMTrainer(jcfg, use_mesh=False, **QUIET)
    start = _sd(jt.state.params)
    metrics = []
    for batch in _batches(3):
        jt.state, (loss, psnr) = jt._step(jt.state, jnp.asarray(batch))
        metrics.append((float(loss), float(psnr)))
    return start, metrics, _sd(jt.state.params), int(jt.state.step)


def test_trainer_starts_from_jax_weights_with_no_random_draw(jax_run):
    _, cfg = _configs(RAW)
    want = jax_run[0]
    sds = []
    for seed in (0, 99):
        torch.manual_seed(seed)
        cfg.training.seed = seed
        sds.append(HFRMTrainer(cfg, device="cpu", **QUIET).model.state_dict())
    assert _equal_sd(sds[0], want) and _equal_sd(sds[1], want)


# ------------------------------------------------------------------ loss


def test_tv_term_enters_the_loss():
    _, cfg = _configs(RAW)
    batch = _batches(1)[0]
    losses = []
    for weight in (0.0, 0.5):
        cfg.hfrm.tv_weight = weight
        trainer = HFRMTrainer(cfg, device="cpu", **QUIET)
        losses.append(float(trainer.train_step(batch)[0]))
    # both start from the same weights, so from the same output
    cond = torch.from_numpy(batch[..., :3]).permute(0, 3, 1, 2)
    with torch.no_grad():
        fake = HFRMTrainer(cfg, device="cpu", **QUIET).model(cond)
    want = float(hfrm_trainer.tv_loss(fake, 0.5))
    assert abs(losses[1] - losses[0] - want) <= 1e-5 * losses[1]


def test_tv_loss_and_lr_schedule_match_jax():
    x = np.random.default_rng(0).random((2, 5, 7, 3), dtype=np.float32)
    for weight in (1.0, 0.3):
        want = float(jax_hfrm_trainer.tv_loss(jnp.asarray(x), weight))
        got = float(hfrm_trainer.tv_loss(
            torch.from_numpy(x).permute(0, 3, 1, 2), weight))
        assert abs(got - want) <= 1e-6 * abs(want)
    sched = jax_hfrm_trainer.hfrm_lr_schedule(2e-4)
    for step in (0, 1, 1000, 100000, 250000):
        assert abs(hfrm_trainer.hfrm_lr(2e-4, step) - float(sched(step))) \
            <= 1e-6 * 2e-4
    assert hfrm_trainer.hfrm_lr(2e-4, 0) == 2e-4


def test_three_train_steps_match_jax(jax_run):
    _, metrics, want, jax_step = jax_run
    _, cfg = _configs(RAW)
    pt = HFRMTrainer(cfg, device="cpu", **QUIET)
    for step, (batch, (jl, jp)) in enumerate(zip(_batches(3), metrics), 1):
        pl, pp = pt.train_step(batch)
        assert abs(float(pl) - jl) <= 1e-5 * abs(jl), step
        assert abs(float(pp) - jp) <= 1e-5 * abs(jp), step
    assert pt.state.step == jax_step == 3
    got = pt.model.state_dict()
    for k, w in want.items():
        scale = float(w.abs().max())
        assert float((got[k] - w).abs().max()) <= 1e-5 * max(scale, 1e-30), k


def test_identity_start_leaves_the_blocks_without_gradient(jax_run):
    """From the identity-centre start every block's SimpleGate multiplies
    by channels the init leaves at zero, so each residual branch is 0 and
    its parameters get exactly zero gradient: after three steps JAX and
    the port have moved the tensors outside the blocks (10 at this size,
    16 at full width) and nothing inside them."""
    start, _, want, _ = jax_run
    _, cfg = _configs(RAW)
    pt = HFRMTrainer(cfg, device="cpu", **QUIET)
    for batch in _batches(3):
        pt.train_step(batch)
    got = pt.model.state_dict()
    for k in start:
        in_block = k.startswith(("encoders", "mid_blks", "decoders"))
        assert torch.equal(want[k], start[k]) == in_block, k
        assert torch.equal(got[k], start[k]) == in_block, k
    assert sum(not k.startswith(("encoders", "mid_blks", "decoders"))
               for k in start) == 10


# ------------------------------------------------------------ dtypes, remat


def _random_weights(cfg):
    model = HFRM.from_config(cfg)
    init_random_(model, torch.Generator().manual_seed(4))
    gen = torch.Generator().manual_seed(5)
    for m in model.modules():
        if isinstance(m, HFRMBlock):
            m.beta.data.copy_(torch.rand(m.beta.shape, generator=gen))
            m.gamma.data.copy_(torch.rand(m.gamma.shape, generator=gen))
    return model.state_dict()


def test_bf16_over_f32_parameters_equals_the_stored_bf16_forward():
    _, cfg = _configs(RAW)
    cfg.parallel.compute_dtype = "bfloat16"
    sd = _random_weights(cfg)
    x = torch.rand(2, 3, 32, 48, generator=torch.Generator().manual_seed(6))
    outs = []
    for keep_f32 in (True, False):
        model = HFRM.from_config(cfg, keep_f32_params=keep_f32)
        model.load_state_dict(sd)
        dtypes = {p.dtype for n, p in model.named_parameters()
                  if "conv" in n or "ups" in n or "downs" in n}
        assert dtypes == {torch.float32 if keep_f32 else torch.bfloat16}
        with torch.no_grad():
            outs.append(model(x))
    assert torch.equal(outs[0], outs[1])
    # and bf16 it is: it parts from the float32 forward
    f32 = HFRM.from_config(_configs(RAW)[1])
    f32.load_state_dict(sd)
    with torch.no_grad():
        assert not torch.equal(f32(x), outs[0])


def test_remat_gives_the_same_gradients():
    _, cfg = _configs(RAW)
    sd = _random_weights(cfg)
    x = torch.rand(2, 3, 32, 48, generator=torch.Generator().manual_seed(7))
    grads, calls = [], []
    for remat in (False, True):
        model = HFRM.from_config(cfg, remat=remat).train()
        model.load_state_dict(sd)
        n = [0]
        model.mid_blks[0].register_forward_pre_hook(
            lambda *a, n=n: n.__setitem__(0, n[0] + 1))
        model(x).square().mean().backward()
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
        calls.append(n[0])
    assert calls == [1, 2]          # remat ran the block again in backward
    for k, g in grads[0].items():
        assert torch.allclose(grads[1][k], g, rtol=0, atol=1e-7
                              * max(float(g.abs().max()), 1e-30)), k


# ------------------------------------------------------------- fit, ckpt


def _record_saves(cls, monkeypatch):
    events = []
    monkeypatch.setattr(cls, "save", lambda self, d, name: events.append(
        (int(self.epoch), int(self.state.step), name)))
    return events


def test_checkpoint_gate_matches_jax(monkeypatch):
    """Six epochs of two steps (a best PSNR gate at 0 dB, so the first
    epoch's mean beats it): JAX and the port write ``best`` and ``lastest``
    at the same epochs and steps, and stop at the same step."""
    jcfg, cfg = _configs(_raw(n_epochs=6, best_psnr_init=0.0))
    data = _batches(2, seed=8)
    runs = []
    for cls, kw in ((jax_hfrm_trainer.HFRMTrainer, dict(use_mesh=False)),
                    (HFRMTrainer, dict(device="cpu"))):
        events = _record_saves(cls, monkeypatch)
        trainer = cls(jcfg if kw.get("use_mesh") is False else cfg,
                      **kw, **QUIET)
        trainer.fit(lambda epoch: iter(data), ckpt_dir="unused")
        runs.append((events, int(trainer.state.step), trainer.best_psnr))
    (j_events, j_step, j_best), (p_events, p_step, p_best) = runs
    assert p_events == j_events and p_step == j_step
    assert abs(p_best - j_best) <= 1e-5 * abs(j_best)
    names = [e[2] for e in p_events]
    assert "best" in names and names.count("lastest") == 2   # epochs 4, 5


def test_save_resume_and_build_hfrm_load_the_lastest_file(tmp_path):
    _, cfg = _configs(_raw(n_epochs=5, best_psnr_init=0.0))
    data = _batches(2, seed=9)
    trainer = HFRMTrainer(cfg, device="cpu", **QUIET)
    history = trainer.fit(lambda epoch: iter(data), max_steps=3,
                          ckpt_dir=str(tmp_path))
    assert [h[0] for h in history] == [1, 2, 3]
    assert all(np.isfinite(h[1]) and np.isfinite(h[2]) for h in history)
    # the run ended mid-epoch 1 at max_steps: lastest, and best after
    # epoch 0 (its mean PSNR beat 0 dB)
    assert sorted(os.listdir(tmp_path)) == ["best.pth.tar", "lastest.pth.tar"]
    path = str(tmp_path / "lastest.pth.tar")
    resumed = HFRMTrainer(cfg, device="cpu", **QUIET)
    resumed.resume(path)
    assert (resumed.epoch, resumed.state.step) == (1, 3)
    assert resumed.best_psnr == trainer.best_psnr > 0
    assert _equal_sd(resumed.model.state_dict(), trainer.model.state_dict())
    # the restored Adam moments take the same next step
    trainer.train_step(data[0])
    resumed.train_step(data[0])
    assert _equal_sd(resumed.model.state_dict(), trainer.model.state_dict())
    # a resumed run already at its stop takes no step
    assert resumed.fit(lambda epoch: iter(data), max_steps=4) == []
    # stage 2 and serving load the file as it is
    loaded = build_hfrm(cfg, path, "cpu")
    saved = torch.load(path, map_location="cpu", weights_only=True)
    assert _equal_sd(loaded.state_dict(), saved["state_dict"])


# ------------------------------------------------------------------ CLI


def _write_split(root, n, h=64, w=96):
    rng = np.random.default_rng(0)
    for i in range(n):
        for folder in ("input", "gt"):
            path = os.path.join(root, "raindrop", "train", folder, f"{i}.png")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            write_png(path, rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


TINY = ["--set", "hfrm.dim=8", "--set", "hfrm.enc_blk_nums=[1,1]",
        "--set", "hfrm.dec_blk_nums=[1,1]", "--set", "hfrm.middle_blk_num=1",
        "--set", "hfrm.batch_size=2", "--device", "cpu"]


def test_cli_trains_on_the_split_streamed_and_cached_alike(tmp_path, capsys):
    """Whole pairs at the eval geometry (64x96 files resized to 720x480)
    in batches of 2; the device-cache path trains to the same weights."""
    _write_split(str(tmp_path), 2)
    common = ["--config", "production", "--max-steps", "1", *TINY,
              "--set", f"data.data_dir={tmp_path}"]
    sds = []
    for cache in ("false", "true"):
        out = tmp_path / f"ckpt_{cache}"
        assert cli.main(common + ["--set", f"data.device_cache={cache}",
                                  "--ckpt-dir", str(out)]) == 0
        assert "HFRM training done at step 1" in capsys.readouterr().out
        sds.append(torch.load(out / "lastest.pth.tar", map_location="cpu",
                              weights_only=True)["state_dict"])
    assert _equal_sd(sds[0], sds[1])


def test_cli_smoke_and_resume(tmp_path, capsys):
    common = ["--config", "production", "--smoke", *TINY,
              "--ckpt-dir", str(tmp_path)]
    assert cli.main(common + ["--max-steps", "2"]) == 0
    assert "done at step 2" in capsys.readouterr().out
    assert cli.main(common + ["--max-steps", "3", "--resume",
                              str(tmp_path / "lastest.pth.tar")]) == 0
    assert "done at step 3" in capsys.readouterr().out
