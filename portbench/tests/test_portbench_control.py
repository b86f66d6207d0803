"""The comparison that decides ``correct`` fails what it must: the
control (the reference one precision below the configuration's, in the
program's place) and the program broken underneath a whole run.

At the tests' small size; the readings at the cells' own sizes, from
which the limits were set, are ``calibrate.py``'s on the card (PERF.md).
"""

import pytest
import torch

from portbench.calibrate import restore_control, train_control
from portbench.lib.compare import judge
from portbench_tiny import F32, tiny_ctx, tiny_run
from wavedm_tpu_torch.inference.restoration import DiffusiveRestoration
from wavedm_tpu_torch.training import train_step as port_step


def test_the_fp8_control_fails_a_restore():
    ctx = tiny_ctx("restore_prod_b8")
    out = restore_control(ctx, "fp8")["control"]
    assert not judge(out, ctx.workload["limits"])[0]


def test_the_fp8_control_fails_a_train_step():
    ctx = tiny_ctx("train_prod_b16")
    out = train_control(ctx, "fp8")
    assert not judge(out["control"], ctx.workload["limits"])[0]
    assert not judge(out["half_batch"], ctx.workload["limits"])[0]


@pytest.mark.cuda
def test_the_tf32_control_fails_a_train_step():
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists on the card only")
    ctx = tiny_ctx("train_ref_b8", device="cuda")
    out = train_control(ctx, "tf32")["control"]
    assert not judge(out, ctx.workload["limits"])[0]


def test_sound_runs_are_correct():
    assert tiny_run("restore_prod_b8", F32)["correct"]
    assert tiny_run("train_ref_b8")["correct"]


def test_an_altered_answer_is_caught(monkeypatch):
    real = DiffusiveRestoration.restore_image_device

    def altered(self, cond, noise=None, **kw):
        out, aux = real(self, cond, noise=noise, **kw)
        out = out.clone()
        out[:, :8, :8] += 0.1
        return out, aux

    monkeypatch.setattr(DiffusiveRestoration, "restore_image_device",
                        altered)
    assert not tiny_run("restore_prod_b8", F32)["correct"]


def test_half_a_batch_restored_is_caught(monkeypatch):
    real = DiffusiveRestoration.restore_image_device

    def half(self, cond, noise=None, **kw):
        k = cond.shape[0] // 2
        out, aux = real(self, cond[:k], noise=noise[:k], **kw)
        return torch.cat([out, cond[k:]]), aux

    monkeypatch.setattr(DiffusiveRestoration, "restore_image_device", half)
    assert not tiny_run("restore_prod_b8", F32)["correct"]


def test_a_step_that_changes_nothing_is_caught(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    assert not tiny_run("train_ref_b8")["correct"]


def test_an_ema_left_unchanged_is_caught(monkeypatch):
    monkeypatch.setattr(port_step, "ema_update", lambda *a, **kw: None)
    out = tiny_run("train_ref_b8")
    assert out["checked"]["ema_gap"]["value"] == 1.0
    assert not out["correct"]


def test_an_ema_at_another_rate_is_caught(monkeypatch):
    real = port_step.ema_update
    monkeypatch.setattr(port_step, "ema_update",
                        lambda shadow, named, mu: real(shadow, named, 0.999))
    assert not tiny_run("train_ref_b8")["correct"]


def test_a_loss_over_half_the_batch_is_caught(monkeypatch):
    real = port_step.noise_estimation_loss

    def half(fn, x0, t, e, betas, **kw):
        k = x0.shape[0] // 2
        return real(fn, x0[:k], t[:k], e[:k], betas, **kw)

    monkeypatch.setattr(port_step, "noise_estimation_loss", half)
    assert not tiny_run("train_ref_b8")["correct"]
