"""PyTorch port: the spans the restore chain and the train step record,
the trainer's log times, the ``--trace`` flags of the restore and training
CLIs and ``trace_summary --idle-gaps``, on the CPU at a tiny size."""

import json
import os
import types
from collections import Counter, deque

import numpy as np
import pytest
import torch

from wavedm_tpu_torch.cli import restore as restore_cli
from wavedm_tpu_torch.cli import train_diffusion
from wavedm_tpu_torch.config import load_config
from wavedm_tpu_torch.inference.loader import build_hfrm, build_unet
from wavedm_tpu_torch.inference.restoration import DiffusiveRestoration
from wavedm_tpu_torch.tools import trace_summary
from wavedm_tpu_torch.training import trainer as trainer_mod
from wavedm_tpu_torch.training.state import create_train_state
from wavedm_tpu_torch.training.train_step import (StepMetrics,
                                                  make_train_step)
from wavedm_tpu_torch.utils import profiling
from wavedm_tpu_torch.utils.images import write_png

TINY = ["model.ch=32", "model.ch_mult=[1,2]", "model.num_res_blocks=1",
        "model.attn_resolutions=[4]", "data.image_size=8",
        "data.patch_size=32", "hfrm.dim=8", "hfrm.enc_blk_nums=[1,1]",
        "hfrm.dec_blk_nums=[1,1]", "hfrm.middle_blk_num=1",
        "sampling.sampling_timesteps=3", "sampling.grid_r=8"]
STEPS = 3


@pytest.fixture(autouse=True)
def setup(monkeypatch):
    """One torch thread (several test workers share the cores) and an
    empty span store."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(profiling, "_SPANS",
                        deque(maxlen=profiling.SPAN_LIMIT))
    yield
    torch.set_num_threads(n)


def _tree(spans):
    """{root id: Counter of the names under it (itself included)}."""
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    out = {}
    for root in kids.get(0, []):
        names, todo = Counter(), [root]
        while todo:
            s = todo.pop()
            names[s.name] += 1
            todo.extend(kids.get(s.id, []))
        out[root.id] = names
    return out


@pytest.mark.parametrize("micro_batch", [0, 1], ids=["whole", "mb1"])
def test_restore_spans_repeat_every_call(micro_batch):
    """Each tiny restore call (32x48 pixels: two 8x8 wavelet patches, three
    steps) records one ``restore`` span holding the HFRM, three wavelet
    transforms, the sync of the count mask and three chain steps, each
    with its gather, its UNet calls (one a micro-batch), its scatter and
    its update; the same in every call, and nothing with spans off."""
    cfg = load_config("production", TINY + [
        f"sampling.patch_micro_batch={micro_batch}"])
    torch.manual_seed(0)
    rest = DiffusiveRestoration(cfg, build_unet(cfg, None, "cpu"),
                                build_hfrm(cfg, None, "cpu"), device="cpu")
    x = torch.rand(1, 32, 48, 3)
    rest.restore_image_device(x)
    assert profiling.spans() == []
    with profiling.collect():
        for _ in range(2):
            rest.restore_image_device(x)
    calls = list(_tree(profiling.spans()).values())
    unets = STEPS * (2 if micro_batch else 1)
    want = {"restore": 1, "restore.hfrm": 1, "restore.wavelet": 3,
            "sync.count_mask": 1, "chain.step": STEPS,
            "chain.gather": STEPS, "unet": unets, "chain.scatter": STEPS,
            "chain.update": STEPS}
    assert calls == [want, want]
    by_id = {s.id: s for s in profiling.spans()}
    for s in profiling.spans():
        if s.name in ("unet", "chain.gather", "chain.scatter",
                      "chain.update"):
            assert by_id[s.parent].name == "chain.step"
        elif s.name != "restore":
            assert by_id[s.parent].name == "restore"


PIXEL = ["model.ch=32", "data.image_size=32", "data.patch_size=32",
         "sampling.sampling_timesteps=5", "sampling.grid_r=8"]


def _chain_counts_of(fn):
    """What ``fn()`` adds to the chain's counters."""
    before = dict(profiling.CHAIN)
    fn()
    return {k: v - before[k] for k, v in profiling.CHAIN.items()}


@pytest.mark.parametrize("keep, after", [(-1, 0), (-2, 1), (-5, 4)])
def test_pixel_restore_spans_and_chain_counts(keep, after):
    """A tiny pixel restore (the pixel UNet's six levels at ch 32 on 32x32
    patches of a 48x64 image, five steps from noise): its ``restore`` span
    holds two ``restore.pixel`` spans (entry and exit) and the five chain
    steps, and the chain counts five steps run, ``after`` of them after the
    step whose x0 the output keeps (``x0_pred_index`` ``keep``), with
    spans on or off."""
    cfg = load_config("pixel", PIXEL + [f"sampling.x0_pred_index={keep}"])
    torch.manual_seed(0)
    rest = DiffusiveRestoration(cfg, build_unet(cfg, None, "cpu"),
                                device="cpu")
    x = torch.rand(1, 48, 64, 3)
    want = {"chain.steps_run": 5, "chain.steps_after_kept": after}
    assert _chain_counts_of(lambda: rest.restore_image_device(x)) == want
    with profiling.collect():
        got = _chain_counts_of(lambda: rest.restore_image_device(x))
    assert got == want
    (call,) = _tree(profiling.spans()).values()
    assert call["restore.pixel"] == 2 and call["chain.step"] == 5
    assert call["restore.wavelet"] == 0 and call["restore.hfrm"] == 0


def test_whole_image_chain_counts_no_step_after_the_kept_one():
    """The whole-image chain's output is its last step: every step counts
    as run, none as after the kept one."""
    cfg = load_config("pixel", PIXEL + ["sampling.whole_image=true"])
    torch.manual_seed(0)
    rest = DiffusiveRestoration(cfg, build_unet(cfg, None, "cpu"),
                                device="cpu")
    got = _chain_counts_of(
        lambda: rest.restore_image_device(torch.rand(1, 32, 32, 3)))
    assert got == {"chain.steps_run": 5, "chain.steps_after_kept": 0}


def test_train_step_records_each_phase_once_in_order():
    cfg = load_config("production", TINY)
    torch.manual_seed(0)
    model = build_unet(cfg, None, "cpu", train=True)
    state = create_train_state(model, cfg.optim, 0)
    step = make_train_step(cfg, model, build_hfrm(cfg, None, "cpu"))
    batch = torch.rand(2, 32, 32, 6)
    with profiling.collect():
        for _ in range(2):
            step(state, batch)
    got = profiling.spans()
    roots = [s for s in got if s.name == "train.step"]
    assert len(roots) == 2 and all(r.parent == 0 for r in roots)
    for r in roots:
        phases = sorted((s for s in got if s.parent == r.id),
                        key=lambda s: s.start)
        assert [s.name for s in phases] == [
            "train.prepare", "train.forward", "train.backward",
            "train.update"]
        assert all(r.start <= s.start <= s.end <= r.end for s in phases)
        assert all(a.end <= b.start for a, b in zip(phases, phases[1:]))


def test_trainer_log_times_the_stretch_between_loss_reads(monkeypatch,
                                                          tmp_path):
    """A fake step of 0.25 s fed by batches of 0.05 s on a fake clock:
    ``step_time`` is the wall time between two loss reads over the steps
    between them (0.30 s) and ``data_time`` the batch waits of that
    stretch (10 x 0.05 s), in the history and the JSONL log alike."""
    clock = [100.0]
    monkeypatch.setattr(trainer_mod, "time", types.SimpleNamespace(
        perf_counter=lambda: clock[0]))
    tr = trainer_mod.DiffusionTrainer.__new__(trainer_mod.DiffusionTrainer)
    tr.cfg = load_config("production", TINY)
    tr.log, tr.epoch, tr.lap_state = (lambda line: None), 0, None
    tr.state = types.SimpleNamespace(step=0)
    one = torch.ones(())

    def fake_step(state, batch):
        clock[0] += 0.25
        state.step += 1
        return StepMetrics(loss=one, mse_loss=one, loss_per_pixel=one,
                           grad_norm=one)

    def batches(epoch):
        for _ in range(7):              # epochs end inside a logged stretch
            clock[0] += 0.05
            yield np.zeros((1, 4, 4, 6), np.float32)

    tr.train_step = fake_step
    log = tmp_path / "m.jsonl"
    history = tr.fit(batches, max_steps=20, metrics_path=str(log))
    assert [h.step for h in history] == [10, 20]
    for h in history:
        assert h.step_time == pytest.approx(0.30)
        assert h.data_time == pytest.approx(0.50)
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step_time"] for r in rows] == pytest.approx([0.30, 0.30])
    assert [r["data_time"] for r in rows] == pytest.approx([0.50, 0.50])


def _annotations(trace_dir):
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    return Counter(e["name"] for e in events
                   if e.get("cat") == "user_annotation")


def test_restore_cli_traces_the_first_batch(tmp_path):
    """The first batch is traced after one untraced run of it, and the
    outputs are an untraced run's: the noise is drawn again."""
    ind = tmp_path / "in"
    ind.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        write_png(str(ind / f"img{i}.png"),
                  rng.integers(0, 256, (32, 48, 3), dtype=np.uint8))
    for out, extra in (("out", ["--trace", str(tmp_path / "trace")]),
                       ("plain", [])):
        assert restore_cli.main(
            ["--config", "production", "--input", str(ind), "--out",
             str(tmp_path / out), "--batch", "1", "--no-resize", "--device",
             "cpu"] + extra
            + [a for kv in TINY for a in ("--set", kv)]) == 0
    names = _annotations(str(tmp_path / "trace"))
    assert names["restore"] == 1 and names["chain.step"] == STEPS
    assert names["sync.fetch"] == 1
    for i in range(2):
        name = f"img{i}_restored.png"
        assert (tmp_path / "out" / name).read_bytes() == \
            (tmp_path / "plain" / name).read_bytes()


def test_train_cli_traces_the_first_ten_steps(tmp_path):
    """The ten traced steps are the first ten after the first loss read
    (steps 11-20), with their batch waits (ten, and the end of the first
    ten-batch smoke epoch) and the read that ends them; the run goes on
    untraced."""
    assert train_diffusion.main(
        ["--config", "reference", "--smoke", "--device", "cpu",
         "--max-steps", "22", "--trace", str(tmp_path / "trace"),
         "--set", "training.patch_n=2"]
        + [a for kv in TINY for a in ("--set", kv)]) == 0
    names = _annotations(str(tmp_path / "trace"))
    assert names["train.step"] == 10 and names["train.update"] == 10
    assert names["train.data"] == 11 and names["sync.log_read"] == 1


def test_trace_summary_names_idle_gaps_by_program_span(tmp_path, capsys):
    """Kernels at [0, 10), [30, 40), [45, 50) us leave gaps of 20 and 5 us;
    the first's middle (20) lies in ``restore`` and in the shorter
    ``chain.scatter``, which names it; the second's (42.5) only in
    ``restore``.  Host-side annotations on the card's track do not
    count."""
    def x(name, cat, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    events = [x("k1", "kernel", 0, 10), x("copy", "gpu_memcpy", 30, 10),
              x("k2", "kernel", 45, 5), x("k0", "kernel", 2, 3),
              x("restore", "user_annotation", 0, 60),
              x("chain.scatter", "user_annotation", 15, 13),
              x("gpu_only", "gpu_user_annotation", 10, 20)]
    assert trace_summary.idle_gaps(events) == [
        {"us": 20.0, "at_us": 10.0, "span": "chain.scatter"},
        {"us": 5.0, "at_us": 40.0, "span": "restore"}]
    assert trace_summary.idle_gaps(events, top=1)[0]["span"] == \
        "chain.scatter"
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert trace_summary.main([str(tmp_path), "--idle-gaps"]) == 0
    out = capsys.readouterr().out
    assert "== 2 longest idle gaps ==" in out
    assert out.rstrip().splitlines()[-2].split() == ["0.020", "0.0",
                                                    "chain.scatter"]
