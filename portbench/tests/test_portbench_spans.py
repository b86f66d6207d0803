"""The seven metrics that read the program's own spans: positive in the
cells their ``workloads`` name and absent elsewhere, the four restore
metrics making up the ``restore`` span, and nothing read (no error
either) from a program that records no spans or whose span tree has
moved."""

import contextlib
import statistics

import pytest

from portbench import registry
from portbench.harness import _metrics
from portbench_tiny import tiny_run
from wavedm_tpu_torch.diffusion import sampling
from wavedm_tpu_torch.utils import profiling

BENCH = registry.benchmark()
SPAN_METRICS = [m for m in BENCH["per_layer"]
                if m["name"].split(".")[0] in (
                    "unet_host_ms", "chain_host_ms", "entry_host_ms",
                    "sync_wait_ms", "prepare_host_ms", "fwd_bwd_host_ms",
                    "update_host_ms")]
RESTORE = ["unet_host_ms.restore", "chain_host_ms.restore",
           "entry_host_ms.restore", "sync_wait_ms.restore"]
TRAIN = ["prepare_host_ms.train", "fwd_bwd_host_ms.train",
         "update_host_ms.train"]


@pytest.fixture(scope="module")
def traced():
    """A tiny traced run of a restore cell and of a training cell: each
    result and the program's spans after it."""
    out = {}
    for cell in ("restore_prod_b1", "train_prod_b16"):
        res = tiny_run(cell, trace=True)
        out[cell] = (res, profiling.spans())
    return out


def test_the_seven_are_declared():
    assert sorted(m["name"] for m in SPAN_METRICS) == sorted(RESTORE + TRAIN)
    for m in SPAN_METRICS:
        assert (m["source"], m["unit"], m["better"]) == (
            "program_span", "ms", "lower")
        kind = "restore" if m["name"] in RESTORE else "train"
        assert all(c.startswith(kind) for c in m["workloads"])


@pytest.mark.parametrize("cell", ["restore_prod_b1", "train_prod_b16"])
def test_each_reads_positive_in_its_cells_only(traced, cell):
    res, _ = traced[cell]
    assert res["correct"]
    want = RESTORE if cell.startswith("restore") else TRAIN
    got = {n: v["value"] for n, v in res["metrics"].items()
           if n in RESTORE + TRAIN}
    assert sorted(got) == sorted(want)
    # sync_wait_ms may read a few microseconds on the CPU, never 0 or less
    assert all(v > 0 for v in got.values()), got


def test_the_restore_metrics_make_up_the_restore_span(traced):
    """The UNet's host time times the UNet calls, the chain's, the entry's
    and the syncs' make up the traced calls' mean ``restore`` span."""
    res, spans = traced["restore_prod_b1"]
    m = {n: v["value"] for n, v in res["metrics"].items()}
    roots = [s for s in spans if s.name == "restore" and s.parent == 0]
    assert len(roots) == 2                      # portbench_tiny's calls
    restore_ms = statistics.fmean((s.end - s.start) / 1e6 for s in roots)
    unets_a_call = sum(s.name == "unet" for s in spans) / len(roots)
    total = (m["unet_host_ms.restore"] * unets_a_call
             + m["chain_host_ms.restore"] + m["entry_host_ms.restore"]
             + m["sync_wait_ms.restore"])
    assert total == pytest.approx(restore_ms, rel=1e-9)


def test_nothing_is_read_without_program_spans(traced, monkeypatch):
    """A program without ``profiling.spans`` (one from before the spans)
    reads None in every cell, and the line leaves the seven out."""
    monkeypatch.delattr(profiling, "spans")
    bench = dict(BENCH, per_layer=SPAN_METRICS)
    for cell, (res, _) in traced.items():
        record = dict(kind=cell.split("_")[0], trace={"calls": 2})
        for m in SPAN_METRICS:
            assert registry.metric(m["name"]).read(record) is None
        assert _metrics(bench, cell, record, True) == {}


def test_nothing_is_read_untraced():
    for m in SPAN_METRICS:
        for kind in ("restore", "train"):
            assert registry.metric(m["name"]).read(
                dict(kind=kind, trace=None)) is None


def test_a_moved_unet_span_reads_nothing(monkeypatch):
    """A UNet call that enters no ``unet`` span (a later path that moves
    it) leaves every restore metric unread, not its time in the chain's."""
    real = sampling.annotate
    monkeypatch.setattr(sampling, "annotate", lambda name: (
        contextlib.nullcontext() if name == "unet" else real(name)))
    res = tiny_run("restore_prod_b1", trace=True)
    assert res["correct"]
    assert not set(RESTORE) & set(res["metrics"])
    record = dict(kind="restore", trace={"calls": 2})
    for name in RESTORE:
        assert registry.metric(name).read(record) is None


def _span(name, i, parent, start, end):
    return profiling.Span(name, start, end, i, parent, 1)


@pytest.mark.parametrize("fault", ["counts", "phase", "none"])
def test_the_span_tree_is_checked(monkeypatch, fault):
    """Two traced steps read only while each holds all four phases and
    both hold the same spans; a step with an extra ``sync.*`` or
    without its update reads nothing."""
    steps = []
    for k, t in enumerate((0, 100)):
        root = 10 * k + 1
        steps.append(_span("train.step", root, 0, t, t + 50))
        for j, name in enumerate(("train.prepare", "train.forward",
                                  "train.backward", "train.update")):
            if fault == "phase" and k and name == "train.update":
                continue
            steps.append(_span(name, root + 1 + j, root, t + 10 * j,
                               t + 10 * j + 5))
    if fault == "counts":
        steps.append(_span("sync.extra", 99, 11, 110, 111))
    monkeypatch.setattr(profiling, "spans", lambda: steps)
    record = dict(kind="train", trace={"calls": 2})
    got = [registry.metric(n).read(record) for n in TRAIN]
    if fault == "none":
        assert got == [5e-6, 1e-5, 5e-6]
    else:
        assert got == [None] * 3
