"""PyTorch port: ``utils/profiling.py`` against the JAX package's
(``StepTimer.throughput``), and the torch.profiler counterparts of its
``xla_trace`` and ``annotate`` on the CPU: a trace file that holds the
annotated region.  Then the port's own spans: off without a profiler or a
``collect()`` block, nested by thread when on, kept in a bounded store,
on the trace's clock; and the counters."""

import json
import os
import threading
from collections import deque

import pytest
import torch

from wavedm_tpu.utils import profiling as jax_profiling

from wavedm_tpu_torch.utils import profiling


@pytest.mark.parametrize("times", [[], [0.5], [0.25, 0.75, 0.5]],
                         ids=["none", "one", "three"])
def test_throughput_matches_jax(times):
    ours, theirs = profiling.StepTimer(), jax_profiling.StepTimer()
    for timer in (ours, theirs):
        timer.times.extend(times)
    assert ours.throughput(16) == theirs.throughput(16)
    assert ours.mean == theirs.mean


def test_trace_writes_the_annotated_region(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir) as prof:
        with profiling.annotate("wavedm_step"):
            torch.ones(64, 64).matmul(torch.ones(64, 64))
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "wavedm_step" in names
    assert any("matmul" in (n or "") or "mm" == n for n in names)
    assert "wavedm_step" in {e.key for e in prof.key_averages()}


def test_annotate_outside_a_trace_is_a_plain_block():
    with profiling.annotate("idle"):
        x = torch.arange(3).sum()
    assert int(x) == 3


# ------------------------------------------------------------------ spans

@pytest.fixture
def fresh_spans(monkeypatch):
    """An empty span store for the test (the module keeps one a process)."""
    store = deque(maxlen=profiling.SPAN_LIMIT)
    monkeypatch.setattr(profiling, "_SPANS", store)
    return store


def test_annotate_off_records_nothing_and_builds_no_record_function(
        fresh_spans, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built while off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with profiling.annotate("outer"):
        with profiling.annotate("inner"):
            x = torch.arange(3).sum()
    assert int(x) == 3 and profiling.spans() == []


def _nested_in_threads():
    """Two threads, each an ``outer`` span holding two ``inner`` spans."""
    barrier = threading.Barrier(2)

    def work():
        with profiling.annotate("outer"):
            barrier.wait()
            for _ in range(2):
                with profiling.annotate("inner"):
                    torch.ones(8).sum()
            barrier.wait()

    threads = [threading.Thread(target=work) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)


@pytest.mark.parametrize("mode", ["profiler", "collect"])
def test_spans_nest_by_thread(fresh_spans, mode):
    """Under a CPU profiler and under ``collect()`` alike, each span's
    parent is the span open around it on its own thread, though the two
    threads' spans interleave in time."""
    if mode == "profiler":
        ctx = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])
    else:
        ctx = profiling.collect()
    with ctx:
        _nested_in_threads()
    got = profiling.spans()
    assert sorted(s.name for s in got) == ["inner"] * 4 + ["outer"] * 2
    outers = {s.thread: s for s in got if s.name == "outer"}
    assert len(outers) == 2 and all(s.parent == 0 for s in outers.values())
    for s in got:
        if s.name == "inner":
            holder = outers[s.thread]
            assert s.parent == holder.id
            assert holder.start <= s.start <= s.end <= holder.end
    # off again once the block has closed
    with profiling.annotate("after"):
        pass
    assert len(profiling.spans()) == 6


def test_span_store_is_bounded(fresh_spans):
    with profiling.collect():
        for _ in range(profiling.SPAN_LIMIT + 5):
            with profiling.annotate("s"):
                pass
    got = profiling.spans()
    assert len(got) == profiling.SPAN_LIMIT
    ids = [s.id for s in got]
    assert ids == list(range(ids[0], ids[0] + profiling.SPAN_LIMIT))


def _trace_gaps(tmp_path, attempt):
    """(start, end) gaps in us of every span against its
    ``user_annotation`` in the exported trace, on the trace's clock."""
    log_dir = str(tmp_path / f"trace{attempt}")
    with profiling.trace(log_dir):
        for i in range(3):
            with profiling.annotate(f"outer{i}"):
                with profiling.annotate(f"inner{i}"):
                    torch.ones(64, 64).matmul(torch.ones(64, 64))
    with open(os.path.join(log_dir, "trace.json")) as f:
        data = json.load(f)
    base = int(data["baseTimeNanoseconds"])
    events = {e["name"]: e for e in data["traceEvents"]
              if e.get("cat") == "user_annotation"}
    gaps = []
    for s in profiling.spans()[-6:]:
        e = events[s.name]
        gaps.append((abs((s.start - base) / 1e3 - e["ts"]),
                     abs((s.end - base) / 1e3 - e["ts"] - e["dur"])))
    return gaps


def test_spans_match_the_trace_clock(fresh_spans, tmp_path):
    """Every in-memory span matches its ``user_annotation`` event within
    50 us at both ends: both are on the trace's clock.  A clock read can be
    delayed by a busy machine's scheduler, so three traces are taken at
    most and one must hold every span within the bound."""
    worst = None
    for attempt in range(3):
        gaps = _trace_gaps(tmp_path, attempt)
        assert len(gaps) == 6
        worst = max(max(g) for g in gaps)
        if worst <= 50.0:
            break
    assert worst <= 50.0, gaps


def test_count_adds_from_threads():
    c = profiling.Counters(hits=0)

    def add():
        for _ in range(1000):
            profiling.count("hits", into=c)
            profiling.count("ms", 0.5, into=c)

    threads = [threading.Thread(target=add) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert c == {"hits": 4000, "ms": 2000.0}
