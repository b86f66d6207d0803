"""PyTorch port: ``utils/profiling.py`` against the JAX package's
(``StepTimer.throughput``), and the torch.profiler counterparts of its
``xla_trace`` and ``annotate`` on the CPU: a trace file that holds the
annotated region."""

import json
import os

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
