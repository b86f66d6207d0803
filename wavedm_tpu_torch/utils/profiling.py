"""Step timing, profiler traces and a JSONL metrics log: the port's
``wavedm_tpu/utils/profiling.py``.  ``trace`` and ``annotate`` stand where
``xla_trace`` and ``annotate`` stand there, on ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import deque
from typing import Dict, Iterator, Optional

import torch

from wavedm_tpu_torch.parallel.distributed import is_coordinator

__all__ = ["StepTimer", "trace", "annotate", "MetricsLogger"]


class StepTimer:
    """Rolling per-step wall times.  ``stop(sync_on=t)`` waits for the
    card first when ``t`` is a CUDA tensor, so a step's time includes its
    device work."""

    def __init__(self, window: int = 50):
        self.times = deque(maxlen=window)
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, sync_on: Optional[torch.Tensor] = None) -> float:
        if sync_on is not None and sync_on.is_cuda:
            torch.cuda.synchronize(sync_on.device)
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0

    def throughput(self, items_per_step: int) -> float:
        return items_per_step / self.mean if self.mean else 0.0


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block with ``torch.profiler`` (the CPU, and CUDA when a
    card is present) and write its Chrome/Perfetto trace to
    ``log_dir/trace.json``; the counterpart of JAX's ``xla_trace``.
    Yields the profiler (its ``key_averages()`` for sums by op)."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region in profiler traces (``record_function``), and an
    NVTX range where a card is present; JAX's ``annotate``."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


class MetricsLogger:
    """Append-only JSONL metrics log: one {"step", "time", **metrics}
    object a line, written by rank 0 alone (a no-op on the other ranks of a
    process group, as JAX's is on processes other than 0)."""

    def __init__(self, path: str):
        self.path = path
        self.enabled = is_coordinator()
        if self.enabled:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(self, step: int, **metrics: float) -> None:
        if not self.enabled:
            return
        rec: Dict = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
