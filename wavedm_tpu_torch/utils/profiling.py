"""Spans, counters, step timing, profiler traces and a JSONL metrics log:
the port's ``wavedm_tpu/utils/profiling.py``.  ``trace`` and ``annotate``
stand where ``xla_trace`` and ``annotate`` stand there, on
``torch.profiler``.

``annotate(name)`` marks a region of the host's work.  It is off unless a
``torch.profiler`` session is recording or a :func:`collect` block is
open, and off it reads one flag and does nothing else.  On, it opens a
``record_function`` (and an NVTX range where a card is present), so the
region shows in Chrome and Nsight traces, and records a :class:`Span` in
memory: its id, the id of the span that holds it on the same thread (0 at
the top), the thread, the name and its start and end on ``time.time_ns()``,
the realtime clock a profiler trace counts from (``baseTimeNanoseconds``),
so program spans and device events share one clock.  :func:`spans`
returns the latest ``SPAN_LIMIT`` of them; nothing is written to disk.

The port's spans (PERF.md's layer table names the metric that reads
each): ``restore`` (all of ``restore_image_device``), ``restore.hfrm``,
``restore.wavelet`` (each DWT and IWT), ``restore.pixel`` (the pixel
path's entry and exit transforms), ``chain.step`` (one a sampling
step) holding ``chain.gather``, ``unet`` (one a UNet call or
micro-batch), ``chain.scatter`` and ``chain.update``; ``train.step``
holding ``train.prepare``, ``train.forward``, ``train.backward`` and
``train.update``; ``train.data`` (the trainer's wait for a batch);
``serve.batch`` (one a served batch); and ``sync.<site>`` around every
point where the program blocks the host until the card catches up.
A profiler records the thread that started it: a span on another thread
reaches :func:`spans` but not the trace.

:func:`count` adds to a cumulative counter of a :class:`Counters`, which
is always on: the server's ``/healthz`` counters, and :data:`CHAIN`, the
sampling chains' steps (``diffusion/sampling.py``): ``chain.steps_run``
and ``chain.steps_after_kept``, the steps run after the one whose x0 the
output keeps (their UNet calls feed nothing).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

from wavedm_tpu_torch.parallel.distributed import is_coordinator

__all__ = ["SPAN_LIMIT", "Span", "StepTimer", "trace", "annotate", "collect",
           "spans", "Counters", "count", "CHAIN", "MetricsLogger"]

SPAN_LIMIT = 1 << 16          # spans kept in memory, the newest


class Span(NamedTuple):
    """One closed span; times in ns on ``time.time_ns()``'s clock.  Its
    first three fields are (name, start, end), as the benchmark's own host
    spans are."""
    name: str
    start: int
    end: int
    id: int
    parent: int               # the id of the span that holds it; 0: none
    thread: int


_SPANS: "deque[Span]" = deque(maxlen=SPAN_LIMIT)
_IDS = itertools.count(1)
_STACK = threading.local()    # .ids: the open spans' ids on this thread
_COLLECTING = [0]             # open collect() blocks
_LOCK = threading.Lock()


class annotate:
    """``with annotate(name):`` a span of the host's work (see the module
    doc); JAX's ``annotate``.  Off it costs about a microsecond."""

    __slots__ = ("name", "_rf", "_nvtx", "_id", "_parent", "_start")

    def __init__(self, name: str):
        self.name = name
        self._rf = None

    def __enter__(self) -> "annotate":
        if not (_COLLECTING[0] or _autograd_profiler._is_profiler_enabled):
            return self
        stack = getattr(_STACK, "ids", None)
        if stack is None:
            stack = _STACK.ids = []
        self._parent = stack[-1] if stack else 0
        self._id = next(_IDS)
        stack.append(self._id)
        self._nvtx = torch.cuda.is_available()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        # each clock read sits next to the profiler's own, so a span and its
        # ``user_annotation`` event agree to a few microseconds
        self._start = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self._rf is None:
            return False
        self._rf.__exit__(*exc)
        end = time.time_ns()
        self._rf = None
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        _STACK.ids.pop()
        _SPANS.append(Span(self.name, self._start, end, self._id,
                           self._parent, threading.get_ident()))
        return False


# A process's first ``record_function`` costs about a millisecond of set-up:
# paid here, with no profiler on, not inside the first span one records.
with torch.profiler.record_function("profiling.warm-up"):
    pass


@contextlib.contextmanager
def collect() -> Iterator[None]:
    """Turn spans on for the block without a profiler (they are on anyway
    while one records)."""
    with _LOCK:
        _COLLECTING[0] += 1
    try:
        yield
    finally:
        with _LOCK:
            _COLLECTING[0] -= 1


def spans() -> List[Span]:
    """The closed spans, oldest first (at most ``SPAN_LIMIT``)."""
    return list(_SPANS)


class Counters(dict):
    """Cumulative named counts, safe to add to from several threads."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.lock = threading.Lock()


def count(name: str, n: float = 1, *, into: Counters) -> None:
    """Add ``n`` to the counter ``name`` of ``into``."""
    with into.lock:
        into[name] = into.get(name, 0) + n


# the sampling chains' steps since the process started (see the module doc)
CHAIN = Counters({"chain.steps_run": 0, "chain.steps_after_kept": 0})


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
