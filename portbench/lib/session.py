"""What every runner does the same way: synchronising, reading the peak
memory, loading the input images and profiling a few calls."""

from __future__ import annotations

import contextlib
import glob
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from portbench import registry
from portbench.lib import trace as tr
from portbench.lib.images import load_images

__all__ = ["sync", "reset_peak", "peak_bytes", "load_pairs", "Spans",
           "profile"]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device: torch.device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def load_pairs(wl: dict, clean: bool) -> np.ndarray:
    """The workload's images: (N, H, W, 3) uint8, or (N, H, W, 6)
    [degraded | clean] with ``clean``; cut to the top-left ``size``
    [H, W] where the workload names one (the tests' small runs)."""
    folder = os.path.join(registry.REPO, wl["images"])
    inputs = sorted(glob.glob(os.path.join(folder, "input", "*.png")))
    if not inputs:
        raise FileNotFoundError(f"no input PNGs under {folder}")
    arr = load_images(inputs)
    if clean:
        gts = [os.path.join(folder, "gt", os.path.basename(p))
               for p in inputs]
        arr = np.concatenate([arr, load_images(gts)], axis=-1)
    if "size" in wl:
        h, w = wl["size"]
        arr = arr[:, :h, :w]
    return np.ascontiguousarray(arr)


class Spans:
    """Host spans on the realtime clock, the one the profiler's trace
    counts from (its ``baseTimeNanoseconds``): ``with spans("name"):``."""

    def __init__(self):
        self.done: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.done.append((name, t0, time.time_ns()))


def profile(device: torch.device, call: Callable[[int, Spans], None],
            n: int) -> Dict:
    """Run ``call(i, spans)`` for i < n under ``torch.profiler``,
    synchronised at the end, and summarise the trace (``lib/trace.py``).

    Only the card's activity is recorded (kernels, copies, memsets): the
    host's operator events would cost the host more than the calls it
    makes.  The window runs from just before the first call to the end of
    the last synchronise, on the host's realtime clock."""
    acts = [torch.profiler.ProfilerActivity.CUDA if device.type == "cuda"
            else torch.profiler.ProfilerActivity.CPU]
    spans = Spans()
    sync(device)
    with torch.profiler.profile(activities=acts) as prof:
        begin = time.time_ns()
        for i in range(n):
            call(i, spans)
        with spans("sync"):
            sync(device)
        end = time.time_ns()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
        base = int(data.get("baseTimeNanoseconds", 0))
        us = lambda t: (t - base) / 1e3  # noqa: E731
        summary = tr.summarize(
            data.get("traceEvents", []), tr.Families(registry.families()),
            us(begin), us(end), [(us(a), us(b), nm) for nm, a, b in
                                 spans.done])
    finally:
        os.remove(path)
    summary["calls"] = n
    return summary
