"""Step timing and a JSONL metrics log (the port's copies of
``StepTimer`` and ``MetricsLogger`` from ``wavedm_tpu/utils/profiling.py``).
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Dict, Optional

import torch

from wavedm_tpu_torch.parallel.distributed import is_coordinator

__all__ = ["StepTimer", "MetricsLogger"]


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
