"""Reading a ``torch.profiler`` trace: device busy time as a union of
intervals, time by kernel family, and the idle gaps with what the host did.

The trace is the Chrome JSON that ``export_chrome_trace`` writes.  Device
operations are its complete (``X``) events of category ``kernel``,
``gpu_memcpy`` or ``gpu_memset``, clipped to the window the caller gives;
the host spans are the benchmark's own (``lib/session.py``).
"""

from __future__ import annotations

import collections
import re
from typing import Dict, List, Optional, Sequence, Tuple

from portbench.lib.stats import gaps, union_length

__all__ = ["DEVICE_CATS", "Families", "summarize"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Families:
    """The ranked family files: the first whose ``cat`` equals an event's
    category, or whose ``pattern`` is found in its name, names its
    family; ``other`` where none does."""

    def __init__(self, fams: Sequence[Dict]):
        self.fams = []
        for f in fams:
            rx = None
            if "pattern" in f:
                rx = re.compile(f["pattern"],
                                re.IGNORECASE if f.get("ignore_case") else 0)
            self.fams.append((f["name"], f.get("cat"), rx))
        self.conv = {f["name"] for f in fams if f.get("conv")}

    def of(self, name: str, cat: str = "kernel") -> str:
        for fam, fcat, rx in self.fams:
            if fcat is not None and fcat == cat:
                return fam
            if rx is not None and rx.search(name):
                return fam
        return "other"


def _span(e: dict) -> Tuple[float, float]:
    t = float(e["ts"])
    return t, t + float(e.get("dur", 0.0))


def _innermost(spans: List[Tuple[float, float, str]], t: float
               ) -> Optional[str]:
    best = None
    for a, b, name in spans:
        if a <= t < b and (best is None or b - a < best[0]):
            best = (b - a, name)
    return None if best is None else best[1]


def summarize(events: List[dict], families: Families, lo: float, hi: float,
              spans: List[Tuple[float, float, str]], top: int = 10) -> Dict:
    """Over the window [lo, hi] (microseconds on the trace's clock), in
    seconds: ``window_s``, ``busy_s`` (the union of device operations),
    ``family_s`` and ``conv_s`` (sums of durations), ``device_ops`` (the
    ``top`` operations by time, named ``family | kernel``) and
    ``idle_gaps`` (the ``top`` longest idle stretches, named by the host
    span running at their middle, ``spans`` being (start, end, name))."""
    dev = []
    family_us = collections.Counter()
    op_us = collections.Counter()
    for e in events:
        cat = e.get("cat", "")
        if e.get("ph") != "X" or cat not in DEVICE_CATS:
            continue
        a, b = _span(e)
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        name = e.get("name", "?")
        dev.append((a, b))
        fam = families.of(name, cat)
        family_us[fam] += b - a
        op_us[f"{fam} | {name[:160]}"] += b - a
    idle = sorted(gaps(dev, lo, hi), key=lambda g: g[0] - g[1])[:top]
    return dict(
        window_s=(hi - lo) * 1e-6,
        busy_s=union_length(dev, lo, hi) * 1e-6,
        family_s={k: v * 1e-6 for k, v in family_us.items()},
        conv_s=sum(v for k, v in family_us.items()
                   if k in families.conv) * 1e-6,
        device_ops=[[k, v * 1e-6] for k, v in op_us.most_common(top)],
        idle_gaps=[[_innermost(spans, (a + b) / 2) or "none", (b - a) * 1e-6]
                   for a, b in idle])
