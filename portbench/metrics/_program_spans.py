"""The program's own spans of a traced run, per traced call: what the
``*_host_ms.restore`` and ``*_host_ms.train`` metrics read.

The port records a span (``wavedm_tpu_torch.utils.profiling.spans()``)
only while a profiler records, so the spans there are those of the traced
calls: the last ``rec["trace"]["calls"]`` top-level ``restore`` (or
``train.step``) spans are the traced calls, and each one's descendants
are found by parent id.  Every time carries the profiler's own host cost,
as every traced metric does.  A program that records no spans (one
without ``profiling.spans``) gives None, and so does one whose span tree
has not the shape the metrics split: a restore call without a
``chain.step``, a ``chain.step`` without a ``unet`` under it, a train step
without one of its four phases, or a call whose span counts differ from
another call's.  A span moved or taken out then reads as nothing, not as
time shifted from one metric to another.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict, List, Optional

__all__ = ["calls", "restore_calls", "train_steps", "mean"]

# {span every call holds: the span each of them holds, or None}
RESTORE_SHAPE = {"chain.step": "unet"}
TRAIN_SHAPE = {"train.prepare": None, "train.forward": None,
               "train.backward": None, "train.update": None}


def calls(rec: dict, kind: str, root: str,
          shape: Dict[str, Optional[str]]) -> Optional[List[Dict]]:
    """For each traced call of a ``kind`` run (``restore`` or ``train``),
    ``{"ms": root span, "sync_ms": its sync.* spans, "spans": {name:
    [(ms, sync ms inside), ...]}}``; None where there is nothing to read
    or the calls do not have ``shape`` (see the module doc).  A ``sync.*``
    span inside another is counted in neither ``sync_ms`` nor its holder's
    sync ms a second time."""
    tr = rec.get("trace")
    if rec.get("kind") != kind or tr is None or not tr.get("calls"):
        return None
    try:
        from wavedm_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    recs = spans()
    roots = [s for s in recs if s.name == root and s.parent == 0]
    roots = roots[-tr["calls"]:]
    if len(roots) < tr["calls"]:
        return None
    children = defaultdict(list)
    for s in recs:
        children[s.parent].append(s)

    def below(span) -> List:
        out, todo = [], list(children[span.id])
        while todo:
            s = todo.pop()
            out.append(s)
            todo.extend(children[s.id])
        return out

    def sync_ms(span) -> float:
        # the sync.* spans under ``span``, outermost ones only
        total = 0.0
        for c in children[span.id]:
            total += (ms(c) if c.name.startswith("sync.") else sync_ms(c))
        return total

    out, counts = [], []
    for r in roots:
        found = defaultdict(list)
        for s in below(r):
            found[s.name].append(s)
        for name, inner in shape.items():
            if not found.get(name) or inner and not all(
                    any(d.name == inner for d in below(s))
                    for s in found[name]):
                return None
        counts.append(Counter({n: len(v) for n, v in found.items()}))
        out.append(dict(ms=ms(r), sync_ms=sync_ms(r),
                        spans=defaultdict(list, {
                            n: [(ms(s), sync_ms(s)) for s in v]
                            for n, v in found.items()})))
    if any(c != counts[0] for c in counts):
        return None
    return out


def restore_calls(rec: dict) -> Optional[List[Dict]]:
    """:func:`calls` of a restore run's traced ``restore`` spans."""
    return calls(rec, "restore", "restore", RESTORE_SHAPE)


def train_steps(rec: dict) -> Optional[List[Dict]]:
    """:func:`calls` of a training run's traced ``train.step`` spans."""
    return calls(rec, "train", "train.step", TRAIN_SHAPE)


def ms(span) -> float:
    return (span.end - span.start) / 1e6


def mean(values) -> Optional[float]:
    values = list(values)
    return sum(values) / len(values) if values else None
