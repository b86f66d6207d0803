"""Summarize a torch.profiler trace: device time by category and top kernels.

Usage: python -m wavedm_tpu_torch.tools.trace_summary <trace_dir> [--top 25]
           [--idle-gaps]

<trace_dir> is the directory ``utils/profiling.trace`` wrote its Chrome
trace to (``trace.json``), or one holding torch's ``*.pt.trace.json`` /
``*.pt.trace.json.gz`` (``torch.profiler.tensorboard_trace_handler``), or
the trace file itself.  Device time is the duration of the complete
(``X``) events whose ``cat`` is ``kernel``, ``gpu_memcpy`` or
``gpu_memset``.  Prints a by-category table (each of the port's kernel
families, then cuDNN/CUTLASS convolution, gemm, softmax, elementwise,
reduce, memcpy, memset, nccl, other) and the top individual kernels, so a
regression can be attributed without a trace viewer; exits 1 when the
trace holds no device events (naming the event categories it did hold).
``--idle-gaps`` adds the 10 longest stretches between the first and the
last device event in which no kernel, copy or memset ran, each named by the
innermost program span (a ``user_annotation`` event: ``utils/profiling``'s
``annotate``) running on the host at its middle, so an idle card can be put
down to what the host was doing.

The port's counterpart of the JAX package's ``tools/trace_summary.py``:
busy time and top ops read alike; the categories are CUDA kernel names,
not HLO ones.
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import re
import sys
from typing import Dict, List, Optional

__all__ = ["DEVICE_CATS", "FAMILIES", "CATEGORIES", "find_trace",
           "load_events", "category", "summarize", "idle_gaps", "main"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

# the port's kernel families (csrc/*.cu): (category, its kernels, the one
# kernel that each wrapper launch runs exactly once)
FAMILIES = (
    ("wavelet", r"\bwavelet_(dec|rec)_kernel\b",
     r"\bwavelet_(dec|rec)_kernel\b"),
    ("group_norm", r"\bgroup_norm_(onchip|stream)_kernel\b",
     r"\bgroup_norm_(onchip|stream)_kernel\b"),
    ("fused_conv", r"\b(conv_kernel|gn_affine_kernel|splitk_reduce_kernel)\b",
     r"\bconv_kernel\b"),
)
# then, first match wins (case-insensitive)
CATEGORIES = (
    ("cudnn/cutlass conv", r"cudnn|conv|fprop|dgrad|wgrad"),
    ("gemm", r"gemm|cublas|cutlass|matmul|xmma|wgmma"),
    ("softmax", r"softmax"),
    ("nccl", r"nccl"),
    ("reduce", r"reduce|moments|norm"),
    ("elementwise", r"elementwise|catarray|fill|copy"),
)


def find_trace(trace_dir: str) -> str:
    if os.path.isfile(trace_dir):
        return trace_dir
    direct = os.path.join(trace_dir, "trace.json")
    if os.path.isfile(direct):
        return direct
    for pat in ("*.pt.trace.json", "*.pt.trace.json.gz"):
        hits = sorted(glob.glob(os.path.join(trace_dir, "**", pat),
                                recursive=True))
        if hits:
            return hits[-1]
    raise FileNotFoundError(
        f"no trace.json or *.pt.trace.json[.gz] under {trace_dir}")


def load_events(path: str) -> List[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data.get("traceEvents", []) if isinstance(data, dict) else data


def category(event: dict) -> str:
    """The category of one device event."""
    cat = event.get("cat", "")
    if cat == "gpu_memcpy":
        return "memcpy"
    if cat == "gpu_memset":
        return "memset"
    name = event.get("name", "")
    for fam, pattern, _ in FAMILIES:
        if re.search(pattern, name):
            return fam
    for cat_name, pattern in CATEGORIES:
        if re.search(pattern, name, re.IGNORECASE):
            return cat_name
    return "other"


def summarize(path: str, top: int = 25) -> Dict:
    """The trace's device events in sums, in microseconds as the trace
    gives them: ``busy_us`` (their durations' sum), ``by_category`` and
    ``top`` ([name, us], most first; ``top_n`` asked for), each family's
    ``events``, ``launch_events`` (its launch kernel's) and ``us``, and
    the event categories ``seen``."""
    events = load_events(path)
    op_time = collections.Counter()
    cat_time = collections.Counter()
    families = {fam: dict(events=0, launch_events=0, us=0.0)
                for fam, _, _ in FAMILIES}
    launch = {fam: pattern for fam, _, pattern in FAMILIES}
    total = 0.0
    n = 0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        dur = float(e.get("dur", 0.0))          # microseconds
        name = e.get("name", "?")
        op_time[name] += dur
        total += dur
        n += 1
        cat = category(e)
        cat_time[cat] += dur
        if cat in families:
            fam = families[cat]
            fam["events"] += 1
            fam["us"] += dur
            fam["launch_events"] += bool(re.search(launch[cat], name))
    return dict(path=path, events=n, busy_us=total,
                by_category=[list(kv) for kv in cat_time.most_common(15)],
                top=[list(kv) for kv in op_time.most_common(top)],
                top_n=top, families=families,
                seen=sorted({str(e.get("cat")) for e in events
                             if "cat" in e}))


def idle_gaps(events: List[dict], top: int = 10) -> List[Dict]:
    """The ``top`` longest idle stretches of the card, longest first:
    ``us`` (its length), ``at_us`` (its start after the first device
    event's) and ``span`` (the innermost ``user_annotation`` holding its
    middle, or None)."""
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                 for e in events
                 if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    gaps, end = [], None
    for a, b in dev:
        if end is not None and a > end:
            gaps.append((a - end, end))
        end = b if end is None else max(end, b)
    gaps = sorted(gaps, reverse=True)[:top]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
              e.get("name", "?")) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    out = []
    for length, start in gaps:
        mid = start + length / 2
        held = [(b - a, name) for a, b, name in spans if a <= mid < b]
        out.append(dict(us=length, at_us=start - dev[0][0],
                        span=min(held)[1] if held else None))
    return out


def report(s: Dict) -> Optional[str]:
    """JAX's lines, or None when there are no device events."""
    if not s["events"]:
        return None
    total = s["busy_us"]
    lines = [f"trace: {s['path']}", f"device busy time: {total / 1e3:.1f} ms",
             "", "== by category =="]
    lines += [f"{t / 1e3:10.1f} ms  {100 * t / total:5.1f}%  {name}"
              for name, t in s["by_category"]]
    lines += ["", f"== top {s['top_n']} ops =="]
    lines += [f"{t / 1e3:10.1f} ms  {100 * t / total:5.1f}%  {name[:110]}"
              for name, t in s["top"]]
    if s.get("idle_gaps") is not None:
        lines += ["", f"== {len(s['idle_gaps'])} longest idle gaps ==",
                  "    gap ms    at ms  host span at its middle"]
        lines += [f"{g['us'] / 1e3:10.3f} {g['at_us'] / 1e3:8.1f}  "
                  f"{g['span'] or '(no program span)'}"
                  for g in s["idle_gaps"]]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace_dir")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--idle-gaps", action="store_true",
                    help="the 10 longest idle gaps, named by the program "
                    "span at their middle")
    args = ap.parse_args(argv)
    path = find_trace(args.trace_dir)
    s = summarize(path, args.top)
    if args.idle_gaps:
        s["idle_gaps"] = idle_gaps(load_events(path))
    text = report(s)
    if text is None:
        print("no device events found; event categories seen:", s["seen"])
        return 1
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
