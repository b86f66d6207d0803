"""Where the benchmark finds each of its parts, by name.

Every configuration, traffic mix, metric, kernel-name family and runner
is a file of its own under the benchmark's directory, found by the name
``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the configuration (the port's schema under
  ``config``, with ``source``, ``published``, ``reduced``, ``assumed``
  and ``precision``);
- ``workloads/<cell>.json``: the traffic mix of one cell (its ``runner``,
  batch, inputs, seeds' uses and correctness limits);
- ``metrics/<metric>.py``: a ``read(record)`` returning the metric's
  value, or None where the record holds nothing to read;
- ``families/<family>.json``: one family of device operations (a kernel
  name pattern or a trace category), ranked: the first that matches
  names an operation;
- ``runners/<runner>.py``: a ``run(ctx)`` that drives the program.

A later change adds a part by adding its file and its entry, without
editing any file already here.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from types import ModuleType
from typing import Dict, List

__all__ = ["ROOT", "REPO", "NAME", "benchmark", "config", "workload",
           "metric", "families", "runner"]

ROOT = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _path(root: str, kind: str, name: str, ext: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = os.path.join(root, kind, name + ext)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return path


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: str, label: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(label, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(repo: str = REPO) -> dict:
    return _json(os.path.join(repo, "BENCHMARK.json"))


def config(name: str, root: str = ROOT) -> dict:
    return _json(_path(root, "configs", name, ".json"))


def workload(name: str, root: str = ROOT) -> dict:
    return _json(_path(root, "workloads", name, ".json"))


def metric(name: str, root: str = ROOT) -> ModuleType:
    return _module(_path(root, "metrics", name, ".py"),
                   "portbench_metric_" + re.sub(r"\W", "_", name))


def runner(name: str, root: str = ROOT) -> ModuleType:
    return _module(_path(root, "runners", name, ".py"),
                   "portbench_runner_" + name)


def families(root: str = ROOT) -> List[Dict]:
    """Every family file, in rank order, each with its ``name``."""
    out = []
    folder = os.path.join(root, "families")
    for fn in sorted(os.listdir(folder)):
        if fn.endswith(".json"):
            fam = _json(os.path.join(folder, fn))
            fam["name"] = fn[:-len(".json")]
            out.append(fam)
    return sorted(out, key=lambda f: (f["rank"], f["name"]))
