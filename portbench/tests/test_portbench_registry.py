"""Every part of the benchmark is a file found by the name
``BENCHMARK.json`` gives it, and a new file is picked up without an edit;
``BENCHMARK.json`` keeps to the shape its readers expect."""

import json
import os
import re
import shutil

import pytest

from portbench import registry

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_every_file_is_found_by_name():
    for c in BENCH["configs"]:
        conf = registry.config(c["name"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert sorted(conf["reduced"]) == sorted(c["reduced"])
    for w in BENCH["workloads"]:
        wl = registry.workload(w["traffic"])
        assert wl["config"] == w["config"]
        assert hasattr(registry.runner(wl["runner"]), "run")
    for m in METRICS:
        assert callable(registry.metric(m["name"]).read)
    fams = registry.families()
    assert [f["name"] for f in fams][:2] == ["memcpy", "memset"]
    assert {"fused_conv", "cudnn_conv", "cudnn_fft_conv"} <= {
        f["name"] for f in fams if f.get("conv")}


def test_a_new_file_is_picked_up(tmp_path):
    root = tmp_path / "portbench"
    shutil.copytree(registry.ROOT, root,
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    (root / "families" / "my_conv.json").write_text(json.dumps(
        {"rank": 25, "pattern": "my_conv_kernel", "conv": True}))
    (root / "metrics" / "calls.restore.py").write_text(
        "def read(rec):\n    return rec['n_calls']\n")
    (root / "workloads" / "restore_prod_b2.json").write_text(json.dumps(
        dict(registry.workload("restore_prod_b8", str(root)), batch=2)))
    fams = registry.families(str(root))
    assert "my_conv" in [f["name"] for f in fams]
    assert registry.metric("calls.restore", str(root)).read(
        {"n_calls": 7}) == 7
    assert registry.workload("restore_prod_b2", str(root))["batch"] == 2
    with pytest.raises(FileNotFoundError):
        registry.workload("restore_prod_b3", str(root))
    with pytest.raises(ValueError):
        registry.metric("../harness", str(root))


def test_benchmark_json_shape():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = {w["name"] for w in BENCH["workloads"]}
    names = ([c["name"] for c in BENCH["configs"]] + list(cells)
             + [m["name"] for m in METRICS])
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.isfile(os.path.join(registry.REPO, c["file"]))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e[
        "setup_s"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for cell in cells:
        reported = [m for m in BENCH["end_to_end"]
                    if cell in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])
    assert len(json.dumps(BENCH)) < 64 * 1024
