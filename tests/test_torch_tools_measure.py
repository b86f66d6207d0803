"""PyTorch port: the measuring tools (``wavedm_tpu_torch/tools/roofline.py``,
``trace_summary.py``, ``train_mfu.py``) on the CPU at a small width, against
the JAX tools' contracts.

- ``train_mfu --device cpu`` prints one JSON line with every key of the JAX
  tool's (its ``--cpu`` key ``backend_used_for_flop_count`` becomes
  ``device_used_for_flop_count``), plus ``train_xla_flops_per_step``; the
  flops are ``utils/work.count_work``'s of the same step.
- ``roofline`` runs end to end through each route, prints JAX's lines
  (no MFU lines on a device without known peaks) and the same flops under
  every route; with peaks its bound and MFU follow JAX's formulas.
- ``trace_summary`` reads the same device events written in the port's
  Chrome format and in JAX's perfetto format: busy time and top ops print
  as the JAX tool prints them; a trace with no device events exits 1.

Torch runs on one thread here (``one_torch_thread``).
"""

import gzip
import json
import os
import re
import sys

import pytest
import torch

from wavedm_tpu_torch.tools import roofline, trace_summary, train_mfu
from wavedm_tpu_torch.utils.profiling import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--set", "model.ch=32", "--set", "model.ch_mult=[1,2]",
        "--set", "model.num_res_blocks=1", "--set",
        "model.attn_resolutions=[8]", "--set", "data.image_size=16",
        "--set", "data.patch_size=64"]
TINY_HFRM = ["--set", "hfrm.dim=8", "--set", "hfrm.enc_blk_nums=[1,1]",
             "--set", "hfrm.dec_blk_nums=[1,1]", "--set",
             "hfrm.middle_blk_num=1"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one thread here: the suite runs several pytest-xdist
    workers on a few cores, where these small ops on a thread per core in
    every worker run ~100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _out(capsys, fn, argv):
    capsys.readouterr()
    rc = fn(argv)
    return rc, capsys.readouterr().out


# ------------------------------------------------------------- train_mfu


def _jax_keys():
    """The keys of the JSON line JAX's ``tools/train_mfu.py`` prints."""
    with open(os.path.join(REPO, "tools", "train_mfu.py")) as f:
        src = f.read()
    block = src[src.index("json.dumps({"):]
    block = block[:block.index("}))")]
    return set(re.findall(r'"(\w+)":', block))


@pytest.mark.parametrize("peak", [None, 1e12])
def test_train_mfu_prints_jax_keys(capsys, peak):
    argv = (["--step-time", "0.5", "--device", "cpu", "--batch-size", "1",
             "--set", "training.patch_n=2"] + TINY + TINY_HFRM
            + (["--peak", str(peak)] if peak else []))
    rc, out = _out(capsys, train_mfu.main, argv)
    assert rc == 0
    line = json.loads(out.splitlines()[-1])
    jax_keys = _jax_keys()
    assert "backend_used_for_flop_count" in jax_keys and len(jax_keys) == 8
    want = (jax_keys - {"backend_used_for_flop_count"}) | {
        "device_used_for_flop_count", "train_xla_flops_per_step"}
    assert want <= set(line), sorted(want - set(line))
    assert line["batch"] == [2, 64, 64, 6]
    assert line["compute_dtype"] == "float32"
    assert line["device_used_for_flop_count"] == "cpu"
    assert line["achieved_flops_per_s"] == line["train_flops_per_step"] / 0.5
    assert line["peak_flops_per_s"] == peak
    if peak:
        assert line["train_mfu"] == round(
            line["train_flops_per_step"] / 0.5 / peak, 4)
    else:
        assert line["train_mfu"] is None
    # the count is count_work's of the same step
    from wavedm_tpu_torch.config import load_config

    cfg = load_config(train_mfu.CONFIG, [a for a in TINY + TINY_HFRM
                                         if a != "--set"]
                      + ["training.patch_n=2", "training.batch_size=1"])
    w, shape = train_mfu.count_step(cfg, torch.device("cpu"))
    assert (w.flops, w.xla_flops) == (line["train_flops_per_step"],
                                      line["train_xla_flops_per_step"])
    assert 0 < w.xla_flops < w.flops


# -------------------------------------------------------------- roofline


def _number(text, pattern):
    return float(re.search(pattern, text).group(1))


def test_roofline_runs_every_route_on_the_cpu(capsys):
    flops = {}
    for flag in ([], ["--fused-groupnorm"], ["--fused"]):
        rc, out = _out(capsys, roofline.main,
                       ["--batch", "1", "--iters", "1", "--dtype", "float32",
                        "--device", "cpu"] + TINY + flag)
        assert rc == 0
        lines = out.splitlines()
        assert lines[0].startswith("device: cpu   batch: 1 images (45 "
                                   "patches)   dtype: float32")
        assert lines[1].startswith("flops/call: ") and "XLA convention" \
            in lines[1]
        assert lines[2].startswith("measured: ")
        assert not any(x.startswith(("t_compute", "MFU", "card"))
                       for x in lines)
        flops[tuple(flag)] = (_number(out, r"flops/call: (\S+)"),
                              _number(out, r"XLA convention: (\S+)\)"))
    assert len(set(flops.values())) == 1, flops


def test_roofline_bound_and_mfu_follow_jax(monkeypatch):
    from wavedm_tpu_torch.config import load_config

    fig = {"float32": 2e12, "bfloat16": 4e12, "bytes_per_s": 1e11}
    monkeypatch.setattr(roofline, "peaks", lambda kind: fig)
    cfg = load_config("reference", [a for a in TINY if a != "--set"])
    r = roofline.measure(1, "float32", 1, "plain", "cpu", cfg)
    t_c, t_m = r["flops"] / 2e12, r["bytes"] / 1e11
    bound, dt = max(t_c, t_m), r["ms"] / 1e3
    assert r["bound_ms"] == pytest.approx(bound * 1e3)
    assert r["bound_by"] == ("memory" if t_m > t_c else "compute")
    assert r["mfu"] == pytest.approx(r["flops"] / dt / 2e12)
    assert r["attainable_mfu"] == pytest.approx(r["flops"] / bound / 2e12)
    assert r["roofline_fraction"] == pytest.approx(bound / dt)
    text = roofline.report(r)
    assert "roofline bound" in text and "MFU vs peak" in text
    assert roofline.PEAKS["NVIDIA H100 80GB HBM3"] == {
        "bfloat16": 989e12, "float32": 67e12, "bytes_per_s": 3.35e12}


# ---------------------------------------------------------- trace_summary


KERNELS = [
    ("void (anonymous namespace)::conv_kernel<__nv_bfloat16, "
     "(anonymous namespace)::WgmmaBf16>((anonymous namespace)::Params)",
     310.5, "kernel"),
    ("void (anonymous namespace)::gn_affine_kernel<__nv_bfloat16>(...)",
     12.25, "kernel"),
    ("void (anonymous namespace)::splitk_reduce_kernel<__nv_bfloat16>(...)",
     8.0, "kernel"),
    ("void (anonymous namespace)::group_norm_onchip_kernel<__nv_bfloat16, "
     "true>(...)", 40.0, "kernel"),
    ("void (anonymous namespace)::wavelet_dec_kernel(float const*, ...)",
     6.0, "kernel"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     250.0, "kernel"),
    ("ampere_bf16_s16816gemm_bf16_128x64_ldg8_f2f_stages_64x3_nn", 90.0,
     "kernel"),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, "
     "float, float, float, at::native::(anonymous namespace)::"
     "SoftMaxForwardEpilogue>(...)", 11.0, "kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<c10::BFloat16>, ...>(...)", 30.0, "kernel"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
     "...>>(...)", 5.5, "kernel"),
    ("Memcpy HtoD (Pageable -> Device)", 3.0, "gpu_memcpy"),
    ("Memset (Device)", 1.0, "gpu_memset"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(...)", 7.0, "kernel"),
    ("void some_other_kernel<int>(int*)", 2.0, "kernel"),
]


def _device_events(pid):
    events, ts = [], 0.0
    for rep in range(3):
        for name, dur, cat in KERNELS:
            events.append(dict(ph="X", cat=cat, name=name, pid=pid, tid=7,
                               ts=ts, dur=dur * (rep + 1)))
            ts += dur * (rep + 1) + 1.0
    return events


def _host_events(pid):
    return [dict(ph="X", cat="cpu_op", name="aten::conv2d", pid=pid, tid=1,
                 ts=0.0, dur=5000.0),
            dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel",
                 pid=pid, tid=1, ts=1.0, dur=4.0),
            dict(ph="X", cat="gpu_user_annotation", name="smoke", pid=0,
                 tid=7, ts=0.0, dur=9000.0)]


@pytest.fixture
def traces(tmp_path):
    """The same device events as the port's ``utils/profiling.trace``
    writes them and as a JAX profiler trace directory holds them."""
    port = tmp_path / "port"
    port.mkdir()
    with open(port / "trace.json", "w") as f:
        json.dump({"traceEvents": _host_events(1) + _device_events(0)}, f)
    run = tmp_path / "jax" / "plugins" / "profile" / "2026_10_18"
    run.mkdir(parents=True)
    meta = [dict(ph="M", name="process_name", pid=1,
                 args=dict(name="/host:CPU")),
            dict(ph="M", name="process_name", pid=2,
                 args=dict(name="/device:GPU:0"))]
    with gzip.open(run / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": meta + _host_events(1)[:2]
                   + _device_events(2)}, f)
    return str(port), str(tmp_path / "jax")


def _sections(out):
    """(the busy-time line, the top-ops section)."""
    lines = out.splitlines()
    busy = next(x for x in lines if x.startswith("device busy time"))
    top = lines[lines.index(next(x for x in lines
                                 if x.startswith("== top"))):]
    return busy, top


@pytest.mark.parametrize("top", [25, 5])
def test_trace_summary_reads_as_jax_reads(traces, capsys, monkeypatch, top):
    from tools import trace_summary as jax_tool

    port_dir, jax_dir = traces
    monkeypatch.setattr(sys, "argv", ["trace_summary.py", jax_dir,
                                      "--top", str(top)])
    capsys.readouterr()
    jax_tool.main()
    theirs = capsys.readouterr().out
    rc, ours = _out(capsys, trace_summary.main, [port_dir, "--top", str(top)])
    assert rc == 0
    assert _sections(ours) == _sections(theirs)
    assert len(_sections(ours)[1]) == 1 + min(top, len(KERNELS))


def test_trace_summary_categories_and_families(traces):
    s = trace_summary.summarize(trace_summary.find_trace(traces[0]))
    assert s["events"] == 3 * len(KERNELS)
    assert s["busy_us"] == pytest.approx(6 * sum(d for _, d, _ in KERNELS))
    cats = {c for c, _ in s["by_category"]}
    assert cats == {"fused_conv", "group_norm", "wavelet",
                    "cudnn/cutlass conv", "gemm", "softmax", "elementwise",
                    "reduce", "memcpy", "memset", "nccl", "other"}
    fam = s["families"]
    # three events a launch of the fused kernel, its launch kernel once
    assert (fam["fused_conv"]["events"], fam["fused_conv"]["launch_events"]) \
        == (9, 3)
    assert fam["group_norm"]["launch_events"] == 3
    assert fam["wavelet"]["launch_events"] == 3
    assert s["seen"] == sorted({"cpu_op", "cuda_runtime",
                                "gpu_user_annotation", "kernel",
                                "gpu_memcpy", "gpu_memset"})


def test_trace_summary_finds_torch_tensorboard_traces(tmp_path):
    nested = tmp_path / "run" / "worker"
    nested.mkdir(parents=True)
    with gzip.open(nested / "host_1.123.pt.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": _device_events(0)}, f)
    path = trace_summary.find_trace(str(tmp_path))
    assert path.endswith(".pt.trace.json.gz")
    assert trace_summary.summarize(path)["events"] == 3 * len(KERNELS)
    with pytest.raises(FileNotFoundError):
        trace_summary.find_trace(str(tmp_path / "run" / "nothing"))


def test_trace_summary_exits_1_on_a_cpu_only_trace(tmp_path, capsys):
    """``utils/profiling.trace`` of CPU work holds no device events."""
    with trace(str(tmp_path)):
        torch.randn(64, 64) @ torch.randn(64, 64)
    rc, out = _out(capsys, trace_summary.main, [str(tmp_path)])
    assert rc == 1
    assert out.startswith("no device events found; event categories seen:")
    assert "cpu_op" in out
