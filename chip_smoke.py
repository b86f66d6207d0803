#!/usr/bin/env python3
"""Drive the PyTorch port's restoration and training paths on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line with its elapsed seconds:

  card              the card's name and power limit; TF32 off for float32
  build             nvcc builds wavedm_tpu_torch/csrc/*.cu into one library
                    (one process per source); ptxas registers and spills
  kernels           every CUDA kernel of the paths against its plain PyTorch
                    version at the main paths' shapes, timed beside the plain
                    version, one PyTorch library call and its bound; the
                    fused GN->swish->conv3x3 kernel's gradients against
                    autograd through its composition, its mixed-dtype
                    instantiations, and the cost of its weight re-layout
  small_parity      a small restoration on the card (kernels) against the
                    same restoration on the CPU (plain versions)
  restore           the flagship UNet (156,492,675 params) and HFRM
                    (15,941,667) with random weights restore two synthetic
                    720x480 images under the reference profile (25 steps,
                    float32) and the production profile (10 steps from the
                    HFRM LL, bfloat16); launch counts are checked per run
  fused_vs_unfused  the production profile again with
                    ``fused_groupnorm: false``, on the same inputs and noise
  restore_fused_resblock
                    the production restore with ``fused_resblock: true``
                    (the fused kernel at all 44 ResnetBlock pairs), same
                    weights, inputs and noise; then the reference profile
                    (float32, 25 steps) with it, held to the reference
                    restore within 1e-3 (float32 summation order)
  train_parity      one train step of a small UNet on the card against the
                    same step on the CPU
  train             DiffusionTrainer.fit at flagship width with
                    ``fused_resblock: true`` under the reference profile
                    (float32, ground-truth conditioning, 8 crops) and the
                    production profile (bfloat16, a frozen random HFRM, 16
                    crops); loss, gradient, EMA, launch counts and a
                    save/resume round trip are checked

then the kernel table as one JSON line, the nvidia-smi line, and the final
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero.
It needs one CUDA card and the repository around it.

A kernel's ``ms`` is the wrapper's time, CUDA events around back-to-back
calls: what a caller pays when the card is not queued ahead, the host's
Python included.  ``device_ms`` is the card's own time: the same calls
captured in a CUDA graph and replayed, on inputs rotated past the L2 cache.

    python3 chip_smoke.py --tree DIR --phases kernels,restore

runs only those phases, on the package of another checkout DIR (to time
two commits in turns in one run); ``--phases sweep`` times the GroupNorm
kernel under each launch plan.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import time

MEM_BW = 3.35e12           # H100 SXM device memory, bytes/s
L2_BYTES = 50 * 2 ** 20    # its L2 cache
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}   # dense, no TF32 / tensor cores
N_IMAGES, HEIGHT, WIDTH = 2, 480, 720
SEED = 61
TRAIN_STEPS = 5
ROOT = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()


def emit(phase, **fields):
    print(json.dumps({"phase": phase,
                      "s": round(time.perf_counter() - T0, 3), **fields}),
          flush=True)


def nvidia_smi():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, x, iters=20, reps=3):
    """Device time of ``fn(x)`` per call: ``iters`` calls captured once in
    a CUDA graph, its replay timed with CUDA events.  The wrapper's Python
    (allocation, checks, the ctypes call) runs only at capture, so this is
    what the card spends, where ``time_ms`` may time the host.  The calls
    cycle through copies of x that together exceed three times the L2
    cache, so each call reads x from device memory, as the bound counts."""
    import torch

    copies = min(iters, -(-3 * L2_BYTES // (x.numel() * x.element_size())))
    xs = [x] + [x.clone() for _ in range(copies - 1)]
    fn(x)                   # outside the graph: builds, attributes, caches
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(xs[i % copies])
    # replays for 20 ms first: on the H100 the first replays after a stretch
    # of untimed work read up to 12% slow
    t = time.perf_counter()
    while time.perf_counter() - t < 0.02:
        graph.replay()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph, xs
    return start.elapsed_time(end) / (iters * reps)


def host_ms(fn, iters=200):
    """Host time per call: the wrapper's Python and the launch, on the
    host clock over back-to-back calls that the card runs behind."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t
    torch.cuda.synchronize()
    return elapsed * 1e3 / iters


def wall_ms(fn, iters=20):
    """Host wall clock per call, the queued device work included."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / iters


def bound_ms(*tensors):
    """Least time to read the inputs once and write the outputs once."""
    return sum(t.numel() * t.element_size() for t in tensors) / MEM_BW * 1e3


def ptxas_report(text):
    """{kernel: {registers, spill_stores, spill_loads}} from ``ptxas -v``,
    names demangled by ``c++filt`` where the machine has it."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    if out and shutil.which("c++filt"):
        res = subprocess.run(["c++filt"], input="\n".join(out),
                             capture_output=True, text=True, timeout=60)
        names = res.stdout.splitlines()
        if res.returncode == 0 and len(names) == len(out):
            out = {re.sub(r"^void |\(.*$", "", new.replace(
                "(anonymous namespace)::", "")): v
                for new, v in zip(names, out.values())}
    return out


def gn_sites(cfg, n_patches):
    """(C, H, W, swish) -> count over one UNet forward, from a forward on
    the meta device with hooks on every Normalize."""
    import torch
    from collections import Counter

    from wavedm_tpu_torch.models.layers import Normalize
    from wavedm_tpu_torch.models.unet import DiffusionUNet

    with torch.device("meta"):
        unet = DiffusionUNet.from_config(cfg, fused_gn=False)
        sites = Counter()
        for m in unet.modules():
            if isinstance(m, Normalize):
                m.register_forward_hook(lambda mod, inp, out: sites.update(
                    [tuple(inp[0].shape[1:]) + (mod.swish,)]))
        unet(torch.empty(n_patches, cfg.model.unet_in_channels,
                         cfg.data.image_size, cfg.data.image_size),
             torch.empty(n_patches))
    return sites


def gn_plan(gn, n, c, hw, dtype):
    """The GroupNorm kernel's launch plan as printed; None for a package
    that has none (an earlier commit's, run with ``--tree``)."""
    if not hasattr(gn, "group_norm_plan"):
        return None
    plan = gn.group_norm_plan(n, c, hw, 32, dtype)
    return dict(plan._asdict(), kind=plan.kind)


def check_kernels(cfg, n_patches):
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    import torch.nn.functional as F

    from wavedm_tpu_torch.ops import groupnorm_cuda as gn
    from wavedm_tpu_torch.ops import wavelet_cuda as wv
    from wavedm_tpu_torch.ops.wavelet import conv_weights

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = {}

    # DWT on the pixel batch in [-1, 1]; IWT on its output
    x = torch.rand(N_IMAGES, 3, HEIGHT, WIDTH, device=dev, generator=gen) * 2 - 1
    z = wv.wavelet_dec_cuda(x)
    z_plain = wv.wavelet_dec_plain(x)
    back = wv.wavelet_rec_cuda(z)
    back_plain = wv.wavelet_rec_plain(z)
    torch.cuda.synchronize()
    bank = torch.as_tensor(conv_weights(2, 3), device=dev)
    z_lib = F.conv2d(x, bank, stride=4, groups=3)   # channel order c*16+f
    dec_err = float((z - z_plain).abs().max())
    rec_err = float((back - back_plain).abs().max())
    rt_err = float((back - x).abs().max())
    tol = 2e-6
    assert dec_err <= tol and rec_err <= tol and rt_err <= tol, (
        dec_err, rec_err, rt_err)
    rows["wavelet_dec"] = dict(
        source="wavedm_tpu_torch/csrc/wavelet.cu",
        replaces="wavedm_tpu/ops/wavelet_pallas.py:44",
        max_abs_err=dec_err, tol=tol,
        ms=time_ms(lambda: wv.wavelet_dec_cuda(x)),
        device_ms=device_ms(wv.wavelet_dec_cuda, x),
        host_ms=host_ms(lambda: wv.wavelet_dec_cuda(x)),
        plain_ms=time_ms(lambda: wv.wavelet_dec_plain(x)),
        bound_ms=bound_ms(x, z),
        library_ms=time_ms(lambda: F.conv2d(x, bank, stride=4, groups=3)))
    rows["wavelet_rec"] = dict(
        source="wavedm_tpu_torch/csrc/wavelet.cu",
        replaces="wavedm_tpu/ops/wavelet_pallas.py:60",
        max_abs_err=rec_err, tol=tol, roundtrip_err=rt_err,
        ms=time_ms(lambda: wv.wavelet_rec_cuda(z)),
        device_ms=device_ms(wv.wavelet_rec_cuda, z),
        host_ms=host_ms(lambda: wv.wavelet_rec_cuda(z)),
        plain_ms=time_ms(lambda: wv.wavelet_rec_plain(z)),
        bound_ms=bound_ms(z, back),
        library_ms=time_ms(
            lambda: F.conv_transpose2d(z_lib, bank, stride=4, groups=3)))
    emit("kernels", kernel="wavelet", shape=list(x.shape),
         dec_err=dec_err, rec_err=rec_err, roundtrip_err=rt_err, tol=tol)

    # GroupNorm(+swish) at every distinct flagship site shape, f32 and bf16,
    # swish on and off.  A row of the table sums one UNet forward's sites of
    # that variant (shapes the forward does not use count 0 there).
    # f32: the Pallas tests' 2e-5 (summation order only); bf16: both round
    # the same f32 value once, so one bf16 ulp (<= 2**-6 relative).
    sites = gn_sites(cfg, n_patches)
    assert sum(sites.values()) == 51, sites
    shapes = sorted({key[:3] for key in sites})
    for dtype, tag, atol, rtol in ((torch.float32, "f32", 2e-5, 2e-5),
                                   (torch.bfloat16, "bf16", 1e-6, 2.0 ** -6)):
        for swish in (True, False):
            name = f"{tag}_swish" if swish else tag
            row = dict(source="wavedm_tpu_torch/csrc/groupnorm.cu",
                       replaces="wavedm_tpu/ops/groupnorm_pallas.py:27",
                       max_abs_err=0.0, ms=0.0, device_ms=0.0, plain_ms=0.0,
                       bound_ms=0.0, library_ms=0.0)
            for c, h, w in shapes:
                count = sites.get((c, h, w, swish), 0)
                xs = torch.randn(n_patches, c, h, w, device=dev,
                                 generator=gen).to(dtype)
                wt = torch.randn(c, device=dev, generator=gen)
                bs = torch.randn(c, device=dev, generator=gen)
                y = gn.group_norm(xs, wt, bs, 32, 1e-6, swish)
                yp = gn.group_norm_plain(xs, wt, bs, 32, 1e-6, swish)
                torch.cuda.synchronize()
                diff = (y.float() - yp.float()).abs()
                excess = float((diff - rtol * yp.float().abs()).max())
                assert excess <= atol, (name, c, h, w, excess)
                row["max_abs_err"] = max(row["max_abs_err"], float(diff.max()))
                if not count:
                    emit("kernels", kernel=f"group_norm_{name}",
                         shape=[n_patches, c, h, w], count_per_forward=0,
                         max_abs_err=float(diff.max()))
                    continue
                wl, bl = wt.to(dtype), bs.to(dtype)

                def lib():
                    out = F.group_norm(xs, 32, wl, bl, 1e-6)
                    return F.silu(out) if swish else out

                k_ms = time_ms(lambda: gn.group_norm(xs, wt, bs, 32, 1e-6,
                                                     swish))
                d_ms = device_ms(lambda t: gn.group_norm(t, wt, bs, 32, 1e-6,
                                                         swish), xs)
                p_ms = time_ms(lambda: gn.group_norm_plain(xs, wt, bs, 32,
                                                           1e-6, swish))
                l_ms = time_ms(lib)
                b_ms = bound_ms(xs, y)
                emit("kernels", kernel=f"group_norm_{name}",
                     shape=[n_patches, c, h, w], count_per_forward=count,
                     max_abs_err=float(diff.max()), ms=k_ms, device_ms=d_ms,
                     plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                     share_of_bound=b_ms / d_ms,
                     plan=gn_plan(gn, n_patches, c, h * w, dtype))
                for key, val in (("ms", k_ms), ("device_ms", d_ms),
                                 ("plain_ms", p_ms), ("library_ms", l_ms),
                                 ("bound_ms", b_ms)):
                    row[key] += count * val      # per UNet forward
            rows[f"group_norm_{name}"] = row
    return rows


def fused_sites(cfg, n_patches):
    """(Cin, H, W, Cout) -> count of GN -> swish -> conv3x3 pairs (both
    convs of every ResnetBlock) over one UNet forward, from a forward on
    the meta device."""
    import torch
    from collections import Counter

    from wavedm_tpu_torch.models.layers import ResnetBlock
    from wavedm_tpu_torch.models.unet import DiffusionUNet

    with torch.device("meta"):
        unet = DiffusionUNet.from_config(cfg, fused_gn=False,
                                         fused_block=False)
        sites = Counter()
        for m in unet.modules():
            if isinstance(m, ResnetBlock):
                for conv in (m.conv1, m.conv2):
                    conv.register_forward_hook(
                        lambda mod, inp, out: sites.update(
                            [tuple(inp[0].shape[1:]) + (out.shape[1],)]))
        unet(torch.empty(n_patches, cfg.model.unet_in_channels,
                         cfg.data.image_size, cfg.data.image_size),
             torch.empty(n_patches))
    return sites


def _fused_inputs(gen, n, cin, h, w, cout, dtype):
    """x, GN scale/shift, conv weight and bias at one site, the weight in
    the compute dtype as serving stores it."""
    import torch

    dev = gen.device
    x = (torch.randn(n, cin, h, w, device=dev, generator=gen) * 2
         + 0.5).to(dtype)
    sg = torch.randn(cin, device=dev, generator=gen) * 0.1 + 1
    bg = torch.randn(cin, device=dev, generator=gen) * 0.1
    wk = (torch.randn(cout, cin, 3, 3, device=dev, generator=gen)
          * (9 * cin) ** -0.5).to(dtype)
    b = torch.randn(cout, device=dev, generator=gen) * 0.1
    return x, sg, bg, wk, b


def check_fused_kernels(cfg):
    """The fused GN -> swish -> conv3x3 kernel at every flagship site shape
    against its plain version (N = 2), its gradients at two shapes, and
    its time summed over one UNet forward at N = 90 (serving) and N = 16
    (production training) beside the plain version, the library call and
    the operations bound."""
    import torch
    import torch.nn.functional as F

    from wavedm_tpu_torch.ops import fused_resblock as fr

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    sites = fused_sites(cfg, 2)
    assert sum(sites.values()) == 44 and len(sites) == 17, sites
    rows = {}
    # f32: 1e-4 of the output scale (summation order only, TF32 off).
    # bf16: both sides round the same y once; the outputs round float32
    # sums taken in another order, so may part by one bf16 ulp (2**-7 of
    # the scale at most).
    for dtype, tag, tol in ((torch.float32, "f32", 1e-4),
                            (torch.bfloat16, "bf16", 2.0 ** -7)):
        row = dict(source="wavedm_tpu_torch/csrc/fused_resblock.cu",
                   replaces="wavedm_tpu/ops/fused_resblock.py:67",
                   max_abs_err=0.0, max_rel_err=0.0, tol_rel=tol,
                   bound_by="operations")
        for cin, h, w, cout in sorted(sites):
            args = _fused_inputs(gen, 2, cin, h, w, cout, dtype)
            out = fr.fused_gn_swish_conv(*args, dtype)
            ref = fr.fused_gn_swish_conv_plain(*args, dtype)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            rel = err / float(ref.float().abs().max())
            assert rel <= tol, (tag, cin, h, cout, err, rel)
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row["max_rel_err"] = max(row["max_rel_err"], rel)
        # the timed shapes are checked too, at the same tolerance: the
        # split-K plan depends on the batch, so N = 2 above runs the float32
        # partials and the reduce pass at every site, while at N = 90 all
        # but the 8x8 sites store straight from the main loop's epilogue
        # and at N = 16 the 8x8 sites split again
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for n, key in ((90, ""), (16, "_n16")):
            tot = dict.fromkeys(("ms", "device_ms", "plain_ms", "library_ms",
                                 "bound_ms", "bytes_ms", "ops_ms"), 0.0)
            iters = 3 if (tag, n) == ("f32", 90) else 10
            plans = {}
            for (cin, h, w, cout), count in sorted(sites.items()):
                x, sg, bg, wk, b = _fused_inputs(gen, n, cin, h, w, cout,
                                                 dtype)
                bd = b.to(dtype)
                plans[(cin, h, cout)] = fr.split_k(n * h * w, cout, cin, sms)
                out = fr.fused_gn_swish_conv(x, sg, bg, wk, b, dtype)
                ref = fr.fused_gn_swish_conv_plain(x, sg, bg, wk, b, dtype)
                torch.cuda.synchronize()
                err = float((out.float() - ref.float()).abs().max())
                rel = err / float(ref.float().abs().max())
                assert rel <= tol, (tag, n, cin, h, cout, err, rel)
                row["max_abs_err"] = max(row["max_abs_err"], err)
                row["max_rel_err"] = max(row["max_rel_err"], rel)
                del out, ref

                def lib():
                    y = F.silu(F.group_norm(x.float(), 32, sg, bg, 1e-6))
                    return F.conv2d(y.to(dtype), wk, bd, padding=1)

                k_ms = time_ms(lambda: fr.fused_gn_swish_conv(
                    x, sg, bg, wk, b, dtype), iters, 1)
                d_ms = device_ms(lambda t: fr.fused_gn_swish_conv(
                    t, sg, bg, wk, b, dtype), x, iters, 1)
                p_ms = time_ms(lambda: fr.fused_gn_swish_conv_plain(
                    x, sg, bg, wk, b, dtype), iters, 1)
                l_ms = time_ms(lib, iters, 1)
                out_bytes = n * cout * h * w * x.element_size()
                b_ms = (bound_ms(x, sg, bg, wk, b) + out_bytes / MEM_BW * 1e3)
                o_ms = 2.0 * n * h * w * 9 * cin * cout / PEAK_FLOPS[tag] * 1e3
                emit("kernels", kernel=f"fused_gn_swish_conv_{tag}",
                     shape=[n, cin, h, w, cout], count_per_forward=count,
                     ms=k_ms, device_ms=d_ms, plain_ms=p_ms, library_ms=l_ms,
                     bytes_ms=b_ms, ops_ms=o_ms,
                     tflops=2.0 * n * h * w * 9 * cin * cout / k_ms / 1e9)
                for name, val in (("ms", k_ms), ("device_ms", d_ms),
                                  ("plain_ms", p_ms), ("library_ms", l_ms),
                                  ("bytes_ms", b_ms), ("ops_ms", o_ms)):
                    tot[name] += count * val          # per UNet forward
            if n == 90:
                assert all(s == 1 for (_, h, _), s in plans.items()
                           if h > 8), plans
            else:
                assert all(s > 1 for (_, h, _), s in plans.items()
                           if h == 8), plans
            emit("kernels", kernel=f"fused_gn_swish_conv_{tag}", n=n,
                 split_k={f"{c}x{h}x{h}->{co}": s
                          for (c, h, co), s in sorted(plans.items())})
            tot["bound_ms"] = max(tot["bytes_ms"], tot["ops_ms"])
            assert tot["ops_ms"] >= tot["bytes_ms"]
            for name, val in tot.items():
                row[name + key] = val
        rows[f"fused_gn_swish_conv_{tag}"] = row
        emit("kernels", kernel=f"fused_gn_swish_conv_{tag}",
             per="UNet forward at N = 90 (and _n16: N = 16)",
             **{k: v for k, v in row.items() if k not in ("source",
                                                          "replaces")})

    # mixed dtypes: x in one dtype, the compute dtype the other, the output
    # in x's dtype, at every site shape (N = 2).  Tolerance: the compute
    # dtype's (above) of the output scale, plus one bf16 ulp of the element
    # (at most 2**-7 of it) where the output is bfloat16 and the two float32
    # sums round to either side of a bf16 boundary.
    for x_dtype, compute, tol in ((torch.float32, torch.bfloat16, 2.0 ** -7),
                                  (torch.bfloat16, torch.float32, 1e-4)):
        ulp = 2.0 ** -7 if x_dtype == torch.bfloat16 else 0.0
        worst = 0.0
        for cin, h, w, cout in sorted(sites):
            args = _fused_inputs(gen, 2, cin, h, w, cout, x_dtype)
            out = fr.fused_gn_swish_conv(*args, compute)
            ref = fr.fused_gn_swish_conv_plain(*args, compute)
            torch.cuda.synchronize()
            assert out.dtype == x_dtype
            excess = float(((out.float() - ref.float()).abs()
                            - ulp * ref.float().abs()).max()
                           / ref.float().abs().max())
            assert excess <= tol, (x_dtype, compute, cin, h, cout, excess)
            worst = max(worst, excess)
        emit("kernels", kernel="fused_gn_swish_conv mixed dtypes",
             x_dtype=str(x_dtype), compute_dtype=str(compute),
             max_rel_excess=worst, tol_rel=tol, ulp_rel=ulp)

    # the weight re-layout (permute, cast, pad) per UNet forward: what every
    # call paid before the layout was cached, against a cache hit on a
    # frozen float32 weight (serving keeps the fused convs' weights float32)
    relayout_ms = cached_ms = 0.0
    for (cin, h, w, cout), count in sites.items():
        wt = torch.randn(cout, cin, 3, 3, device=dev, generator=gen)
        relayout_ms += count * wall_ms(
            lambda: fr.weight_layout(wt, torch.bfloat16))
        cached_ms += count * wall_ms(
            lambda: fr.kernel_weight(wt, torch.bfloat16))
    emit("kernels", kernel="fused_gn_swish_conv weight layout",
         per="UNet forward, 44 convs, bf16", relayout_ms=relayout_ms,
         cached_ms=cached_ms)

    # gradients: the autograd Function against autograd through the plain
    # composition it recomputes, float32, 1e-4 of each gradient's scale
    for cin, h, cout in ((256, 16, 512), (128, 64, 128)):
        args = [t.requires_grad_() for t in
                _fused_inputs(gen, 2, cin, h, h, cout, torch.float32)]
        ref_args = [t.detach().clone().requires_grad_() for t in args]
        g = torch.randn(2, cout, h, h, device=dev, generator=gen)
        (fr.fused_gn_swish_conv(*args, torch.float32) * g).sum().backward()
        (fr.fused_gn_swish_conv_reference(*ref_args, torch.float32)
         * g).sum().backward()
        errs = [float((a.grad - r.grad).abs().max() / r.grad.abs().max())
                for a, r in zip(args, ref_args)]
        assert max(errs) <= 1e-4, errs
        emit("kernels", kernel="fused_gn_swish_conv_f32 backward",
             shape=[2, cin, h, h, cout], max_rel_err=max(errs), tol_rel=1e-4)
    return rows


def synthetic_images(seed):
    """Rain-degraded-looking (B, H, W, 3) images in [0, 1]: a smooth colour
    field with bright, blurred drops and sensor noise, from numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:HEIGHT, 0:WIDTH] / max(HEIGHT, WIDTH)
    imgs = []
    for _ in range(N_IMAGES):
        img = np.zeros((HEIGHT, WIDTH, 3))
        for c in range(3):
            f, p = rng.uniform(1, 6, 2), rng.uniform(0, 2 * np.pi, 2)
            img[..., c] = 0.5 + 0.25 * np.sin(f[0] * 2 * np.pi * xx + p[0]) \
                * np.cos(f[1] * 2 * np.pi * yy + p[1])
        for _ in range(60):
            cy, cx = rng.uniform(0, HEIGHT), rng.uniform(0, WIDTH)
            r = rng.uniform(4, 18)
            d2 = ((yy * max(HEIGHT, WIDTH) - cy) ** 2
                  + (xx * max(HEIGHT, WIDTH) - cx) ** 2)
            img += 0.3 * np.exp(-d2 / (2 * r * r))[..., None]
        img += rng.normal(0, 0.02, img.shape)
        imgs.append(np.clip(img, 0, 1))
    return np.stack(imgs).astype(np.float32)


def reset_counts():
    from wavedm_tpu_torch.ops import fused_resblock, groupnorm_cuda, wavelet_cuda

    for counts in (groupnorm_cuda.launches, wavelet_cuda.launches,
                   fused_resblock.launches):
        for key in counts:
            counts[key] = 0


def read_counts():
    from wavedm_tpu_torch.ops import fused_resblock, groupnorm_cuda, wavelet_cuda

    return {**{f"group_norm_{k}": v for k, v in groupnorm_cuda.launches.items()},
            **wavelet_cuda.launches, **fused_resblock.launches}


def restore_timed(rest, images):
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out, hfrm_out = rest.restore_image_device(images)
    torch.cuda.synchronize()
    return out, hfrm_out, (time.perf_counter() - t) * 1e3


def check_output(out):
    import torch

    assert tuple(out.shape) == (N_IMAGES, HEIGHT, WIDTH, 3), out.shape
    assert bool(torch.isfinite(out).all())
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0


def small_parity():
    """A small restoration through the kernels on the card against the same
    restoration through the plain versions on the CPU, float32."""
    import numpy as np
    import torch

    from wavedm_tpu_torch.config import (Config, DataConfig, DiffusionConfig,
                                         ModelConfig, ParallelConfig,
                                         SamplingConfig)
    from wavedm_tpu_torch.inference.loader import build_restorer

    cfg = Config()
    cfg.data = DataConfig(image_size=8, patch_size=32)
    cfg.model = ModelConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                            attn_resolutions=(4,))
    cfg.diffusion = DiffusionConfig(num_diffusion_timesteps=50)
    cfg.sampling = SamplingConfig(sampling_timesteps=10, grid_r=4)
    cfg.hfrm.dim, cfg.hfrm.middle_blk_num = 8, 1
    cfg.hfrm.enc_blk_nums = cfg.hfrm.dec_blk_nums = (1, 1)
    cfg.parallel = ParallelConfig(fused_groupnorm=True)
    cfg.validate()
    images = np.random.default_rng(SEED).random((2, 64, 96, 3),
                                                dtype=np.float32)
    noise = torch.randn(2, 3, 16, 24, generator=torch.Generator().manual_seed(0))
    cpu = build_restorer(cfg, None, None, device="cpu")
    ref, _ = cpu.restore_image(images, noise=noise)
    gpu = build_restorer(cfg, cpu.unet.state_dict(), cpu.hfrm.state_dict(),
                         device="cuda")
    out, _ = gpu.restore_image(images, noise=noise)
    err = float(np.abs(out - ref).max())
    # float32 on both sides, TF32 off: summation order only (the CPU tests
    # hold the same path against JAX to this bound)
    assert err <= 1e-4, err
    emit("small_parity", shape=list(out.shape), max_abs_err=err, tol=1e-4)


def small_train_cfg():
    from wavedm_tpu_torch.config import config_from_dict

    return config_from_dict({
        "data": {"image_size": 8, "patch_size": 32},
        "model": {"ch": 64, "ch_mult": [1, 2], "num_res_blocks": 1,
                  "attn_resolutions": [4]},
        "diffusion": {"num_diffusion_timesteps": 50},
        "optim": {"optimizer": "SGD", "lr": 1e-5},
        "parallel": {"fused_resblock": True}})


def train_parity():
    """One train step of a small fused-resblock UNet on the card (kernels)
    against the same step on the CPU (plain versions): same weights, batch,
    t and noise, float32.  SGD, so each parameter moves by lr times its
    gradient and the comparison sees the gradients themselves (Adam would
    turn float noise in a near-zero gradient into a +-lr step)."""
    import numpy as np
    import torch

    from wavedm_tpu_torch.inference.loader import build_unet
    from wavedm_tpu_torch.training.state import create_train_state
    from wavedm_tpu_torch.training.train_step import make_train_step

    cfg = small_train_cfg()
    batch = np.random.default_rng(SEED).random((4, 32, 32, 6),
                                               dtype=np.float32)
    t = torch.tensor([3, 46, 20, 29])
    e = torch.randn(4, 3, 8, 8, generator=torch.Generator().manual_seed(1))
    out, weights = [], None
    for dev in ("cpu", "cuda"):
        # the CPU model's random weights, carried to the card
        model = build_unet(cfg, weights, dev, train=True)
        weights = weights or {k: v.clone()
                              for k, v in model.state_dict().items()}
        state = create_train_state(model, cfg.optim, 0)
        m = make_train_step(cfg, model)(state, batch, t=t, e=e)
        out.append((float(m.loss), float(m.grad_norm),
                    {k: v.cpu() for k, v in model.state_dict().items()}))
    (l_cpu, g_cpu, sd_cpu), (l_gpu, g_gpu, sd_gpu) = out
    param_err = max(float((sd_gpu[k] - sd_cpu[k]).abs().max()
                          / sd_cpu[k].abs().max()) for k in sd_cpu)
    loss_err = abs(l_gpu - l_cpu) / abs(l_cpu)
    grad_err = abs(g_gpu - g_cpu) / abs(g_cpu)
    assert max(param_err, loss_err, grad_err) <= 1e-4, (param_err, loss_err,
                                                        grad_err)
    emit("train_parity", optimizer="SGD", loss_rel_err=loss_err,
         grad_norm_rel_err=grad_err, param_rel_err=param_err, tol_rel=1e-4)


def train_profile(name, cfg, n_crops, hfrm_sd):
    """DiffusionTrainer.fit at flagship width on synthetic crops, then one
    more step by hand for the EMA check and a save/resume round trip.
    Returns the launch counts of the counted run."""
    import itertools

    import torch

    from wavedm_tpu_torch.cli.train_diffusion import smoke_batches
    from wavedm_tpu_torch.training.trainer import DiffusionTrainer

    quiet = dict(device="cuda", log_fn=lambda msg: None)
    trainer = DiffusionTrainer(cfg, hfrm_state_dict=hfrm_sd, **quiet)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    assert n_params == 156_492_675, n_params
    batches = list(itertools.islice(smoke_batches(cfg, n_crops)(0),
                                    TRAIN_STEPS + 1))
    p0 = {k: p.detach().clone() for k, p in trainer.model.named_parameters()}

    # the counted run: counts start at 0 just before it
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.perf_counter()
    trainer.fit(lambda epoch: iter(batches[:1]), max_steps=1)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    trainer.fit(lambda epoch: iter(batches[1:TRAIN_STEPS]),
                max_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    steady_ms = (time.perf_counter() - t) * 1e3 / (TRAIN_STEPS - 1)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    assert trainer.state.step == TRAIN_STEPS
    tag = "f32" if cfg.parallel.compute_dtype == "float32" else "bf16"
    dwt = 2 if cfg.model.use_gt_in_train else 3
    want = {f"fused_gn_swish_conv_{tag}": 44 * TRAIN_STEPS,
            "wavelet_dec": dwt * TRAIN_STEPS}
    got = {k: v for k, v in counts.items() if v}
    assert got == want, (name, got, want)

    # one more step: EMA = mu * old + (1 - mu) * new, and every parameter
    # that got a gradient moved
    mu = cfg.model.ema_rate
    ema_old = {k: v.clone() for k, v in trainer.state.ema.items()}
    m = trainer.train_step(trainer.state, batches[TRAIN_STEPS])
    loss, grad_norm = float(m.loss), float(m.grad_norm)
    assert torch.isfinite(torch.tensor([loss, grad_norm])).all(), (loss,
                                                                   grad_norm)
    ema_err = 0.0
    for k, p in trainer.model.named_parameters():
        want_ema = mu * ema_old[k] + (1.0 - mu) * p.detach()
        ema_err = max(ema_err, float((trainer.state.ema[k] - want_ema)
                                     .abs().max()))
        if p.grad is not None:
            assert not torch.equal(p.detach(), p0[k]), f"{k} did not move"
    # the shadow update rounds as this expression does: bit for bit
    assert ema_err == 0.0, ema_err
    del p0, ema_old

    # save -> resume restores the step and the state bit for bit
    ckpt_dir = os.path.join(ROOT, "wavedm_tpu_torch", "_build", "smoke_ckpt")
    try:
        t = time.perf_counter()
        path = trainer.save(os.path.join(ckpt_dir, name))
        save_s = time.perf_counter() - t
        size = os.path.getsize(path)
        resumed = DiffusionTrainer(cfg, hfrm_state_dict=hfrm_sd, **quiet)
        t = time.perf_counter()
        resumed.resume(path)
        resume_s = time.perf_counter() - t
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    assert resumed.state.step == trainer.state.step
    for a, b in ((trainer.model.state_dict(), resumed.model.state_dict()),
                 (trainer.state.ema, resumed.state.ema)):
        assert all(torch.equal(a[k], b[k]) for k in a)
    opt_a = trainer.state.optimizer.state_dict()["state"]
    opt_b = resumed.state.optimizer.state_dict()["state"]
    assert all(torch.equal(v, opt_b[i][k]) for i, s in opt_a.items()
               for k, v in s.items())
    del resumed
    emit("train", profile=name, dtype=cfg.parallel.compute_dtype,
         crops=n_crops, patch=cfg.data.patch_size, params_unet=n_params,
         use_gt_in_train=cfg.model.use_gt_in_train, steps=TRAIN_STEPS + 1,
         launches=got, launches_per_step=44, first_step_ms=first_ms,
         ms_per_step=steady_ms, peak_bytes=peak, loss=loss,
         grad_norm=grad_norm, ema_max_err=ema_err, ckpt_bytes=size,
         save_s=save_s, resume_s=resume_s)
    del trainer
    torch.cuda.empty_cache()
    return counts


def gn_sweep(cfg, n_patches):
    """The GroupNorm kernel under each launch plan at every flagship site
    shape, swish on (the chosen plan also with swish off): the share of its
    bound each reaches.  group_norm_plan's constants come from this."""
    import torch

    from wavedm_tpu_torch.ops import groupnorm_cuda as gn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    chosen = gn.group_norm_plan
    for dtype in (torch.float32, torch.bfloat16):
        for c, h, w in sorted({key[:3] for key in gn_sites(cfg, n_patches)}):
            x = torch.randn(n_patches, c, h, w, device=dev,
                            generator=gen).to(dtype)
            wt = torch.randn(c, device=dev, generator=gen)
            bs = torch.randn(c, device=dev, generator=gen)
            length, elem = c // 32 * h * w, x.element_size()
            plans = [(k, 1, t) for k in (2, 4, 8) for t in (128, 256)]
            plans += [(1, m, t) for m in (1, 2) for t in (128, 256)]
            shares = {}
            for k, m, t in plans:
                if length % k or m * length // k * elem > gn.SMEM_MAX:
                    continue
                plan = gn.GroupNormPlan(k, m, length // k, t,
                                        m * length // k * elem,
                                        -(-n_patches * 32 // m) * k)
                gn.group_norm_plan = lambda *args, plan=plan: plan
                try:
                    d_ms = device_ms(lambda u: gn.group_norm(
                        u, wt, bs, 32, 1e-6, True), x)
                finally:
                    gn.group_norm_plan = chosen
                shares[f"k{k}m{m}t{t}"] = bound_ms(x, x) / d_ms
            best = chosen(n_patches, c, h * w, 32, dtype)
            off = bound_ms(x, x) / device_ms(lambda u: gn.group_norm(
                u, wt, bs, 32, 1e-6, False), x)
            emit("gn_sweep", dtype=str(dtype), shape=[n_patches, c, h, w],
                 segment_kb=length * elem / 1024,
                 plan=f"k{best.cluster}m{best.segs_per_cta}t{best.threads}",
                 share_of_bound=shares, plan_share_swish_off=off)


def partial(phases, ref_cfg, prod_cfg):
    """Only the named phases (``--phases``), for comparing trees in one
    call: ``kernels`` (the DWT/IWT and GroupNorm kernels against their plain
    versions, timed), ``restore`` (the production restore through
    ``fused_groupnorm``: a first run, then five timed runs) and ``sweep``
    (the GroupNorm kernel under each launch plan, :func:`gn_sweep`)."""
    if "sweep" in phases:
        gn_sweep(ref_cfg, N_IMAGES * 45)
    if "kernels" in phases:
        for name, row in check_kernels(ref_cfg, N_IMAGES * 45).items():
            emit("kernels", kernel=name, per="call (wavelet) or UNet "
                 "forward at N = 90 (GroupNorm)", **row)
    if "restore" in phases:
        from wavedm_tpu_torch.inference.loader import build_restorer

        rest = build_restorer(prod_cfg, None, None, device="cuda")
        images = synthetic_images(SEED)
        out, _, first_ms = restore_timed(rest, images)
        check_output(out)
        runs = [restore_timed(rest, images)[2] / N_IMAGES for _ in range(5)]
        emit("restore", profile="production", first_ms_per_image=first_ms
             / N_IMAGES, ms_per_image_runs=runs,
             ms_per_image=sum(runs) / len(runs))
    return 0


def main(argv=None):
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", help="import wavedm_tpu_torch from this "
                    "directory (a checkout of another commit) instead of the "
                    "script's own")
    ap.add_argument("--phases", help="comma-separated subset of "
                    "kernels,restore,sweep to run alone; no final lines")
    args = ap.parse_args(argv)
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from wavedm_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2
    from wavedm_tpu_torch.config import production_profile, reference_profile
    from wavedm_tpu_torch.inference.loader import build_hfrm, build_restorer

    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("card", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, tf32=False,
         package=os.path.dirname(_build.CSRC_DIR))

    t = time.perf_counter()
    _build.library()
    emit("build", seconds=time.perf_counter() - t,
         nvcc_seconds=_build.last_build_seconds, library=_build.LIB_PATH,
         ptxas=ptxas_report(_build.last_ptxas))

    ref_cfg = reference_profile()
    prod_cfg = production_profile()
    for cfg in (ref_cfg, prod_cfg):
        cfg.parallel.fused_groupnorm = True
    if args.phases:
        return partial(set(args.phases.split(",")), ref_cfg, prod_cfg)
    k_per_image = 45
    rows = check_kernels(ref_cfg, N_IMAGES * k_per_image)
    rows.update(check_fused_kernels(ref_cfg))

    small_parity()

    images = synthetic_images(SEED)
    launches = dict.fromkeys(rows, 0)
    outs = {}
    for name, cfg in (("reference", ref_cfg), ("production", prod_cfg)):
        rest = build_restorer(cfg, None, None, device="cuda")
        n_unet = sum(p.numel() for p in rest.unet.parameters())
        n_hfrm = sum(p.numel() for p in rest.hfrm.parameters())
        assert (n_unet, n_hfrm) == (156_492_675, 15_941_667), (n_unet, n_hfrm)
        steps = len(rest.seq)
        # the counted run: counts start at 0 just before it
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        out, _, first_ms = restore_timed(rest, images)
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        check_output(out)
        tag = "f32" if cfg.parallel.compute_dtype == "float32" else "bf16"
        want = {f"group_norm_{tag}_swish": 45 * steps,
                f"group_norm_{tag}": 6 * steps,
                "wavelet_dec": 2, "wavelet_rec": 1}
        got = {k: v for k, v in counts.items() if v}
        assert got == want, (name, got, want)
        for key, val in counts.items():
            launches[key] += val
        _, _, steady_ms = restore_timed(rest, images)
        outs[name] = out, steady_ms
        emit("restore", profile=name, steps=steps,
             dtype=cfg.parallel.compute_dtype, images=N_IMAGES,
             patches=N_IMAGES * k_per_image, params_unet=n_unet,
             params_hfrm=n_hfrm, launches=got,
             first_ms_per_image=first_ms / N_IMAGES,
             ms_per_image=steady_ms / N_IMAGES, peak_bytes=peak,
             out_min=float(out.min()), out_max=float(out.max()),
             out_mean=float(out.mean()))
    fused_out, fused_ms = out, steady_ms
    unet_sd, hfrm_sd = rest.unet.state_dict(), rest.hfrm.state_dict()
    del rest

    # production profile with the plain GroupNorm: same weights, inputs and
    # noise.  Switching the GN implementation changes rounding at 51 sites
    # per forward; switching the whole network from float32 to bfloat16
    # changes it at every op.  So the first must move the output less than
    # the second: held to the bfloat16-vs-float32 gap of this very run.
    unfused_cfg = production_profile()
    unfused = build_restorer(unfused_cfg, unet_sd, hfrm_sd, device="cuda")
    unfused_out, _, unfused_ms = restore_timed(unfused, images)
    del unfused
    f32_cfg = production_profile()
    f32_cfg.parallel.fused_groupnorm = True
    f32_cfg.parallel.compute_dtype = "float32"
    f32 = build_restorer(f32_cfg, None, None, device="cuda")
    f32_out, _, _ = restore_timed(f32, images)
    del f32
    check_output(unfused_out)
    diff = float((fused_out - unfused_out).abs().max())
    bf16_gap = float((fused_out - f32_out).abs().max())
    assert diff <= bf16_gap, (diff, bf16_gap)
    emit("fused_vs_unfused", profile="production", max_abs_diff=diff,
         mean_abs_diff=float((fused_out - unfused_out).abs().mean()),
         tol_bf16_vs_f32_gap=bf16_gap, unfused_ms_per_image=unfused_ms / N_IMAGES)

    # production profile with the fused ResnetBlock kernel at all 44 pairs
    # (the plain GroupNorm at the 7 other norm sites): same weights, inputs
    # and noise, held to the same gap
    fr_cfg = production_profile()
    fr_cfg.parallel.fused_resblock = True
    fr_cfg.validate()
    fr_rest = build_restorer(fr_cfg, unet_sd, hfrm_sd, device="cuda")
    reset_counts()
    fr_out, _, fr_first_ms = restore_timed(fr_rest, images)
    counts = read_counts()
    check_output(fr_out)
    steps = len(fr_rest.seq)
    want = {"fused_gn_swish_conv_bf16": 44 * steps, "wavelet_dec": 2,
            "wavelet_rec": 1}
    got = {k: v for k, v in counts.items() if v}
    assert got == want, ("restore_fused_resblock", got, want)
    for key, val in counts.items():
        launches[key] += val
    _, _, fr_ms = restore_timed(fr_rest, images)
    del fr_rest
    fr_diff = float((fr_out - fused_out).abs().max())
    assert fr_diff <= bf16_gap, (fr_diff, bf16_gap)
    emit("restore_fused_resblock", profile="production", launches=got,
         first_ms_per_image=fr_first_ms / N_IMAGES,
         ms_per_image=fr_ms / N_IMAGES,
         fused_groupnorm_ms_per_image=fused_ms / N_IMAGES,
         max_abs_diff_vs_fused_groupnorm=fr_diff,
         mean_abs_diff=float((fr_out - fused_out).abs().mean()),
         tol_bf16_vs_f32_gap=bf16_gap)
    del unet_sd
    torch.cuda.empty_cache()

    # the reference profile (float32, TF32 off, 25 steps from noise) with
    # the fused kernel at all 44 pairs, against the reference restore with
    # fused_groupnorm + cuDNN: the same weights (one seed draws one network
    # in either dtype), inputs and noise.  Float32 on both sides, so they
    # part by summation order only: held to 1e-3 absolute on images in
    # [0, 1] (5.6e-5 measured on the H100 over 25 steps), far below the
    # 0.37 that this profile's bfloat16 run parts from its float32 one.
    ref_out, ref_ms = outs["reference"]
    fr_ref_cfg = reference_profile()
    fr_ref_cfg.parallel.fused_resblock = True
    fr_ref_cfg.validate()
    fr_ref = build_restorer(fr_ref_cfg, None, None, device="cuda")
    reset_counts()
    fr_ref_out, _, fr_ref_first_ms = restore_timed(fr_ref, images)
    counts = read_counts()
    check_output(fr_ref_out)
    steps = len(fr_ref.seq)
    want = {"fused_gn_swish_conv_f32": 44 * steps, "wavelet_dec": 2,
            "wavelet_rec": 1}
    got = {k: v for k, v in counts.items() if v}
    assert got == want, ("restore_fused_resblock reference", got, want)
    for key, val in counts.items():
        launches[key] += val
    _, _, fr_ref_ms = restore_timed(fr_ref, images)
    del fr_ref
    torch.cuda.empty_cache()
    fr_ref_diff = float((fr_ref_out - ref_out).abs().max())
    assert fr_ref_diff <= 1e-3, fr_ref_diff
    emit("restore_fused_resblock", profile="reference", launches=got,
         first_ms_per_image=fr_ref_first_ms / N_IMAGES,
         ms_per_image=fr_ref_ms / N_IMAGES,
         fused_groupnorm_ms_per_image=ref_ms / N_IMAGES,
         max_abs_diff_vs_fused_groupnorm=fr_ref_diff,
         mean_abs_diff=float((fr_ref_out - ref_out).abs().mean()),
         tol_abs=1e-3)
    del outs, ref_out, fr_ref_out

    train_parity()

    # stage-2 training at flagship width through the fused kernel
    ref_train = reference_profile()
    prod_train = production_profile()
    for cfg in (ref_train, prod_train):
        cfg.parallel.fused_resblock = True
        cfg.validate()
    hfrm_train = build_hfrm(prod_train, None, "cuda").state_dict()
    for name, cfg, hfrm in (("reference", ref_train, None),
                            ("production", prod_train, hfrm_train)):
        n_crops = cfg.training.batch_size * cfg.training.patch_n
        counts = train_profile(name, cfg, n_crops, hfrm)
        for key, val in counts.items():
            launches[key] += val
    del hfrm_train

    for key, val in launches.items():
        assert val > 0, f"kernel {key} never ran on the main path"
    kernels = [dict(name=key, route="cuda", source=row["source"],
                    replaces=row["replaces"], launches=launches[key],
                    max_abs_err=row["max_abs_err"], ms=row["ms"],
                    device_ms=row["device_ms"],
                    plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                    bound_by=row.get("bound_by", "bytes"),
                    library_ms=row["library_ms"])
               for key, row in rows.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
