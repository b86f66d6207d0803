#!/usr/bin/env python3
"""Drive the PyTorch port's restoration and training paths on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line with its elapsed seconds:

  card              the card's name and power limit; TF32 off for float32
  build             nvcc builds wavedm_tpu_torch/csrc/*.cu into one library
                    (one process per source); ptxas registers and spills
  native            beside nvcc, the host C++ compiler builds the data
                    library (wavedm_tpu_torch/native/: wavedm_data.cc, the
                    native crop stream, over the port's own JPEG and PNG
                    decoders, jpeg_decode.cc and png_decode.cc, which need
                    zlib alone); it must be available: the compiler, the
                    build seconds, the library's DT_NEEDED entries (no
                    libjpeg, no libpng); every committed JPEG/PNG fixture
                    decoded by it, from the file and from memory, equal to
                    decodes.npz, and make_crop_batch equal to the JAX
                    package's crop_batch.npz; one 720x480 decode of
                    raindrop_0000.jpg and of a RainDrop PNG timed through
                    the library, PIL and (the PNG) the numpy decoder.
                    Beside it PIL's version, whether it has the WebP and
                    JPEG codecs, and the decoder
                    ``utils/images.decode_image`` picks for each committed
                    fixture (PNG, JPEG, WebP, GIF, TIFF)
  profiling         (in a child process started with the script, whose
                    start-up runs beside nvcc and which profiles once the
                    library is built, beside small_parity, which times
                    nothing; awaited before the first timed phase: once
                    torch.profiler has run in a process, each later launch
                    there costs the host more)
                    ``utils/profiling.trace`` and ``annotate`` around one
                    DWT kernel call: the trace file holds the annotated
                    region; its device kernel events are counted.  Then
                    one production UNet forward (bfloat16, 90 patches)
                    traced under ``fused_groupnorm`` and under
                    ``fused_resblock`` and read by ``tools/trace_summary``:
                    each of the port's kernel families counts as many
                    launch events as the launch counts grew by
  kernels           every CUDA kernel of the paths against its plain PyTorch
                    version at the main paths' shapes, timed beside the plain
                    version, one PyTorch library call and its bound; the
                    fused GN->swish->conv3x3 kernel's gradients against
                    autograd through its composition, its mixed-dtype
                    instantiations, and the cost of its weight re-layout
  kernels (whole)   GroupNorm and the fused kernel at the whole-image
                    chain's sites (a (2, 96, 120, 184) UNet input: levels
                    at 120x184, 60x92, 30x46, 15x23) against their plain
                    versions, device time against bound and library
  small_parity      (right after the build) a small restoration on the
                    card (kernels) against the same restoration on the CPU
                    (plain versions), under DDIM, dpmpp2m, a v-trained
                    UNet, eta 0.5 (injected step noise), patch
                    micro-batches and the whole-image chain
  restore           the flagship UNet (156,492,675 params) and HFRM
                    (15,941,667) with random weights restore two synthetic
                    720x480 images under the reference profile (its 25
                    steps cut to ``REF_STEPS`` = 5,
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
  sampler           the production profile through dpmpp2m against DDIM
                    (timed in turns), patch micro-batches of 16 against the
                    unbatched chain, and the whole-image chain (bfloat16,
                    float32, and through ``fused_resblock``)
  eval              four synthetic 720x480 pairs written as PNG; the
                    ``cli/eval_diffusion`` and ``cli/restore`` entry points
                    run in-process over them; metrics (random weights: not
                    a quality number), dumps read back
  serve             the production profile at batch 8: every kernel against
                    its plain version at the served shapes (8 images,
                    N = 360 patches); restore_image_device
                    on 8 images through ``fused_groupnorm`` and
                    ``fused_resblock``; then a RestorationServer on
                    127.0.0.1 answers 16 concurrent 720x480 requests in 2
                    batches (each reply within one uint8 level of a direct
                    restore of the same batch): 14 synthetic PNGs, the
                    committed palette PNG of RainDrop test image 0000 and
                    its committed JPEG (decoded by the data library, or
                    by PIL where the library is unavailable; a 15th PNG
                    where neither can, and the JPEG then gets a 500
                    naming why); a lone request and a bad one; latency,
                    host decode (PNG, palette PNG, JPEG) and encode ms,
                    peak memory.  Then a lossy and a lossless WebP, a GIF
                    and the JPEG, each posted beside the same pixels as a
                    PNG, all images of the batch from one x_T: each reply
                    within one uint8 level of its twin's, or, where this
                    machine's PIL lacks the codec, a 500 naming it
  train_parity      one train step of a small UNet on the card against the
                    same step on the CPU
  train             DiffusionTrainer.fit at flagship width with
                    ``fused_resblock: true`` under the reference profile
                    (float32, ground-truth conditioning, 8 crops) and the
                    production profile (bfloat16, a frozen random HFRM, 16
                    crops); loss, gradient, EMA, launch counts and a
                    save/resume round trip are checked
  train_data        stage 2 on the RainDrop test pairs (standing in for the
                    289 MB train split, which a copy of the repository made
                    for a GPU machine may leave out), the
                    production profile with ``fused_resblock``:
                    DATA_STEPS steps streamed from the PNG files in the PIL
                    order, as many through the device crop cache (first
                    batches equal to the byte), in-train validation once,
                    then as many on the native crop stream (its first
                    batch equal to ``make_crop_batch`` called directly, and
                    the stream ``train_batches`` picks by default);
                    ms/step, data wait, peak memory, launch counts, and the
                    three paths' data_ms and ms/step side by side
  train_hfrm        one small HFRM train step on the card against the CPU;
                    then HFRMTrainer at full width on the 8 test pairs
                    (whole 720x480 images, batch 8) for HFRM_STEPS steps
                    in float32, bfloat16 over float32 parameters, and
                    bfloat16 with
                    ``hfrm.remat``: ms/step, peak memory, the parameters
                    outside the residual blocks moved, ``lastest`` written
  pipeline          cli.train_hfrm (2 steps) -> its ``lastest`` as
                    ``--hfrm-ckpt`` to cli.train_diffusion (2 steps) -> that
                    checkpoint to cli.eval_diffusion over 2 pairs; the
                    served HFRM holds the stage-1 file's weights
  tools             every quality-loop tool of ``wavedm_tpu_torch/tools/``
                    on the pipeline's checkpoints at full width and a
                    small depth: the synthetic dataset (2 + 2 pairs), the
                    per-band diagnostic (one image, 2 steps), the
                    teacher-forced probe (4 crops), the seed study (4
                    seeds, both chains at 2 steps), the toy eps-vs-v A/B
                    (20 steps), an eval sweep of two rows read back by
                    summarize_sweep, the dress rehearsal (2 + 2 steps) and
                    the rehearsal A/B's three arms (1 step); each exits 0
                    with finite numbers, launches counted.  Then the
                    measuring tools: the roofline of the production
                    forward (bfloat16, 90 patches, 3 timed calls) under no
                    kernel, ``fused_groupnorm`` and ``fused_resblock``
                    (flops and XLA-convention flops the same under all
                    three, 90 times one patch's), and the training MFU of
                    the ``train`` phase's two steps at their measured
                    ms/step (flops the same without a kernel and through
                    ``fused_resblock``), beside the card's name and power
                    limit
  variants          the three variant paths of the shipped configs at full
                    width (chains cut to 2 steps): the pixel path on one
                    720x480 image (874 patches of 128x128, micro-batches of
                    128) in bfloat16 through ``fused_groupnorm`` and
                    ``fused_resblock``, held within the bfloat16-vs-float32
                    gap, and on a 256x256 image in float32 through both;
                    global attention on two 720x480 images, unbatched and in
                    micro-batches of 16; the Laplacian path on one 720x480
                    pair through both routes; one training step of each
                    domain; every kernel against its plain version at these
                    paths' shapes (new rows of the kernel table)
  switches          the UNet's switches no shipped config turns on, at full
                    width (chains cut to 2 steps), each also on the card
                    against the CPU at a small size: ``wavelet_in_unet`` on
                    the reference UNet (two 720x480 images, 90 patches of
                    256x256, bfloat16 via ``fused_groupnorm`` and float32
                    via ``fused_resblock``; two DWTs and one IWT a UNet
                    call), one training step whose backward runs the DWT
                    kernel as the IWT's gradient, the wavelet kernels'
                    gradients against plain autograd (new rows of the
                    kernel table); ``use_window`` and ``use_fft`` on the
                    pixel profile (a 256x256 image, one training step
                    each); stage 1's aux models (WDNet, SAM, HFRM with TLC)
                    and one full-width HFRM step with the GAN and
                    perceptual terms
  multigpu          the multi-process paths (``parallel/dryrun.py``) on the
                    one card, two worlds started together: world 1 over
                    NCCL (torchrun's env rendezvous, the card's lock) and
                    world 2 over gloo (both ranks on the card; gloo moves
                    CUDA tensors through host copies).  Each runs a tiny
                    FSDP2 (world 2: DDP) step, the tiny sharded sampler,
                    the flagship's FSDP2 placement (world 1), a flagship
                    production step in float32 and bfloat16 under DDP
                    (and FSDP2 at world 1) held to one process's step on
                    the 16 crops, two 720x480 images restored
                    patch-parallel (90 patches, 2 steps) against the
                    unsharded restore, and restore() over each rank's
                    stripe; which collectives gloo takes on CUDA tensors

then the kernel table as one JSON line, the nvidia-smi line, and the final
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero.
It needs one CUDA card and the repository around it.

A kernel's ``ms`` is the wrapper's time, CUDA events around back-to-back
calls: what a caller pays when the card is not queued ahead, the host's
Python included.  ``device_ms`` is the card's own time: the same calls
captured in a CUDA graph and replayed, on inputs rotated past the L2 cache.
The wavelet rows add ``host_ms``, the host clock per call over 200
back-to-back calls (the wrapper's Python, its allocation and the launch;
their mean), ``host_median_ms`` (the median of the same calls' 5 batches
of 40, which one preemption of the shared host moves little), and
``copy_device_ms``, the card's own copy of the same
bytes timed as ``device_ms``: how close a memory-bound kernel can come to
its bound on this card.

    python3 chip_smoke.py --tree DIR --phases kernels,restore

runs only those phases, on the package of another checkout DIR (to time
two commits in turns in one run); ``--phases sweep`` times the GroupNorm
kernel under each launch plan.
"""

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

CARD = "NVIDIA H100 80GB HBM3"  # the card of the bounds (tools/roofline.PEAKS)
L2_BYTES = 50 * 2 ** 20    # its L2 cache
N_IMAGES, HEIGHT, WIDTH = 2, 480, 720
SEED = 61
DEV = "cuda"               # the card (the switches phase names it so)
TRAIN_STEPS = 3           # cut from 5 for the 5-minute cap
REF_STEPS = 5   # the reference profile's restores (its own 25, x0_preds[-5])
# timed calls of a plain version or a library call beside a GroupNorm or
# fused kernel, after one untimed call (cut from 10-20 for the 5-minute
# cap: those calls take 2-27 times the kernel's, and CUDA events time them
# back to back); a call longer than COMPARE_LONG_MS is timed once, where
# launch jitter is small beside it and repeats cost the cap most
COMPARE_ITERS = 3
COMPARE_LONG_MS = 10.0
HFRM_PARAMS = 15_941_667   # HFRM at full width: dim 32, 2,2,2,4 / 6 / 2,2,2,2
ROOT = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()


def emit(phase, **fields):
    print(json.dumps({"phase": phase,
                      "s": round(time.perf_counter() - T0, 3), **fields}),
          flush=True)


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


def compare_ms(fn):
    """Time of one call of a plain version or a library call: one untimed
    call, one timed; under COMPARE_LONG_MS the mean of COMPARE_ITERS more,
    timed back to back."""
    ms = time_ms(fn, 1, 1)
    return ms if ms >= COMPARE_LONG_MS else time_ms(fn, COMPARE_ITERS, 0)


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


def host_times(fn, iters=40, batches=5):
    """Host time per call: the wrapper's Python, its allocation and the
    launch, on the host clock over ``batches`` x ``iters`` back-to-back
    calls that the card runs behind.  ``host_ms`` is their mean;
    ``host_median_ms`` the median of the batches' means, which another
    process taking the shared host for a while moves little."""
    import torch

    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(batches):
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        per_call.append((time.perf_counter() - t) * 1e3 / iters)
    torch.cuda.synchronize()
    return dict(host_ms=sum(per_call) / batches,
                host_median_ms=sorted(per_call)[batches // 2])


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


def card_figures():
    """The bounds' card's dense peaks by compute dtype and its memory rate
    (``bytes_per_s``): ``tools/roofline.PEAKS``, the tools' own."""
    from wavedm_tpu_torch.tools.roofline import PEAKS

    return PEAKS[CARD]


def bound_ms(*tensors):
    """Least time to read the inputs once and write the outputs once."""
    return bytes_ms(sum(t.numel() * t.element_size() for t in tensors))


def bytes_ms(nbytes):
    return nbytes / card_figures()["bytes_per_s"] * 1e3


def ops_ms(flops, dtype):
    """Least time for ``flops`` at the card's dense peak for ``dtype``."""
    return flops / card_figures()[str(dtype).split(".")[-1]] * 1e3


def gn_bound_ms(gn, x, swish):
    """GroupNorm's bound on ``x``: the bytes its launch declares."""
    n, c = x.shape[:2]
    return bytes_ms(gn.declared_work(n, c, x[0, 0].numel(), 32, swish,
                                     x.dtype)[2])


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


def unet_body(cfg, n_patches, hw=None, **overrides):
    """(the UNet of ``cfg`` without its use_window / wavelet_in_unet hooks,
    on the meta device; an input of ``n_patches`` at (H, W) = ``hw``
    (default: the size the UNet works at on a patch) for it): the body
    the norm sites sit in."""
    import torch

    from wavedm_tpu_torch.models.unet import DiffusionUNet, conv_in_channels

    d = cfg.data
    side = (d.image_size // (4 if d.wavelet_in_unet else 1)
            // (d.window_size if d.use_window else 1))
    hw = hw or (side, side)
    with torch.device("meta"):
        unet = DiffusionUNet.from_config(cfg, use_window=False,
                                         wavelet_in_unet=False, **overrides)
        x = torch.empty(n_patches, conv_in_channels(cfg), *hw)
    return unet, x


def gn_sites(cfg, n_patches, hw=None):
    """(C, H, W, swish) -> count over one UNet forward on (H, W) = ``hw``
    inputs (default: the size the UNet works at), from a forward on the
    meta device with hooks on every Normalize."""
    import torch
    from collections import Counter

    from wavedm_tpu_torch.models.layers import Normalize

    unet, x = unet_body(cfg, n_patches, hw, fused_gn=False)
    sites = Counter()
    for m in unet.modules():
        if isinstance(m, Normalize):
            m.register_forward_hook(lambda mod, inp, out: sites.update(
                [tuple(inp[0].shape[1:]) + (mod.swish,)]))
    unet(x, torch.empty(n_patches, device="meta"))
    return sites


def gn_plan(gn, n, c, hw, dtype):
    """The GroupNorm kernel's launch plan as printed; None for a package
    that has none (an earlier commit's, run with ``--tree``)."""
    if not hasattr(gn, "group_norm_plan"):
        return None
    plan = gn.group_norm_plan(n, c, hw, 32, dtype)
    return dict(plan._asdict(), kind=plan.kind)


def wavelet_rows(gen, n_images, phase, suffix=""):
    """The DWT and IWT kernels against their plain versions on
    ``n_images`` 720x480 images in [-1, 1] (the IWT on the DWT's output),
    each timed beside its plain version and one PyTorch call, and the
    card's own copy of its input (``copy_device_ms``: the same bytes read
    and written, a practical floor under the bound):
    {"wavelet_dec" + suffix: row, "wavelet_rec" + suffix: row}."""
    import torch
    import torch.nn.functional as F

    from wavedm_tpu_torch.ops import wavelet_cuda as wv
    from wavedm_tpu_torch.ops.wavelet import conv_weights

    dev = gen.device
    x = torch.rand(n_images, 3, HEIGHT, WIDTH, device=dev,
                   generator=gen) * 2 - 1
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
    rows = {}
    rows["wavelet_dec" + suffix] = dict(
        source="wavedm_tpu_torch/csrc/wavelet.cu",
        replaces="wavedm_tpu/ops/wavelet_pallas.py:44",
        max_abs_err=dec_err, tol=tol,
        ms=time_ms(lambda: wv.wavelet_dec_cuda(x)),
        device_ms=device_ms(wv.wavelet_dec_cuda, x),
        **host_times(lambda: wv.wavelet_dec_cuda(x)),
        plain_ms=time_ms(lambda: wv.wavelet_dec_plain(x)),
        bound_ms=bound_ms(x, z),
        library_ms=time_ms(lambda: F.conv2d(x, bank, stride=4, groups=3)),
        copy_device_ms=device_ms(torch.clone, x))
    rows["wavelet_rec" + suffix] = dict(
        source="wavedm_tpu_torch/csrc/wavelet.cu",
        replaces="wavedm_tpu/ops/wavelet_pallas.py:60",
        max_abs_err=rec_err, tol=tol, roundtrip_err=rt_err,
        ms=time_ms(lambda: wv.wavelet_rec_cuda(z)),
        device_ms=device_ms(wv.wavelet_rec_cuda, z),
        **host_times(lambda: wv.wavelet_rec_cuda(z)),
        plain_ms=time_ms(lambda: wv.wavelet_rec_plain(z)),
        bound_ms=bound_ms(z, back),
        library_ms=time_ms(
            lambda: F.conv_transpose2d(z_lib, bank, stride=4, groups=3)),
        copy_device_ms=device_ms(torch.clone, z))
    emit(phase, kernel="wavelet", shape=list(x.shape),
         dec_err=dec_err, rec_err=rec_err, roundtrip_err=rt_err, tol=tol)
    return rows


def wavelet_sizes():
    """``--phases kernels``' other wavelet rows, to time two trees in
    turns: 1 and 8 images, and the ``wavelet_in_unet`` slice with the
    gradients (:func:`wavelet_grad_rows`).  The whole script takes the
    8-image rows from ``serve`` and the slice's from ``switches``, which
    time them on those paths."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    rows = wavelet_rows(gen, 1, "kernels", "@1_image")
    rows.update(wavelet_rows(gen, SERVE_BATCH, "kernels", "@8_images"))
    rows.update(wavelet_grad_rows())
    return rows


def check_kernels(cfg, n_patches, n_images=N_IMAGES, tags=("f32", "bf16"),
                  phase="kernels"):
    """Each kernel against its plain version at the main path's shapes:
    the DWT/IWT on ``n_images`` 720x480 images, GroupNorm in the dtypes
    ``tags`` at every site of a UNet forward over ``n_patches`` patches."""
    import torch
    import torch.nn.functional as F

    from wavedm_tpu_torch.ops import groupnorm_cuda as gn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = wavelet_rows(gen, n_images, phase)

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
        if tag not in tags:
            continue
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
                    emit(phase, kernel=f"group_norm_{name}",
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
                p_ms = compare_ms(lambda: gn.group_norm_plain(
                    xs, wt, bs, 32, 1e-6, swish))
                l_ms = compare_ms(lib)
                b_ms = gn_bound_ms(gn, xs, swish)
                emit(phase, kernel=f"group_norm_{name}",
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


def fused_sites(cfg, n_patches, hw=None):
    """(Cin, H, W, Cout) -> count of GN -> swish -> conv3x3 pairs (both
    convs of every ResnetBlock) over one UNet forward on (H, W) = ``hw``
    inputs (default: the size the UNet works at), from a forward on the
    meta device."""
    import torch
    from collections import Counter

    from wavedm_tpu_torch.models.layers import ResnetBlock

    unet, x = unet_body(cfg, n_patches, hw, fused_gn=False,
                        fused_block=False)
    sites = Counter()
    for m in unet.modules():
        if isinstance(m, ResnetBlock):
            for conv in (m.conv1, m.conv2):
                conv.register_forward_hook(
                    lambda mod, inp, out: sites.update(
                        [tuple(inp[0].shape[1:]) + (out.shape[1],)]))
    unet(x, torch.empty(n_patches, device="meta"))
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


def fused_at(gen, sites, n, dtype, tag, tol, row, key="", iters=10,
             phase="kernels", timed=True):
    """The fused kernel at every site of ``sites`` at batch ``n`` against
    its plain version (``tol`` of the output scale; worst errors into
    ``row``), and, when ``timed``, its times summed over one UNet forward
    into ``row`` under names ending in ``key``: the wrapper, the card's
    own, the plain version, the library call and the bound.  Returns the
    split-K plan of each site."""
    import torch
    import torch.nn.functional as F

    from wavedm_tpu_torch.ops import fused_resblock as fr

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tot = dict.fromkeys(("ms", "device_ms", "plain_ms", "library_ms",
                         "bound_ms", "bytes_ms", "ops_ms"), 0.0)
    plans = {}
    for (cin, h, w, cout), count in sorted(sites.items()):
        x, sg, bg, wk, b = _fused_inputs(gen, n, cin, h, w, cout, dtype)
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
        if not timed:
            emit(phase, kernel=f"fused_gn_swish_conv_{tag}",
                 shape=[n, cin, h, w, cout], count_per_forward=count,
                 max_abs_err=err, max_rel_err=rel, tol_rel=tol)
            continue

        def lib():
            y = F.silu(F.group_norm(x.float(), 32, sg, bg, 1e-6))
            return F.conv2d(y.to(dtype), wk, bd, padding=1)

        k_ms = time_ms(lambda: fr.fused_gn_swish_conv(
            x, sg, bg, wk, b, dtype), iters, 1)
        d_ms = device_ms(lambda t: fr.fused_gn_swish_conv(
            t, sg, bg, wk, b, dtype), x, iters, 1)
        p_ms = compare_ms(lambda: fr.fused_gn_swish_conv_plain(
            x, sg, bg, wk, b, dtype))
        l_ms = compare_ms(lib)
        flops, _, nbytes = fr.declared_work(x.shape, cout, x.dtype, dtype)
        b_ms, o_ms = bytes_ms(nbytes), ops_ms(flops, dtype)
        emit(phase, kernel=f"fused_gn_swish_conv_{tag}",
             shape=[n, cin, h, w, cout], count_per_forward=count,
             max_rel_err=rel, ms=k_ms, device_ms=d_ms, plain_ms=p_ms,
             library_ms=l_ms, bytes_ms=b_ms, ops_ms=o_ms,
             tflops=flops / k_ms / 1e9)
        for name, val in (("ms", k_ms), ("device_ms", d_ms),
                          ("plain_ms", p_ms), ("library_ms", l_ms),
                          ("bytes_ms", b_ms), ("ops_ms", o_ms)):
            tot[name] += count * val          # per UNet forward
    if timed:
        tot["bound_ms"] = max(tot["bytes_ms"], tot["ops_ms"])
        for name, val in tot.items():
            row[name + key] = val
    return plans


def check_fused_kernels(cfg):
    """The fused GN -> swish -> conv3x3 kernel at every flagship site shape
    against its plain version (N = 2), its gradients at two shapes, and
    its time summed over one UNet forward at N = 90 (serving) and N = 16
    (production training) beside the plain version, the library call and
    the operations bound."""
    import torch

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
        for n, key in ((90, ""), (16, "_n16")):
            iters = 3 if (tag, n) == ("f32", 90) else 10
            plans = fused_at(gen, sites, n, dtype, tag, tol, row, key, iters)
            assert row["ops_ms" + key] >= row["bytes_ms" + key]
            if n == 90:
                assert all(s == 1 for (_, h, _), s in plans.items()
                           if h > 8), plans
            else:
                assert all(s > 1 for (_, h, _), s in plans.items()
                           if h == 8), plans
            emit("kernels", kernel=f"fused_gn_swish_conv_{tag}", n=n,
                 split_k={f"{c}x{h}x{h}->{co}": s
                          for (c, h, co), s in sorted(plans.items())})
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


def profiling_phase():
    """``utils/profiling.trace`` with ``annotate`` around one DWT kernel
    call on two 720x480 images: the Chrome trace must hold the annotated
    region; how many of its events are device kernels says whether
    torch.profiler's CUPTI tracing sees the card on this machine.  Then
    one production UNet forward (bfloat16, two images' 90 patches) traced
    under ``fused_groupnorm`` and under ``fused_resblock`` and read by
    ``tools/trace_summary``: each of the port's kernel families counts as
    many launch events as ``launch_counts()`` grew by, and the card was
    busy."""
    import torch

    from wavedm_tpu_torch.config import production_profile
    from wavedm_tpu_torch.inference.loader import build_unet
    from wavedm_tpu_torch.ops import launch_counts
    from wavedm_tpu_torch.ops.wavelet_cuda import wavelet_dec_cuda
    from wavedm_tpu_torch.tools import trace_summary
    from wavedm_tpu_torch.utils.profiling import annotate, trace

    log_dir = os.path.join(ROOT, "wavedm_tpu_torch", "_build", "smoke_trace")
    x = torch.rand(N_IMAGES, 3, HEIGHT, WIDTH, device="cuda")
    wavelet_dec_cuda(x)
    torch.cuda.synchronize()
    t = time.perf_counter()
    with trace(log_dir):
        with annotate("smoke_wavelet_dec"):
            wavelet_dec_cuda(x)
        torch.cuda.synchronize()
    trace_s = time.perf_counter() - t
    try:
        with open(os.path.join(log_dir, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    names = {e.get("name") for e in events}
    assert "smoke_wavelet_dec" in names, "no annotated region in the trace"
    kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
    emit("profiling", trace_s=trace_s, events=len(events),
         device_kernel_events=sum(e.get("cat") == "kernel" for e in events),
         device_kernels=kernels[:6])

    # the family of each launch_counts() key, as trace_summary names them
    family = {"wavelet": "wavelet", "group_norm": "group_norm",
              "fused_gn_swish_conv": "fused_conv"}
    n = N_IMAGES * 45
    for route in ("fused_groupnorm", "fused_resblock"):
        cfg = production_profile()
        setattr(cfg.parallel, route, True)
        cfg.validate()
        unet = build_unet(cfg, None, "cuda")
        xs = torch.randn(n, 96, 64, 64, device="cuda")
        ts = torch.zeros(n, device="cuda")
        with torch.no_grad():
            unet(xs, ts)
            torch.cuda.synchronize()
            before = launch_counts()
            t = time.perf_counter()
            with trace(log_dir):
                unet(xs, ts)
                torch.cuda.synchronize()
            trace_s = time.perf_counter() - t
        grew = {k: v - before[k] for k, v in launch_counts().items()
                if v != before[k]}
        try:
            summary = trace_summary.summarize(
                trace_summary.find_trace(log_dir), top=5)
            text = trace_summary.report(summary)
        finally:
            shutil.rmtree(log_dir, ignore_errors=True)
        assert text is not None and summary["busy_us"] > 0, summary["seen"]
        want = dict.fromkeys(family.values(), 0)
        for key, val in grew.items():
            fam = next(f for p, f in family.items() if key.startswith(p))
            want[fam] += val
        got = {f: v["launch_events"] for f, v in summary["families"].items()}
        assert got == want, (route, got, want, grew)
        emit("profiling", tool="trace_summary", route=route, patches=n,
             dtype="bfloat16", trace_s=trace_s, launches=grew,
             family_launch_events=got, families=summary["families"],
             device_events=summary["events"],
             busy_ms=summary["busy_us"] / 1e3,
             by_category_ms={c: t / 1e3 for c, t in summary["by_category"]},
             top_ms=[[k[:80], t / 1e3] for k, t in summary["top"]])
        del unet, xs
        torch.cuda.empty_cache()


def synthetic_images(seed, n=N_IMAGES):
    """``n`` rain-degraded-looking (n, H, W, 3) images in [0, 1]: a smooth
    colour field with bright, blurred drops and sensor noise, from numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    side = max(HEIGHT, WIDTH)
    yy, xx = np.mgrid[0:HEIGHT, 0:WIDTH] / side
    imgs = []
    for _ in range(n):
        img = np.zeros((HEIGHT, WIDTH, 3))
        for c in range(3):
            f, p = rng.uniform(1, 6, 2), rng.uniform(0, 2 * np.pi, 2)
            img[..., c] = 0.5 + 0.25 * np.sin(f[0] * 2 * np.pi * xx + p[0]) \
                * np.cos(f[1] * 2 * np.pi * yy + p[1])
        drops = np.array([(rng.uniform(0, HEIGHT), rng.uniform(0, WIDTH),
                           rng.uniform(4, 18)) for _ in range(60)])
        # each drop's Gaussian is separable: the 60 drops sum as one
        # (H x 60) @ (60 x W) product, not 60 passes over the image
        cy, cx, r2 = drops[:, 0], drops[:, 1], 2 * drops[:, 2] ** 2
        gy = np.exp(-(yy[:, :1] * side - cy) ** 2 / r2)        # (H, 60)
        gx = np.exp(-(xx[:1].T * side - cx) ** 2 / r2)         # (W, 60)
        img += 0.3 * (gy @ gx.T)[..., None]
        img += rng.normal(0, 0.02, img.shape)
        imgs.append(np.clip(img, 0, 1))
    return np.stack(imgs).astype(np.float32)


GOLDEN = os.path.join(ROOT, "tests", "golden", "images")
# committed fixtures of every format the served path reads
FORMAT_FILES = ("raindrop_0000_palette.png", "raindrop_0000.jpg",
                "rain_q80.webp", "rain_lossless.webp", "rain_rgba.webp",
                "rain.gif", "rain.tif")


def image_decoders():
    """PIL's version and whether it has its WebP and JPEG codecs on this
    machine; and the decoder ``utils/images.decode_image`` picks for each
    committed fixture (``format: decoder``; PNG and BMP are numpy's)."""
    from wavedm_tpu_torch.utils.images import image_decoder

    try:
        import PIL
        from PIL import features
        pil = {"version": PIL.__version__, "webp": features.check("webp"),
               "jpg": features.check("jpg")}
    except ImportError as e:
        pil = {"version": None, "reason": str(e)}
    decoders = {}
    for name in FORMAT_FILES:
        with open(os.path.join(GOLDEN, name), "rb") as f:
            decoders[name] = ": ".join(image_decoder(f.read()))
    return pil, decoders


NATIVE_DECODE_REPEATS = 10


def native_phase(status):
    """The data library on this machine: built from the port's sources
    (available, or the run fails), needing no libjpeg or libpng; every
    committed JPEG/PNG fixture decoded by it (from the file, float32, and
    from memory, uint8) equal to ``decodes.npz``; ``make_crop_batch`` of
    two RainDrop test pairs equal to the JAX package's ``crop_batch.npz``;
    and the median of NATIVE_DECODE_REPEATS decodes from memory of a
    720x480 JPEG and PNG through the library, PIL and ``decode_png``."""
    import io

    import numpy as np

    from wavedm_tpu_torch.data import native_loader
    from wavedm_tpu_torch.utils.images import decode_png

    assert status["available"], status["reason"]
    assert not [n for n in status["needed"]
                if n.startswith(("libjpeg", "libpng"))], status["needed"]
    inv = np.float32(1.0 / 255.0)
    expect = np.load(os.path.join(GOLDEN, "decodes.npz"))
    fixtures = sorted(f for f in os.listdir(GOLDEN)
                      if f.endswith((".jpg", ".png")))
    for name in fixtures:
        path = os.path.join(GOLDEN, name)
        with open(path, "rb") as f:
            data = f.read()
        assert np.array_equal(native_loader.decode_image(path),
                              expect[name] * inv), name
        assert np.array_equal(native_loader.decode_bytes(data, name),
                              expect[name]), name
    fx = np.load(os.path.join(GOLDEN, "crop_batch.npz"))
    batch = native_loader.make_crop_batch(
        [os.path.join(ROOT, p) for p in fx["inputs"]],
        [os.path.join(ROOT, p) for p in fx["gts"]], int(fx["patch_n"]),
        int(fx["patch"]), int(fx["seed"]), n_threads=2)
    assert np.array_equal(batch, fx["batch"] * inv)

    try:
        from PIL import Image
    except ImportError:
        Image = None
    decoders = {"library": lambda d: native_loader.decode_bytes(d)}
    if Image is not None:
        decoders["PIL"] = lambda d: np.asarray(
            Image.open(io.BytesIO(d)).convert("RGB"))
    png = os.path.join(ROOT, "data", "raindrop", "raindrop_test", "input",
                       "0000.png")
    decode_ms = {}
    for path in (os.path.join(GOLDEN, "raindrop_0000.jpg"), png):
        with open(path, "rb") as f:
            data = f.read()
        use = dict(decoders)
        if path.endswith(".png"):
            use["numpy"] = decode_png
        ref, times, same = None, {}, {}
        for name, fn in use.items():
            out = fn(data)              # the first call untimed
            assert out.shape == (480, 720, 3), (name, out.shape)
            if ref is None:
                ref = out
            else:                       # recorded, not required
                same[name] = bool(np.array_equal(out, ref))
            ms = []
            for _ in range(NATIVE_DECODE_REPEATS):
                t = time.perf_counter()
                fn(data)
                ms.append((time.perf_counter() - t) * 1e3)
            times[name] = float(np.median(ms))
        decode_ms[os.path.relpath(path, ROOT)] = dict(
            times, equal_to_library=same)
    return dict(status, fixtures_equal_decodes_npz=len(fixtures),
                crop_batch_equal_jax=True, decode_ms_median=decode_ms,
                decode_repeats=NATIVE_DECODE_REPEATS)


def reset_counts():
    from wavedm_tpu_torch.ops import reset_launch_counts

    reset_launch_counts()


def read_counts():
    from wavedm_tpu_torch.ops import launch_counts

    return launch_counts()


def restore_timed(rest, images):
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out, hfrm_out = rest.restore_image_device(images)
    torch.cuda.synchronize()
    return out, hfrm_out, (time.perf_counter() - t) * 1e3


def check_output(out, n=N_IMAGES, hw=(HEIGHT, WIDTH)):
    import torch

    assert tuple(out.shape) == (n, *hw, 3), out.shape
    assert bool(torch.isfinite(out).all())
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0


SMALL_VARIANTS = (("ddim", {}), ("dpmpp2m", {"solver": "dpmpp2m"}),
                  ("v", {"pred_type": "v"}), ("eta0.5", {"eta": 0.5}),
                  ("micro_batch3", {"patch_micro_batch": 3}),
                  ("whole_image", {"whole_image": True}))


SMALL_STEPS = 5         # small_parity's chains (cut from 10)


def small_parity():
    """A small restoration through the kernels on the card against the same
    restoration through the plain versions on the CPU, float32, under each
    chain of the sampler: DDIM, dpmpp2m, a v-trained UNet, eta = 0.5 (both
    sides given the same step noise), patch micro-batches of 3 and the
    whole-image chain."""
    import numpy as np
    import torch

    from wavedm_tpu_torch.config import config_from_dict
    from wavedm_tpu_torch.inference.loader import build_restorer

    images = np.random.default_rng(SEED).random((2, 64, 96, 3),
                                                dtype=np.float32)
    gen = torch.Generator().manual_seed(0)
    noise = torch.randn(2, 3, 16, 24, generator=gen)
    step_noise = torch.randn(SMALL_STEPS, 2, 3, 16, 24, generator=gen)
    for name, variant in SMALL_VARIANTS:
        variant = dict(variant)
        pred_type = variant.pop("pred_type", "eps")
        cfg = config_from_dict({
            "data": {"image_size": 8, "patch_size": 32},
            "model": {"ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1,
                      "attn_resolutions": [4]},
            "diffusion": {"num_diffusion_timesteps": 50},
            "training": {"pred_type": pred_type},
            "sampling": {"sampling_timesteps": SMALL_STEPS, "grid_r": 4,
                         **variant},
            "hfrm": {"dim": 8, "middle_blk_num": 1, "enc_blk_nums": [1, 1],
                     "dec_blk_nums": [1, 1]},
            "parallel": {"fused_groupnorm": True}})
        cpu = build_restorer(cfg, None, None, device="cpu")
        ref, _ = cpu.restore_image(images, noise=noise, step_noise=step_noise)
        gpu = build_restorer(cfg, cpu.unet.state_dict(),
                             cpu.hfrm.state_dict(), device="cuda")
        out, _ = gpu.restore_image(images, noise=noise, step_noise=step_noise)
        err = float(np.abs(out - ref).max())
        # float32 on both sides, TF32 off: summation order only (the CPU
        # tests hold the same paths against JAX to this bound)
        assert err <= 1e-4, (name, err)
        emit("small_parity", chain=name, shape=list(out.shape),
             max_abs_err=err, tol=1e-4)


def whole_image_hw(cfg):
    """The UNet's input size on the whole-image chain: the wavelet image
    (H/4, W/4) reflect-padded to the UNet's 2**(levels-1)."""
    div = 2 ** (len(cfg.model.ch_mult) - 1)
    return tuple(d // 4 + (-(d // 4)) % div for d in (HEIGHT, WIDTH))


def check_whole_image_kernels(cfg):
    """GroupNorm(+swish) and the fused GN -> swish -> conv3x3 kernel at the
    sites of the whole-image chain over the two 720x480 images (a
    (2, 96, 120, 184) UNet input, levels at 120x184, 60x92, 30x46 and
    15x23) against their plain versions, at the tolerances of
    :func:`check_kernels` and :func:`check_fused_kernels`; device time,
    library time and bound summed over one forward."""
    import torch
    import torch.nn.functional as F

    from wavedm_tpu_torch.ops import fused_resblock as fr
    from wavedm_tpu_torch.ops import groupnorm_cuda as gn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    n, hw = N_IMAGES, whole_image_hw(cfg)
    sites = gn_sites(cfg, n, hw)
    assert sum(sites.values()) == 51, sites
    out = {}
    for dtype, tag, atol, rtol in ((torch.float32, "f32", 2e-5, 2e-5),
                                   (torch.bfloat16, "bf16", 1e-6, 2.0 ** -6)):
        tot = dict(max_abs_err=0.0, device_ms=0.0, library_ms=0.0,
                   bound_ms=0.0)
        for (c, h, w, swish), count in sorted(sites.items()):
            x = (torch.randn(n, c, h, w, device=dev, generator=gen) * 3
                 + 1).to(dtype)
            wt = torch.randn(c, device=dev, generator=gen)
            bs = torch.randn(c, device=dev, generator=gen)
            y = gn.group_norm(x, wt, bs, 32, 1e-6, swish)
            yp = gn.group_norm_plain(x, wt, bs, 32, 1e-6, swish)
            torch.cuda.synchronize()
            diff = (y.float() - yp.float()).abs()
            excess = float((diff - rtol * yp.float().abs()).max())
            assert excess <= atol, (tag, c, h, w, swish, excess)
            wl, bl = wt.to(dtype), bs.to(dtype)

            def lib():
                o = F.group_norm(x, 32, wl, bl, 1e-6)
                return F.silu(o) if swish else o

            d_ms = device_ms(lambda t: gn.group_norm(t, wt, bs, 32, 1e-6,
                                                     swish), x)
            l_ms = compare_ms(lib)
            b_ms = gn_bound_ms(gn, x, swish)
            emit("kernels", kernel=f"group_norm_{tag}", sites="whole_image",
                 shape=[n, c, h, w], swish=swish, count_per_forward=count,
                 max_abs_err=float(diff.max()), device_ms=d_ms,
                 library_ms=l_ms, bound_ms=b_ms, share_of_bound=b_ms / d_ms,
                 plan=gn_plan(gn, n, c, h * w, dtype))
            tot["max_abs_err"] = max(tot["max_abs_err"], float(diff.max()))
            for key, val in (("device_ms", d_ms), ("library_ms", l_ms),
                             ("bound_ms", b_ms)):
                tot[key] += count * val
        emit("kernels", kernel=f"group_norm_{tag}", sites="whole_image",
             per=f"UNet forward on ({n}, 96, {hw[0]}, {hw[1]}), 51 sites",
             **tot)
        out[f"group_norm_{tag}"] = tot

    sites = fused_sites(cfg, n, hw)
    assert sum(sites.values()) == 44, sites
    for dtype, tag, tol in ((torch.float32, "f32", 1e-4),
                            (torch.bfloat16, "bf16", 2.0 ** -7)):
        tot = dict(max_rel_err=0.0, device_ms=0.0, library_ms=0.0,
                   bytes_ms=0.0, ops_ms=0.0)
        iters = 5 if tag == "f32" else 10
        for (cin, h, w, cout), count in sorted(sites.items()):
            x, sg, bg, wk, b = _fused_inputs(gen, n, cin, h, w, cout, dtype)
            y = fr.fused_gn_swish_conv(x, sg, bg, wk, b, dtype)
            ref = fr.fused_gn_swish_conv_plain(x, sg, bg, wk, b, dtype)
            torch.cuda.synchronize()
            rel = float((y.float() - ref.float()).abs().max()
                        / ref.float().abs().max())
            assert rel <= tol, (tag, cin, h, w, cout, rel)
            bd = b.to(dtype)

            def lib():
                z = F.silu(F.group_norm(x.float(), 32, sg, bg, 1e-6))
                return F.conv2d(z.to(dtype), wk, bd, padding=1)

            d_ms = device_ms(lambda t: fr.fused_gn_swish_conv(
                t, sg, bg, wk, b, dtype), x, iters, 1)
            l_ms = compare_ms(lib)
            flops, _, nbytes = fr.declared_work(x.shape, cout, x.dtype,
                                                dtype)
            by_ms, o_ms = bytes_ms(nbytes), ops_ms(flops, dtype)
            emit("kernels", kernel=f"fused_gn_swish_conv_{tag}",
                 sites="whole_image", shape=[n, cin, h, w, cout],
                 count_per_forward=count, max_rel_err=rel, device_ms=d_ms,
                 library_ms=l_ms, bytes_ms=by_ms, ops_ms=o_ms,
                 share_of_bound=max(by_ms, o_ms) / d_ms)
            tot["max_rel_err"] = max(tot["max_rel_err"], rel)
            for key, val in (("device_ms", d_ms), ("library_ms", l_ms),
                             ("bytes_ms", by_ms), ("ops_ms", o_ms)):
                tot[key] += count * val
        tot["bound_ms"] = max(tot["bytes_ms"], tot["ops_ms"])
        emit("kernels", kernel=f"fused_gn_swish_conv_{tag}",
             sites="whole_image",
             per=f"UNet forward on ({n}, 96, {hw[0]}, {hw[1]}), 44 sites",
             **tot)
        out[f"fused_gn_swish_conv_{tag}"] = tot
    return out


def counted_restore(rest, images, want, name, launches=None):
    """A first restore with the launch counts set to 0 just before it,
    checked against ``want`` and added to ``launches`` (when given);
    returns (output, first ms, the launches it made)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out, _, first_ms = restore_timed(rest, images)
    counts = read_counts()
    check_output(out, len(images), images.shape[1:3])
    got = {k: v for k, v in counts.items() if v}
    assert got == want, (name, got, want)
    for key, val in got.items() if launches is not None else ():
        launches[key] += val
    return out, first_ms, got


WHOLE_STEPS = 3         # the whole-image chain's steps (cut from 10)


def sampler_phase(images, unet_sd, hfrm_sd, bf16_gap, launches):
    """The production profile (bfloat16, 10 steps over [0, 300),
    ``fused_groupnorm``) on the two 720x480 images through the sampler's
    other chains, the same weights and noise: dpmpp2m against DDIM, timed
    in turns; patch micro-batches of 16 against the unbatched chain, held
    to this run's bfloat16-vs-float32 gap; the whole-image chain
    (``WHOLE_STEPS`` steps over [0, 300)), in bfloat16 and float32, and
    through ``fused_resblock`` held to the whole-image chain's own
    bfloat16-vs-float32 gap."""
    import torch

    from wavedm_tpu_torch.config import production_profile
    from wavedm_tpu_torch.inference.loader import build_restorer

    def restorer(weights=True, **changes):
        cfg = production_profile()
        cfg.parallel.fused_groupnorm = True
        for key, val in changes.items():
            section, name = key.split("__")
            setattr(getattr(cfg, section), name, val)
        cfg.validate()
        if weights:
            return build_restorer(cfg, unet_sd, hfrm_sd, device="cuda")
        return build_restorer(cfg, None, None, device="cuda")

    def gn_want(steps, chunks, tag="bf16"):
        return {f"group_norm_{tag}_swish": 45 * steps * chunks,
                f"group_norm_{tag}": 6 * steps * chunks,
                "wavelet_dec": 2, "wavelet_rec": 1}

    rests = {"ddim": restorer(),
             "dpmpp2m": restorer(sampling__solver="dpmpp2m")}
    steps = len(rests["ddim"].seq)
    outs, runs = {}, {name: [] for name in rests}
    for name, rest in rests.items():
        outs[name], _, _ = counted_restore(rest, images, gn_want(steps, 1),
                                           name, launches)
    # two turns (the script runs under a 5-minute cap)
    for name in ("ddim", "dpmpp2m", "dpmpp2m", "ddim"):
        runs[name].append(restore_timed(rests[name], images)[2] / N_IMAGES)
    del rests
    ms = {name: sum(v) / len(v) for name, v in runs.items()}
    emit("sampler", chain="dpmpp2m_vs_ddim", steps=steps,
         ms_per_image=ms, ms_per_image_runs=runs,
         dpmpp2m_over_ddim=ms["dpmpp2m"] / ms["ddim"],
         max_abs_diff=float((outs["dpmpp2m"] - outs["ddim"]).abs().max()))

    # 90 patches in chunks of 16: five of 16 and one of 10
    from wavedm_tpu_torch.diffusion.sampling import overlapping_grid_corners

    cfg = production_profile()
    patches = N_IMAGES * len(overlapping_grid_corners(
        HEIGHT // 4, WIDTH // 4, cfg.data.image_size, cfg.sampling.grid_r))
    chunks = -(-patches // 16)
    mb = restorer(sampling__patch_micro_batch=16)
    mb_out, first_ms, _ = counted_restore(
        mb, images, gn_want(steps, chunks), "micro16", launches)
    # one steady run (the script runs under a 5-minute cap)
    mb_ms = [restore_timed(mb, images)[2] / N_IMAGES]
    del mb
    diff = float((mb_out - outs["ddim"]).abs().max())
    assert diff <= bf16_gap, (diff, bf16_gap)
    emit("sampler", chain="patch_micro_batch16", patches=patches,
         chunks=chunks,
         first_ms_per_image=first_ms / N_IMAGES, ms_per_image_runs=mb_ms,
         ms_per_image=sum(mb_ms) / len(mb_ms),
         over_unbatched=sum(mb_ms) / len(mb_ms) / ms["ddim"],
         max_abs_diff_vs_unbatched=diff, tol_bf16_vs_f32_gap=bf16_gap)

    hw = whole_image_hw(cfg)
    whole = {}
    for name, changes, want in (
            ("bf16", {}, gn_want(WHOLE_STEPS, 1)),
            ("f32", {"parallel__compute_dtype": "float32"},
             gn_want(WHOLE_STEPS, 1, "f32")),
            ("bf16_fused_resblock", {"parallel__fused_groupnorm": False,
                                     "parallel__fused_resblock": True},
             {"fused_gn_swish_conv_bf16": 44 * WHOLE_STEPS, "wavelet_dec": 2,
              "wavelet_rec": 1})):
        rest = restorer(weights=name != "f32", sampling__whole_image=True,
                        sampling__sampling_timesteps=WHOLE_STEPS, **changes)
        out, first_ms, got = counted_restore(rest, images, want,
                                             f"whole_image {name}", launches)
        peak = torch.cuda.max_memory_allocated()
        # float32 goes through cuDNN's float32 convolutions: seconds a run,
        # so its counted first run is its time
        w_ms = [restore_timed(rest, images)[2] / N_IMAGES
                for _ in range(0 if name == "f32" else 1)] or [
                    first_ms / N_IMAGES]
        del rest
        whole[name] = out
        emit("sampler", chain="whole_image", variant=name,
             unet_input=[N_IMAGES, 96, *hw], launches=got,
             first_ms_per_image=first_ms / N_IMAGES, ms_per_image_runs=w_ms,
             ms_per_image=sum(w_ms) / len(w_ms), peak_bytes=peak,
             out_min=float(out.min()), out_max=float(out.max()))
    whole_gap = float((whole["bf16"] - whole["f32"]).abs().max())
    fr_diff = float((whole["bf16_fused_resblock"] - whole["bf16"]).abs().max())
    assert fr_diff <= whole_gap, (fr_diff, whole_gap)
    emit("sampler", chain="whole_image", fused_resblock_vs_fused_groupnorm=
         fr_diff, tol_bf16_vs_f32_gap=whole_gap)
    torch.cuda.empty_cache()


SERVE_BATCH, SERVE_BURST, SERVE_WINDOW_MS = 8, 16, 500.0
# the formats burst's window: its handlers decode under one interpreter
# lock, and the 16-request burst's decodes ended up to 420 ms apart on an
# H100 machine's host, where one formats burst split at 500 ms; a burst of
# SERVE_BATCH requests fills the batch before a wider window ends
FORMATS_WINDOW_MS = 2000.0


class RecordingRestorer:
    """A restorer that keeps a copy of each batch the server hands it, so
    the served batches can be replayed directly, and the host clock at the
    start and end of each call; forwards the call."""

    def __init__(self, rest):
        self.rest, self.device = rest, rest.device
        self.batches, self.spans = [], []

    def restore_image(self, batch, generator=None):
        self.batches.append(batch.copy())
        t = time.perf_counter()
        out = self.rest.restore_image(batch, generator=generator)
        self.spans.append((t, time.perf_counter()))
        return out


# bodies posted beside their PNG twins: a lossy and a lossless WebP, a GIF
# and a JPEG (its decoder the data library's or PIL's, by the rule)
FORMAT_BODIES = ("rain_q80.webp", "rain_lossless.webp", "rain.gif",
                 "raindrop_0000.jpg")


class SameNoise:
    """A restorer whose every image, in every batch, starts from one x_T:
    a request's reply then depends on its pixels alone."""

    def __init__(self, rest, noise):
        self.rest, self.device, self.noise = rest, rest.device, noise

    def restore_image(self, batch, generator=None):
        return self.rest.restore_image(batch, noise=self.noise.expand(
            len(batch), -1, -1, -1).contiguous())


def serve_formats(rest, steps, launches):
    """Each body of ``FORMAT_BODIES`` that this machine decodes is posted
    beside the same pixels as a PNG (its decode here, encoded), all in one
    burst to a server whose images share one x_T: each reply must equal
    its twin's within one uint8 level.  A body this machine cannot decode
    (no PIL, or a PIL without the codec) must get a 500 naming why.  Which
    case held, and which decoder took each body, is reported; the batch's
    launches are counted and checked."""
    import threading
    import urllib.error
    import urllib.request

    import numpy as np
    import torch

    from wavedm_tpu_torch.config import production_profile
    from wavedm_tpu_torch.inference.server import RestorationServer
    from wavedm_tpu_torch.utils.images import (decode_image, decode_png,
                                               encode_png, image_decoder)

    pil = np.load(os.path.join(GOLDEN, "decodes.npz"))
    bodies, cases, requests, refused = {}, {}, [], {}
    for name in FORMAT_BODIES:
        with open(os.path.join(GOLDEN, name), "rb") as f:
            data = f.read()
        case = {"decoder": ": ".join(image_decoder(data))}
        try:
            img = decode_image(data, name)
        except ValueError as e:
            assert "PIL is not installed" in str(e) or "codec" in str(e), e
            case["refused"] = str(e)
            refused[name] = data
        else:
            case["equal_to_committed_pil_decode"] = bool(
                np.array_equal(img, pil[name]))
            bodies[name] = len(requests)
            requests += [data, encode_png(img)]
        cases[name] = case
    gen = torch.Generator(device=rest.device).manual_seed(SEED + 12)
    noise = torch.randn((1, 3, HEIGHT // 4, WIDTH // 4), generator=gen,
                        device=rest.device)
    srv = RestorationServer(SameNoise(rest, noise), batch=SERVE_BATCH,
                            window_ms=FORMATS_WINDOW_MS, rng_seed=SEED)
    httpd = srv.serve("127.0.0.1", 0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}/restore"
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    replies, failures = [None] * len(requests), []

    def send(body):
        req = urllib.request.Request(url, data=body, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=180) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def post(i, body):
        try:
            replies[i] = send(body)
        except Exception as e:  # noqa: BLE001 -- reported below
            failures.append(f"request {i}: {type(e).__name__}: {e}")

    try:
        torch.cuda.synchronize()
        reset_counts()
        clients = [threading.Thread(target=post, args=(i, body), daemon=True)
                   for i, body in enumerate(requests)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(240)
        torch.cuda.synchronize()
        counts = read_counts()
        for name, data in refused.items():
            status, text = send(data)
            cases[name]["reply"] = [status, text.decode()[:300]]
            assert status == 500 and "PIL" in cases[name]["reply"][1], \
                cases[name]
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop(timeout=300)
        http_thread.join(60)
    assert not failures, failures
    for name, i in bodies.items():
        (s1, fmt_reply), (s2, png_reply) = replies[i], replies[i + 1]
        assert s1 == s2 == 200, (name, s1, s2)
        a, b = decode_png(fmt_reply, name), decode_png(png_reply, "twin")
        assert a.shape == (HEIGHT, WIDTH, 3), a.shape
        cases[name]["max_uint8_diff_vs_png_twin"] = int(np.abs(
            a.astype(int) - b.astype(int)).max())
        assert cases[name]["max_uint8_diff_vs_png_twin"] <= 1, cases[name]
    n_batches = srv.stats["batches"]
    assert n_batches == (1 if bodies else 0), srv.stats
    norms = gn_sites(production_profile(), 1)
    swish = sum(v for k, v in norms.items() if k[3])
    want = ({"group_norm_bf16_swish": swish * steps * n_batches,
             "group_norm_bf16": (sum(norms.values()) - swish) * steps
             * n_batches,
             "wavelet_dec": 2 * n_batches, "wavelet_rec": n_batches}
            if n_batches else {})
    got = {k: v for k, v in counts.items() if v}
    assert got == want, ("serve formats", got, want)
    for key, val in got.items():
        launches[key] += val
    for key in ("wavelet_dec", "wavelet_rec"):     # the 8-image rows
        launches[f"{key}@8_images"] = launches.get(f"{key}@8_images",
                                                   0) + got.get(key, 0)
    return dict(requests=len(requests), batches=n_batches, formats=cases,
                launches=got)


def serve_phase(launches, rows):
    """Serving on the production profile (bfloat16, 10 steps, random
    weights from seed 61) at batch 8.

    First every kernel of the served path against its plain version at
    the served shapes (8 images; N = 360 patches a UNet call).  Then the
    card's batch-8 numbers: ``restore_image_device`` on 8
    synthetic 720x480 images through ``fused_groupnorm`` and through
    ``fused_resblock``, same weights, inputs and noise, the second held to
    the bfloat16-vs-float32 gap of the same batch (float32 through the
    fused kernel).  Then a ``RestorationServer`` at batch 8 on 127.0.0.1,
    after a warmup, with a 500 ms window: the 16 handler threads decode
    their PNGs under one interpreter lock (~10 ms each), so a 30-50 ms
    window would split the burst by timing alone.  16 concurrent 720x480
    requests (14 synthetic PNGs, RainDrop test image 0000 as the committed
    palette PNG and as the committed JPEG, each decoded here equal to
    PIL's committed decode; a 15th PNG in the JPEG's place where the data
    library is unavailable) must come back in 2 batches, each reply within
    one uint8 level of the restorer called directly on the same padded
    batch with a generator seeded as the server's; a lone request (padded
    1 -> 8) is timed beside ``restore_image`` at batch 1; a body that is
    not an image gets a 500 (and the JPEG too, without the data library)
    and the next request a 200.  The launches of the 4 served
    batches are counted: they are those of the table's 8-image DWT/IWT
    rows (``@8_images``, timed here), and the batch-1 restore's those of
    its 1-image rows.  Every client call has a timeout; the server is
    stopped and its threads joined before the checks."""
    import threading
    import urllib.error
    import urllib.request

    import numpy as np
    import torch

    from wavedm_tpu_torch.config import production_profile
    from wavedm_tpu_torch.inference.loader import build_restorer
    from wavedm_tpu_torch.inference.server import RestorationServer
    from wavedm_tpu_torch.utils.images import (decode_image, decode_png,
                                               encode_png, image_decoder,
                                               to_uint8)

    def restorer(**parallel):
        cfg = production_profile()
        for key, val in parallel.items():
            setattr(cfg.parallel, key, val)
        return build_restorer(cfg.validate(), None, None, device="cuda")

    # every kernel of the served path against its plain version at the
    # served shapes, at the tolerances of the kernels phase: the DWT/IWT on
    # 8 images, GroupNorm (bfloat16, swish on and off) and the fused kernel
    # at N = 360 patches a UNet call, timed; the fused kernel in float32
    # (the gap run below) checked only
    n_patches = SERVE_BATCH * 45
    served = check_kernels(production_profile(), n_patches, SERVE_BATCH,
                           ("bf16",), "serve")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    sites = fused_sites(production_profile(), 2)
    for dtype, tag, tol, timed in ((torch.bfloat16, "bf16", 2.0 ** -7, True),
                                   (torch.float32, "f32", 1e-4, False)):
        row = dict(max_abs_err=0.0, max_rel_err=0.0, tol_rel=tol,
                   bound_by="operations")
        fused_at(gen, sites, n_patches, dtype, tag, tol, row, iters=3,
                 phase="serve", timed=timed)
        served[f"fused_gn_swish_conv_{tag}"] = row
    for key in ("wavelet_dec", "wavelet_rec"):     # rows of the table
        rows[f"{key}@8_images"] = served[key]
    for name, row in served.items():
        emit("serve", part="kernels", kernel=name,
             per=f"call on {SERVE_BATCH} images (wavelet) or UNet forward "
             f"at N = {n_patches}",
             **{k: v for k, v in row.items() if k not in ("source",
                                                          "replaces")})
    del gen
    torch.cuda.empty_cache()

    # the card's own batch-8 time, both kernel routes
    images = synthetic_images(SEED + 5, SERVE_BATCH)
    direct, outs, noise = {}, {}, None
    for name, parallel in (
            ("fused_groupnorm", {"fused_groupnorm": True}),
            ("fused_resblock", {"fused_resblock": True}),
            ("float32", {"fused_resblock": True,
                         "compute_dtype": "float32"})):
        rest = restorer(**parallel)
        if noise is None:
            gen = torch.Generator(device=rest.device).manual_seed(SEED)
            noise = torch.randn((SERVE_BATCH, 3, HEIGHT // 4, WIDTH // 4),
                                generator=gen, device=rest.device)
        runs = []
        # fused_groupnorm alone gets a steady run (the script runs under
        # a 5-minute cap)
        for _ in range(2 if name == "fused_groupnorm" else 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out, _ = rest.restore_image_device(images, noise=noise)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t) * 1e3 / SERVE_BATCH)
        check_output(out, SERVE_BATCH)
        outs[name] = out
        steady = runs[1:] or runs
        direct[name] = dict(first_ms_per_image=runs[0],
                            ms_per_image_runs=steady,
                            ms_per_image=sum(steady) / len(steady))
        steps = len(rest.seq)
        del rest, out
    gap = float((outs["fused_groupnorm"] - outs["float32"]).abs().max())
    fr_diff = float((outs["fused_resblock"]
                     - outs["fused_groupnorm"]).abs().max())
    assert fr_diff <= gap, (fr_diff, gap)
    del outs
    torch.cuda.empty_cache()
    emit("serve", part="direct", batch=SERVE_BATCH, steps=steps,
         patches_per_unet_call=SERVE_BATCH * 45, restore_image_device=direct,
         fused_resblock_vs_fused_groupnorm=fr_diff, tol_bf16_vs_f32_gap=gap)

    # the server
    rest = restorer(fused_groupnorm=True)
    record = RecordingRestorer(rest)
    srv = RestorationServer(record, batch=SERVE_BATCH,
                            window_ms=SERVE_WINDOW_MS, rng_seed=SEED)
    burst = to_uint8(synthetic_images(SEED + 6, SERVE_BURST))
    t = time.perf_counter()
    pngs = [encode_png(img) for img in burst]
    encode_ms = (time.perf_counter() - t) * 1e3 / SERVE_BURST
    t = time.perf_counter()
    for png in pngs:
        srv._decode(png)
    decode_ms = (time.perf_counter() - t) * 1e3 / SERVE_BURST
    # two of the burst's requests are RainDrop test image 0000 as the
    # committed palette PNG and JPEG, the palette PNG and a JPEG of the
    # data library decoded here equal to PIL's committed decode (a JPEG
    # through this machine's PIL is PIL's decode by construction; its
    # equality with the committed one is reported); where neither the
    # data library nor a PIL with the codec is here, a 15th synthetic PNG
    # takes the JPEG's place, and the JPEG gets a 500 naming why
    pil = np.load(os.path.join(GOLDEN, "decodes.npz"))
    encoded = {}
    for name in ("raindrop_0000_palette.png", "raindrop_0000.jpg"):
        with open(os.path.join(GOLDEN, name), "rb") as f:
            encoded[name] = f.read()
    jpeg_decoder = image_decoder(encoded["raindrop_0000.jpg"])[1]
    try:
        jpeg = decode_image(encoded["raindrop_0000.jpg"], "jpeg")
        jpeg_ok = True
    except ValueError as e:
        assert "PIL is not installed" in str(e) or "codec" in str(e), e
        jpeg_ok = False
    jpeg_equal_committed = (bool(np.array_equal(jpeg, pil[
        "raindrop_0000.jpg"])) if jpeg_ok else None)
    formats = ["raindrop_0000_palette.png"] + (
        ["raindrop_0000.jpg"] if jpeg_ok else [])
    format_ms, bodies = {}, pngs[:SERVE_BURST - len(formats)]
    for name in formats:
        img = decode_image(encoded[name], name)
        if image_decoder(encoded[name])[1] != "PIL":
            assert np.array_equal(img, pil[name]), name
        t = time.perf_counter()             # as the PNGs' time: _decode
        for _ in range(3):
            srv._decode(encoded[name])
        format_ms[name] = (time.perf_counter() - t) * 1e3 / 3
        bodies.append(encoded[name])
    # what the server restores from each request: the burst's, the lone
    # request's and the survivor's
    sources = [srv._decode(body) for body in bodies + pngs[:2]]
    t = time.perf_counter()
    rest.restore_image(np.zeros((SERVE_BATCH, HEIGHT, WIDTH, 3), np.float32))
    warmup_s = time.perf_counter() - t

    # the host clock around each request's decode in its handler thread
    decode_spans, real_decode = [], srv._decode

    def timed_decode(body):
        t = time.perf_counter()
        out = real_decode(body)
        decode_spans.append((t, time.perf_counter()))
        return out

    srv._decode = timed_decode
    httpd = srv.serve("127.0.0.1", 0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()

    def post(body, timeout=180):
        req = urllib.request.Request(url + "/restore", data=body,
                                     method="POST")
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read(), (time.perf_counter() - t) * 1e3

    def health():
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            return json.loads(r.read())

    results, failures = [None] * SERVE_BURST, []

    def client(i):
        try:
            results[i] = post(bodies[i])
        except Exception as e:  # noqa: BLE001 -- reported below
            failures.append(f"request {i}: {type(e).__name__}: {e}")

    try:
        # a first GET: urllib's one-time set-up in this process (its opener,
        # ~0.6 s) is the client's cost, not the server's
        assert health()["batches"] == 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        clients = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(SERVE_BURST)]
        burst_t0 = time.perf_counter()
        for c in clients:
            c.start()
        for c in clients:
            c.join(240)
        burst_s = time.perf_counter() - burst_t0
        assert not failures and all(results), (failures, results.count(None))
        replies = []
        for status, body, _ in results:
            assert status == 200, status
            img = decode_png(body, "reply")
            assert img.shape == (HEIGHT, WIDTH, 3), img.shape
            replies.append(img)
        after_burst = health()
        assert (after_burst["served"], after_burst["errors"],
                after_burst["batches"]) == (SERVE_BURST, 0, 2), after_burst

        status, body, lone_ms = post(pngs[0])
        assert status == 200, status
        replies.append(decode_png(body, "reply"))
        try:
            post(b"not a png", timeout=60)
            raise AssertionError("a body that is not a PNG got a 200")
        except urllib.error.HTTPError as e:
            bad = e.code, e.read().decode()[:200]
        assert bad[0] == 500 and "PIL cannot identify it" in bad[1], bad
        jpeg_refused = None
        if not jpeg_ok:
            try:
                post(encoded["raindrop_0000.jpg"], timeout=60)
                raise AssertionError("a JPEG got a 200 with no decoder")
            except urllib.error.HTTPError as e:
                jpeg_refused = e.code, e.read().decode()[:400]
            assert jpeg_refused[0] == 500 and "PIL" in jpeg_refused[1], \
                jpeg_refused
        status, body, survivor_ms = post(pngs[1])
        assert status == 200, status
        replies.append(decode_png(body, "reply"))
        final = health()
        assert (final["served"], final["errors"], final["batches"]) \
            == (SERVE_BURST + 2, 0, 4), final
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop(timeout=300)
        http_thread.join(60)
    assert not srv._worker.is_alive() and not http_thread.is_alive()
    n_batches = 4
    norms = gn_sites(production_profile(), 1)   # 45 with swish, 6 without
    swish = sum(v for k, v in norms.items() if k[3])
    want = {"group_norm_bf16_swish": swish * steps * n_batches,
            "group_norm_bf16": (sum(norms.values()) - swish) * steps
            * n_batches,
            "wavelet_dec": 2 * n_batches, "wavelet_rec": n_batches}
    got = {k: v for k, v in counts.items() if v}
    assert got == want, ("serve", got, want)
    for key, val in got.items():
        launches[key] += val
    for key in ("wavelet_dec", "wavelet_rec"):     # the 8-image rows
        launches[f"{key}@8_images"] = launches.get(f"{key}@8_images",
                                                   0) + got[key]

    # each reply against the same padded batch restored directly, the
    # generator seeded and advanced as the server's
    assert len(record.batches) == n_batches, len(record.batches)
    gen = torch.Generator(device=rest.device).manual_seed(SEED)
    expect = []
    for batch in record.batches:
        out, _ = rest.restore_image(batch, generator=gen)
        expect.append((batch, np.clip(out * 255.0 + 0.5, 0, 255)
                       .astype(np.uint8)))
    spans = [(0, 2)] * SERVE_BURST + [(2, 3), (3, 4)]
    worst = 0
    for reply, src, (lo, hi) in zip(replies, sources, spans):
        rows = [(b, k) for b in range(lo, hi)
                for k in range(SERVE_BATCH)
                if np.array_equal(expect[b][0][k], src)]
        assert rows, "a reply's image is not in the batches it could be in"
        b, k = rows[0]
        worst = max(worst, int(np.abs(reply.astype(int)
                                      - expect[b][1][k].astype(int)).max()))
    assert worst <= 1, worst

    rest.restore_image(images[:1])
    torch.cuda.synchronize()
    reset_counts()
    t = time.perf_counter()
    rest.restore_image(images[:1])
    torch.cuda.synchronize()
    batch1_ms = (time.perf_counter() - t) * 1e3
    one = read_counts()         # the 1-image rows count this restore's
    assert (one["wavelet_dec"], one["wavelet_rec"]) == (2, 1), one
    for key in ("wavelet_dec", "wavelet_rec"):
        launches[f"{key}@1_image"] = launches.get(f"{key}@1_image",
                                                  0) + one[key]
    emit("serve", part="formats", **serve_formats(rest, steps, launches))
    del rest, expect
    torch.cuda.empty_cache()
    lat = sorted(r[2] for r in results)
    def rel(spans):
        return [[(a - burst_t0) * 1e3, (b - burst_t0) * 1e3]
                for a, b in spans]

    emit("serve", part="server", batch=SERVE_BATCH, window_ms=SERVE_WINDOW_MS,
         requests=SERVE_BURST, batches_for_burst=after_burst["batches"],
         burst_decode_start_end_ms=rel(decode_spans[:SERVE_BURST]),
         burst_batches_start_end_ms=rel(record.spans[:2]),
         served_batch_ms=[(b - a) * 1e3 for a, b in record.spans],
         served_ms_per_image=burst_s * 1e3 / SERVE_BURST,
         direct_ms_per_image={k: v["ms_per_image"] for k, v in direct.items()
                              if k != "float32"},
         latency_ms_p50=lat[len(lat) // 2], latency_ms_max=lat[-1],
         latency_ms=lat, lone_request_ms=lone_ms,
         restore_image_batch1_ms=batch1_ms, survivor_ms=survivor_ms,
         host_decode_ms_per_request=decode_ms,
         host_decode_ms_by_file={"synthetic_png": decode_ms, **format_ms},
         burst_formats=formats, jpeg_decoder=jpeg_decoder,
         jpeg_equal_to_committed_pil_decode=jpeg_equal_committed,
         jpeg_refused=jpeg_refused,
         host_encode_ms_per_request=encode_ms, warmup_s=warmup_s,
         peak_bytes=peak, max_uint8_diff_vs_direct=worst,
         bad_request=bad[0], launches=got, healthz=final)


EVAL_PAIRS = 2          # cut from 4 for the 5-minute cap


def eval_phase(launches):
    """The evaluation entry points as a user runs them, on the production
    profile with ``fused_groupnorm``: ``EVAL_PAIRS`` synthetic 720x480 pairs
    written
    as PNG by the port's codec into a RainDrop-shaped tree (read back bit
    for bit), ``cli/eval_diffusion.main`` over them in batches of two with
    image dumps, and ``cli/restore.main`` over the inputs.  Each CLI run is
    counted; its dumps must read back at 720x480.  The weights are random,
    so the metrics are not a quality number."""
    import contextlib
    import io

    import numpy as np
    import torch

    from wavedm_tpu_torch.cli import eval_diffusion
    from wavedm_tpu_torch.cli import restore as restore_cli
    from wavedm_tpu_torch.config import production_profile
    from wavedm_tpu_torch.data.synthetic import SyntheticPairs
    from wavedm_tpu_torch.utils.images import read_png, to_uint8, write_png

    root = os.path.join(ROOT, "wavedm_tpu_torch", "_build", "smoke_eval")
    shutil.rmtree(root, ignore_errors=True)
    split = os.path.join(root, "data", "raindrop", "raindrop_test")
    try:
        src = SyntheticPairs(height=HEIGHT, width=WIDTH, n_images=EVAL_PAIRS,
                             seed=SEED)
        t = time.perf_counter()
        written = {}
        for i in range(EVAL_PAIRS):
            for folder, name, img in (("input", f"{i}_rain.png", src[i][0]),
                                      ("gt", f"{i}_clean.png", src[i][1])):
                path = os.path.join(split, folder, name)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                written[path] = to_uint8(img)
                write_png(path, written[path])
        write_ms = (time.perf_counter() - t) * 1e3 / len(written)
        t = time.perf_counter()
        for path, img in written.items():
            assert np.array_equal(read_png(path), img), path
        read_ms = (time.perf_counter() - t) * 1e3 / len(written)

        common = ["--config", "production", "--device", "cuda",
                  "--set", "parallel.fused_groupnorm=true"]
        prod = production_profile().sampling
        steps = len(range(0, prod.t_start, max(1, prod.t_start
                                               // prod.sampling_timesteps)))
        batches = EVAL_PAIRS // 2          # each CLI restores 2 at a time
        want = {"group_norm_bf16_swish": 45 * steps * batches,
                "group_norm_bf16": 6 * steps * batches,
                "wavelet_dec": 2 * batches, "wavelet_rec": batches}
        dump = os.path.join(root, "dump")
        runs = {}
        for name, main, argv in (
                ("eval_diffusion", eval_diffusion.main, common + [
                    "--set", f"data.data_dir={os.path.join(root, 'data')}",
                    "--eval-batch", "2", "--image-folder", dump]),
                ("restore", restore_cli.main, common + [
                    "--input", os.path.join(split, "input"),
                    "--out", os.path.join(root, "restored"),
                    "--batch", "2"])):
            buf = io.StringIO()
            torch.cuda.synchronize()
            reset_counts()
            t = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                assert main(argv) == 0, name
            torch.cuda.synchronize()
            runs[name] = dict(
                ms_per_image=(time.perf_counter() - t) * 1e3 / EVAL_PAIRS,
                stdout=buf.getvalue().splitlines()[-6:])
            counts = read_counts()
            got = {k: v for k, v in counts.items() if v}
            assert got == want, (name, got, want)
            for key, val in got.items():
                launches[key] += val

        metrics = {}
        for line in runs["eval_diffusion"]["stdout"]:
            for label in ("psnr all torch", "psnr all np", "psnr all GPU",
                          "ssim all"):
                if line.startswith(label + " "):
                    metrics[label] = float(line[len(label) + 1:])
        assert len(metrics) == 4 and all(np.isfinite(v)
                                         for v in metrics.values()), metrics
        assert f"({EVAL_PAIRS} images)" in runs["eval_diffusion"]["stdout"]
        dumps = [os.path.join(dump, f"{i}_rain_{kind}.png")
                 for i in range(EVAL_PAIRS)
                 for kind in ("output", "cond", "gt")]
        dumps += [os.path.join(root, "restored", f"{i}_rain_restored.png")
                  for i in range(EVAL_PAIRS)]
        for path in dumps:
            assert read_png(path).shape == (HEIGHT, WIDTH, 3), path
        for i in range(EVAL_PAIRS):
            gt = read_png(os.path.join(dump, f"{i}_rain_gt.png"))
            assert np.array_equal(gt, written[os.path.join(
                split, "gt", f"{i}_clean.png")])
        emit("eval", profile="production", pairs=EVAL_PAIRS,
             metrics=metrics,
             note="random weights: the metrics are not a quality number",
             eval_ms_per_image=runs["eval_diffusion"]["ms_per_image"],
             restore_ms_per_image=runs["restore"]["ms_per_image"],
             per_image_includes="model build, PNG decode and encode, "
             "restoration, metrics (eval)", launches=want,
             png_write_ms=write_ms, png_read_ms=read_ms,
             dumps_checked=len(dumps),
             restore_stdout=runs["restore"]["stdout"][-1])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()


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
    Returns (the launch counts of the counted run, its steady ms/step)."""
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
    return counts, steady_ms


def train_phase(launches):
    """Stage-2 training at flagship width through the fused kernel, both
    profiles (:func:`train_profile`); returns their steady ms/step."""
    import torch

    from wavedm_tpu_torch.config import production_profile, reference_profile
    from wavedm_tpu_torch.inference.loader import build_hfrm

    ref_train = reference_profile()
    prod_train = production_profile()
    for cfg in (ref_train, prod_train):
        cfg.parallel.fused_resblock = True
        cfg.validate()
    hfrm_train = build_hfrm(prod_train, None, "cuda").state_dict()
    step_ms = {}
    for name, cfg, hfrm in (("reference", ref_train, None),
                            ("production", prod_train, hfrm_train)):
        n_crops = cfg.training.batch_size * cfg.training.patch_n
        counts, step_ms[name] = train_profile(name, cfg, n_crops, hfrm)
        for key, val in counts.items():
            if val:
                launches[key] += val
    del hfrm_train
    torch.cuda.empty_cache()
    return step_ms


def smoke_data_dir():
    """A ``data.data_dir`` whose RainDrop ``train`` and ``raindrop_test``
    splits both link to the repository's 8 test pairs, so that no phase
    reads the 289 MB train split, which a copy of the repository made for
    a GPU machine may leave out."""
    root = os.path.join(ROOT, "wavedm_tpu_torch", "_build", "smoke_data")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "raindrop"))
    test = os.path.join(ROOT, "data", "raindrop", "raindrop_test")
    for split in ("train", "raindrop_test"):
        os.symlink(test, os.path.join(root, "raindrop", split))
    return root


def timed_steps(step_fn, marks, step_ms, outs=None):
    """``step_fn`` with the card synchronized after each call: its time
    into ``step_ms``, the host clock at its end into ``marks``, its result
    into ``outs``."""
    import torch

    def step(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step_fn(*args, **kwargs)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        step_ms.append((marks[-1] - t) * 1e3)
        if outs is not None:
            outs.append(out)
        return out
    return step


def timed_batches(it, waits):
    """The items of ``it``, with the host time spent waiting for each
    appended to ``waits``."""
    it = iter(it)
    while True:
        t = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        waits.append(time.perf_counter() - t)
        yield item


DATA_STEPS = 4          # cut from 6 for the 5-minute cap


def train_data_phase(launches):
    """Stage 2 on real RainDrop pairs in the production profile (bfloat16
    compute, float32 parameters, ``fused_resblock``, a frozen random
    HFRM, 2 x 8 crops of 256x256): DATA_STEPS steps streamed from the PNG
    files in the PIL order (``use_native=False``), then as many from a
    fresh trainer through the device cache, the first batch of each path
    equal to the byte; then as many on the native crop stream, whose first
    batch must equal ``make_crop_batch`` called directly and be what
    ``train_batches`` gives by default.
    ``training.validation_freq`` is 3 and the streamed run validates once,
    at step 3 (two test pairs restored with the training UNet).  Times the
    steps after the first: wall per step (validation taken out), the
    card's step alone, and the host's wait for a batch."""
    import contextlib
    import io

    import numpy as np
    import torch

    from wavedm_tpu_torch.cli.train_diffusion import make_validate
    from wavedm_tpu_torch.config import production_profile
    from wavedm_tpu_torch.data import native_loader
    from wavedm_tpu_torch.data.raindrop import RainDrop, RainDropDataset
    from wavedm_tpu_torch.inference.loader import build_hfrm
    from wavedm_tpu_torch.training.trainer import DiffusionTrainer

    build = os.path.join(ROOT, "wavedm_tpu_torch", "_build")
    val_dir = os.path.join(build, "smoke_val")
    cfg = production_profile()
    cfg.parallel.fused_resblock = True
    cfg.data.data_dir = smoke_data_dir()
    cfg.training.validation_freq = 3
    cfg.validate()
    hfrm_sd = build_hfrm(cfg, None, "cuda").state_dict()
    n_crops = cfg.training.batch_size * cfg.training.patch_n
    chain = len(range(0, cfg.sampling.t_start, max(
        1, cfg.sampling.t_start // cfg.sampling.sampling_timesteps)))
    m = cfg.model      # two fused sites a ResnetBlock: 44 at full width
    sites = 2 * (len(m.ch_mult) * (2 * m.num_res_blocks + 1) + 2)
    assert native_loader.available(), native_loader.unavailable_reason()
    paths = ["streamed", "device_cache", "native"]
    side_by_side = {}
    firsts = {}
    try:
        for path in paths:
            cfg.data.device_cache = path == "device_cache"
            use_native = path == "native"
            steps = DATA_STEPS
            dataset = RainDrop(cfg, device="cuda")
            t = time.perf_counter()
            first = next(dataset.train_batches(0, prefetch=False,
                                               use_native=use_native))
            torch.cuda.synchronize()
            first_batch_s = time.perf_counter() - t   # the cache's build
            firsts[path] = (first.cpu().numpy() if torch.is_tensor(first)
                            else first)
            p = cfg.data.patch_size
            assert firsts[path].shape == (n_crops, p, p, 6)
            trainer = DiffusionTrainer(cfg, hfrm_state_dict=hfrm_sd,
                                       device="cuda", log_fn=lambda m: None)
            marks, step_ms, waits, val_s, val_out = [], [], [], [], []
            metrics = []
            trainer.train_step = timed_steps(trainer.train_step, marks,
                                             step_ms, metrics)
            validate = make_validate(trainer, dataset, None, val_dir)

            def once(state, step, validate=validate):
                if step != 3:
                    return
                t = time.perf_counter()
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    validate(state, step)
                torch.cuda.synchronize()
                val_s.append(time.perf_counter() - t)
                val_out.append(buf.getvalue().strip())

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            trainer.fit(lambda epoch: timed_batches(
                dataset.train_batches(epoch, use_native=use_native), waits),
                max_steps=steps,
                validate_fn=once if path == "streamed" else None)
            torch.cuda.synchronize()
            counts = read_counts()
            peak = torch.cuda.max_memory_allocated()
            assert trainer.state.step == steps
            restores = 2 if path == "streamed" else 0    # eval_batch 1
            want = {"fused_gn_swish_conv_bf16":
                    sites * (steps + chain * restores),
                    "wavelet_dec": 3 * steps + 2 * restores}
            if restores:
                want["wavelet_rec"] = restores
            got = {k: v for k, v in counts.items() if v}
            assert got == want, (path, got, want)
            for key, val in got.items():
                launches[key] += val
            loss = float(metrics[-1].loss)
            assert np.isfinite(loss), loss
            wall_ms = ((marks[steps - 1] - marks[0]) - sum(val_s)) \
                * 1e3 / (steps - 1)
            fields = {}
            if val_out:
                psnr, ssim = re.search(r"psnr (\S+) ssim (\S+)",
                                       val_out[0]).groups()
                assert np.isfinite(float(psnr)) and np.isfinite(float(ssim))
                dumps = os.listdir(os.path.join(val_dir, "step3"))
                assert len(dumps) == 6, dumps
                fields = dict(validation=val_out[0], validation_s=val_s[0],
                              validation_dumps=len(dumps))
            data_ms = sum(waits[1:steps]) * 1e3 / (steps - 1)
            side_by_side[path] = {"data_ms": data_ms, "ms_per_step": wall_ms,
                                  "step_ms": sum(step_ms[1:]) / (steps - 1)}
            emit("train_data", path=path, profile="production",
                 dtype="bfloat16", fused_resblock=True, crops=n_crops,
                 steps=steps,
                 first_batch_s_cache_build_included=first_batch_s,
                 first_step_ms=step_ms[0],
                 ms_per_step=wall_ms,
                 step_ms=sum(step_ms[1:]) / (steps - 1),
                 data_ms=data_ms,
                 peak_bytes=peak, loss=loss, launches=got,
                 group_norm_launches=sum(v for k, v in got.items()
                                         if k.startswith("group_norm")),
                 **fields)
            del trainer, dataset
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(val_dir, ignore_errors=True)
    assert np.array_equal(firsts["streamed"], firsts["device_cache"])
    # which stream train_batches takes by default, and the native one's
    # first batch against the library called directly on the same pairs
    cfg.data.device_cache = False
    default = next(RainDrop(cfg).train_batches(0, prefetch=False))
    ds = RainDropDataset(RainDrop(cfg).train_dir(), cfg.data.patch_size,
                         cfg.training.patch_n)
    order = np.array(ds.indices)
    np.random.default_rng(cfg.training.seed).shuffle(order)
    bs = cfg.training.batch_size
    direct = native_loader.make_crop_batch(
        [ds.inputs[i] for i in order[:bs]],
        [ds.gts[i] for i in order[:bs]], cfg.training.patch_n,
        cfg.data.patch_size, cfg.training.seed * 100003 * 1000003,
        cfg.data.num_workers)
    assert np.array_equal(firsts["native"], direct)
    assert np.array_equal(default, direct)
    native = {"available": True, "first_batch_equals_make_crop_batch": True,
              "default_stream": "native"}
    emit("train_data", first_batches_equal=True,
         batch_shape=list(firsts["streamed"].shape), native_stream=native,
         side_by_side=side_by_side)


HFRM_STEPS = 3         # cut from 6 (PR 15: 4) for the 5-minute cap


def hfrm_step_on(device, weights=None):
    """One HFRMTrainer step of a small HFRM (float32) from random weights
    with nonzero residual scales; returns the loss, the PSNR, the
    gradients and the weights it started from."""
    import numpy as np
    import torch

    from wavedm_tpu_torch.config import config_from_dict
    from wavedm_tpu_torch.inference.loader import init_random_
    from wavedm_tpu_torch.training.hfrm_trainer import HFRMTrainer

    cfg = config_from_dict({"hfrm": {"dim": 16, "enc_blk_nums": [1, 1],
                                     "middle_blk_num": 1,
                                     "dec_blk_nums": [1, 1]}})
    trainer = HFRMTrainer(cfg, device=device, log_fn=lambda s: None)
    if weights is None:
        init_random_(trainer.model,
                     torch.Generator(device=device).manual_seed(SEED))
        with torch.no_grad():
            for name, p in trainer.model.named_parameters():
                if name.endswith(("beta", "gamma")):
                    p.fill_(0.5)
        weights = {k: v.cpu().clone()
                   for k, v in trainer.model.state_dict().items()}
    trainer.model.load_state_dict(weights)
    batch = np.random.default_rng(SEED).random((2, 64, 96, 6),
                                               dtype=np.float32)
    loss, psnr = trainer.train_step(batch)
    grads = {k: p.grad.cpu() for k, p in trainer.model.named_parameters()}
    return float(loss), float(psnr), grads, weights


def train_hfrm_phase():
    """Stage-1 training: first one step of a small HFRM on the card against
    the CPU (float32: loss, PSNR and every gradient), then HFRMTrainer.fit
    at full width (15,941,667 parameters, identity-centre start) on the 8
    RainDrop test pairs, whole 720x480 images in one batch of 8, for
    ``HFRM_STEPS`` steps in float32 (TF32 off), in bfloat16 over float32
    parameters, and in bfloat16 with ``hfrm.remat``: ms/step over the
    steps after the first, peak memory,
    a finite loss, every parameter outside the residual blocks moved (the
    blocks' get zero gradient from the identity-centre start), ``lastest``
    written."""
    import numpy as np
    import torch

    from wavedm_tpu_torch.config import production_profile, reference_profile
    from wavedm_tpu_torch.data.raindrop import RainDrop
    from wavedm_tpu_torch.training.hfrm_trainer import HFRMTrainer

    l_cpu, p_cpu, g_cpu, weights = hfrm_step_on("cpu")
    l_gpu, p_gpu, g_gpu, _ = hfrm_step_on("cuda", weights)
    loss_err = abs(l_gpu - l_cpu) / abs(l_cpu)
    psnr_err = abs(p_gpu - p_cpu) / abs(p_cpu)
    grad_err = max(float((g_gpu[k] - g).abs().max() / g.abs().max())
                   for k, g in g_cpu.items())
    assert max(loss_err, psnr_err) <= 1e-5 and grad_err <= 1e-4, (
        loss_err, psnr_err, grad_err)
    emit("train_hfrm", check="small step, card vs CPU (float32)",
         loss_rel_err=loss_err, psnr_rel_err=psnr_err,
         grad_rel_err=grad_err, tol_rel=dict(loss=1e-5, psnr=1e-5,
                                             grad=1e-4))

    cfg = reference_profile()
    cfg.data.data_dir = smoke_data_dir()
    pairs = np.stack([p for p, _ in RainDrop(cfg).eval_samples()])
    assert pairs.shape[0] == 8, pairs.shape
    batch = torch.from_numpy(pairs).cuda()
    ckpt_root = os.path.join(ROOT, "wavedm_tpu_torch", "_build", "smoke_hfrm")
    variants = (("float32", reference_profile(), False),
                ("bfloat16", production_profile(), False),
                ("bfloat16_remat", production_profile(), True))
    try:
        for name, vcfg, remat in variants:
            vcfg.hfrm.remat = remat
            trainer = HFRMTrainer(vcfg, device="cuda", log_fn=lambda m: None)
            n_params = sum(p.numel() for p in trainer.model.parameters())
            assert n_params == HFRM_PARAMS, n_params
            p0 = {k: p.detach().clone()
                  for k, p in trainer.model.named_parameters()}
            marks, step_ms = [], []
            trainer.train_step = timed_steps(trainer.train_step, marks,
                                             step_ms)
            ckpt_dir = os.path.join(ckpt_root, name)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            history = trainer.fit(lambda epoch: iter([batch] * HFRM_STEPS),
                                  max_steps=HFRM_STEPS, ckpt_dir=ckpt_dir)
            peak = torch.cuda.max_memory_allocated()
            assert [h[0] for h in history] == list(range(1, HFRM_STEPS + 1))
            loss, psnr = history[-1][1], history[-1][2]
            assert np.isfinite(loss) and np.isfinite(psnr), (loss, psnr)
            # from the identity-centre start each block's SimpleGate
            # multiplies by channels the init leaves at zero: the blocks'
            # parameters get exactly zero gradient (in the JAX package
            # too) and only the 16 tensors outside them train
            moved, dead = [], []
            for k, p in trainer.model.named_parameters():
                if k.startswith(("encoders", "mid_blks", "decoders")):
                    assert torch.equal(p.detach(), p0[k]), k
                    assert not p.grad.any(), k
                    dead.append(p.numel())
                else:
                    assert not torch.equal(p.detach(), p0[k]), \
                        f"{name}: {k} did not move"
                    moved.append(p.numel())
            lastest = os.path.join(ckpt_dir, "lastest.pth.tar")
            assert os.path.exists(lastest), lastest
            emit("train_hfrm", variant=name, params=n_params,
                 batch=list(batch.shape), steps=HFRM_STEPS,
                 compute_dtype=vcfg.parallel.compute_dtype, remat=remat,
                 first_step_ms=step_ms[0],
                 ms_per_step=(marks[-1] - marks[0]) * 1e3 / (HFRM_STEPS - 1),
                 peak_bytes=peak, loss=loss, psnr=psnr,
                 losses=[h[1] for h in history],
                 tensors_moved=len(moved), params_moved=sum(moved),
                 block_tensors_zero_grad=len(dead),
                 block_params_zero_grad=sum(dead),
                 lastest_bytes=os.path.getsize(lastest))
            del trainer, p0
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    del batch
    torch.cuda.empty_cache()


def pipeline_phase(launches, keep=False):
    """Both stages and the scoring as a user chains them, in process, on
    the RainDrop test pairs standing in for the train split: 2 steps of
    ``cli.train_hfrm`` (full width, bfloat16 over float32 parameters);
    its ``lastest`` file as ``--hfrm-ckpt`` to 2 steps of
    ``cli.train_diffusion`` (production profile, ``fused_resblock``); that
    checkpoint to ``cli.eval_diffusion --resume`` over 2 pairs
    (``fused_groupnorm``).  Each exits 0; each training run's and the
    eval's launches are counted and checked; the metrics are finite; the
    restorer's HFRM holds the stage-1 file's weights.  With ``keep`` the
    checkpoints stay (the tools phase reads them); returns their paths
    (UNet, HFRM) and their directory."""
    import contextlib
    import io

    import numpy as np
    import torch

    from wavedm_tpu_torch.cli import eval_diffusion, train_diffusion, \
        train_hfrm
    from wavedm_tpu_torch.config import production_profile
    from wavedm_tpu_torch.inference import loader

    data = ["--set", f"data.data_dir={smoke_data_dir()}"]
    root = os.path.join(ROOT, "wavedm_tpu_torch", "_build", "smoke_pipeline")
    shutil.rmtree(root, ignore_errors=True)
    hfrm_ckpt = os.path.join(root, "hfrm", "lastest.pth.tar")
    unet_ckpt = os.path.join(root, "ddpm", "RainDrop_epoch1_ddpm.pth.tar")
    built = []
    real_build = loader.build_restorer

    def keep(*args, **kwargs):
        built.append(real_build(*args, **kwargs))
        return built[-1]

    common = ["--config", "production", "--device", "cuda"] + data
    prod = production_profile()
    prod_steps = len(range(0, prod.sampling.t_start, max(
        1, prod.sampling.t_start // prod.sampling.sampling_timesteps)))
    m = prod.model
    sites = 2 * (len(m.ch_mult) * (2 * m.num_res_blocks + 1) + 2)
    norms = gn_sites(prod, 1)       # 45 with swish and 6 without
    swish = sum(v for k, v in norms.items() if k[3])
    runs = (
        ("train_hfrm", train_hfrm.main, common + [
            "--max-steps", "2", "--ckpt-dir", os.path.dirname(hfrm_ckpt)],
         {}),
        ("train_diffusion", train_diffusion.main, common + [
            "--set", "parallel.fused_resblock=true",
            "--set", "training.snapshot_freq=2", "--max-steps", "2",
            "--hfrm-ckpt", hfrm_ckpt,
            "--ckpt-dir", os.path.dirname(unet_ckpt)],
         {"fused_gn_swish_conv_bf16": sites * 2, "wavelet_dec": 3 * 2}),
        ("eval_diffusion", eval_diffusion.main, common + [
            "--set", "parallel.fused_groupnorm=true", "--resume", unet_ckpt,
            "--hfrm-ckpt", hfrm_ckpt, "--n-images", "2",
            "--eval-batch", "2"],
         {"group_norm_bf16_swish": swish * prod_steps,
          "group_norm_bf16": (sum(norms.values()) - swish) * prod_steps,
          "wavelet_dec": 2,
          "wavelet_rec": 1}))
    out = {}
    loader.build_restorer = keep
    try:
        for name, main, argv, want in runs:
            buf = io.StringIO()
            torch.cuda.synchronize()
            reset_counts()
            t = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                assert main(argv) == 0, name
            torch.cuda.synchronize()
            got = {k: v for k, v in read_counts().items() if v}
            assert got == want, (name, got, want)
            for key, val in got.items():
                launches[key] += val
            out[name] = dict(s=time.perf_counter() - t,
                             stdout=buf.getvalue().splitlines()[-5:])
            torch.cuda.empty_cache()
        metrics = {}
        for line in out["eval_diffusion"]["stdout"]:
            for label in ("psnr all torch", "psnr all np", "psnr all GPU",
                          "ssim all"):
                if line.startswith(label + " "):
                    metrics[label] = float(line[len(label) + 1:])
        assert len(metrics) == 4 and all(np.isfinite(v)
                                         for v in metrics.values()), metrics
        assert "(2 images)" in out["eval_diffusion"]["stdout"][-1]
        (rest,) = built
        saved = torch.load(hfrm_ckpt, map_location="cpu",
                           weights_only=True)["state_dict"]
        served = rest.hfrm.state_dict()
        assert served.keys() == saved.keys()
        for k, v in saved.items():
            assert torch.equal(served[k].cpu(), v.to(served[k].dtype)), k
        emit("pipeline", stages=list(out), seconds={k: v["s"]
                                                      for k, v in out.items()},
             metrics=metrics, hfrm_weights_served_equal_stage1_file=True,
             note="random start, 2 steps each: the metrics are not a "
             "quality number",
             stdout={k: v["stdout"][-1] for k, v in out.items()})
    finally:
        loader.build_restorer = real_build
        if not keep:
            shutil.rmtree(root, ignore_errors=True)
    del built
    torch.cuda.empty_cache()
    return unet_ckpt, hfrm_ckpt, root


SEED_STUDY_SEEDS = 2    # the seed study's batch-1 seeds (cut from 8, 4)
VPRED_AB_STEPS = 5      # the toy A/B's steps (cut from 20)


def tools_phase(launches, unet_ckpt, hfrm_ckpt, step_ms=None):
    """Every quality-loop tool (``wavedm_tpu_torch/tools/``) in process at
    full width and a small depth, on the pipeline phase's checkpoints
    (the production UNet and HFRM) and the RainDrop test pairs: the
    synthetic dataset at 2 + 2 pairs; ``diag_quality`` on one test image
    (2 steps); ``diag_teacher_forced`` on 4 crops; ``seed_study`` at
    ``SEED_STUDY_SEEDS`` seeds and one batch of 8, both chains at 2 steps;
    the toy A/B for ``VPRED_AB_STEPS``
    steps; ``eval_sweep`` over its ``full_chain_ema`` row (the EMA
    weights, 2 steps, 1 image, float32 under
    ``rehearsal_flagship``, whose UNet and HFRM are the production ones),
    read back by ``summarize_sweep``; the dress rehearsal at 2 + 2 steps
    and the rehearsal A/B's three arms at 1 step, evaluated on 1 image
    under both protocols (both at the rehearsal
    widths, through ``fused_resblock``).  Each exits 0 and prints finite
    numbers; the restores' GroupNorm and wavelet launches are counted and
    checked (exactly where a tool only restores, at least one of each
    kernel where it also trains)."""
    import contextlib
    import io
    import re

    import numpy as np
    import torch

    from wavedm_tpu_torch.config import production_profile
    from wavedm_tpu_torch.tools import (
        diag_quality, diag_teacher_forced, dress_rehearsal, eval_sweep,
        make_synthetic_dataset, seed_study, summarize_sweep, vpred_cpu_ab,
        vpred_rehearsal_ab)

    work = os.path.join(ROOT, "wavedm_tpu_torch", "_build", "smoke_tools")
    shutil.rmtree(work, ignore_errors=True)
    norms = gn_sites(production_profile(), 1)     # 45 with swish, 6 without
    swish = sum(v for k, v in norms.items() if k[3])

    def gn(tag, calls):
        return {f"group_norm_{tag}_swish": swish * calls,
                f"group_norm_{tag}": (sum(norms.values()) - swish) * calls}

    gpu = ["--device", DEV]
    fused_gn = ["--set", "parallel.fused_groupnorm=true"]
    two_steps = ["--set", "sampling.sampling_timesteps=2",
                 "--set", "sampling.x0_pred_index=-1"]
    data = ["--set", "data.data_dir=" + os.path.join(
        ROOT, "wavedm_tpu_torch", "_build", "smoke_data")]
    ckpts = ["--resume", unet_ckpt, "--hfrm-ckpt", hfrm_ckpt]
    rehearsal = os.path.join(work, "rehearsal")
    rehearsal_kernels = ["--set", "parallel.fused_resblock=true"] + two_steps
    trains = {"fused_gn_swish_conv_f32", "wavelet_dec", "wavelet_rec"}
    runs = (
        ("make_synthetic_dataset", make_synthetic_dataset.main, [
            "--data-dir", os.path.join(work, "data"), "--n-train", "2",
            "--n-test", "2"], {}),
        ("diag_quality", diag_quality.main, [
            "--config", "production"] + ckpts + [
            "--split", "test", "--n", "1", "--sampling-timesteps", "2"]
            + fused_gn + data + gpu,
         {**gn("bf16", 2), "wavelet_dec": 3, "wavelet_rec": 4}),
        ("diag_teacher_forced", diag_teacher_forced.main, [
            "--config", "production"] + ckpts + ["--n-crops", "4"]
            + fused_gn + data + gpu,
         {**gn("bf16", len(diag_teacher_forced.T_LADDER)), "wavelet_dec": 3}),
        ("seed_study", seed_study.main, [
            "--seeds", str(SEED_STUDY_SEEDS), "--ckpt-dir",
            os.path.dirname(unet_ckpt), "--hfrm-ckpt", hfrm_ckpt,
            "--tstart-steps", "2", "--out",
            os.path.join(work, "seed_study.json")] + two_steps + fused_gn
            + gpu,
         # two chains, each SEED_STUDY_SEEDS batch-1 restores and one
         # batch of 8
         {**gn("bf16", 2 * 2 * (SEED_STUDY_SEEDS + 1)),
          "wavelet_dec": 2 * 2 * (SEED_STUDY_SEEDS + 1),
          "wavelet_rec": 2 * (SEED_STUDY_SEEDS + 1)}),
        ("vpred_cpu_ab", vpred_cpu_ab.main, [
            "--steps", str(VPRED_AB_STEPS), "--out",
            os.path.join(work, "vpred_ab.json")]
            + gpu, {}),
        ("eval_sweep", eval_sweep.main, [
            "--ckpt", unet_ckpt,
            "--hfrm-ckpt", hfrm_ckpt, "--out", os.path.join(work, "sweep"),
            "--rows", "full_chain_ema", "--diag-n", "0",
            "--eval-batch", "2"] + gpu + ["--"] + fused_gn + data
            + two_steps + ["--n-images", "1"],
         {**gn("f32", 2), "wavelet_dec": 2, "wavelet_rec": 1}),
        ("summarize_sweep", summarize_sweep.main, [
            "--dir", os.path.join(work, "sweep"), "--out",
            os.path.join(work, "sweep_summary.json")], {}),
        ("dress_rehearsal", dress_rehearsal.main, [
            "--steps1", "2", "--steps2", "2", "--n-train", "2", "--n-test",
            "2", "--work", rehearsal] + gpu + ["--"] + rehearsal_kernels,
         trains),
        ("vpred_rehearsal_ab", vpred_rehearsal_ab.main, [
            "--steps", "1", "--hfrm-ckpt",
            os.path.join(rehearsal, "hfrm", "lastest.pth.tar"),
            "--data-dir", os.path.join(rehearsal, "data"), "--out",
            os.path.join(work, "ab"), "--n-images", "1"] + gpu + ["--"]
            + rehearsal_kernels, trains),
    )
    seconds, printed = {}, {}
    try:
        for name, main, argv, want in runs:
            buf = io.StringIO()
            torch.cuda.synchronize()
            reset_counts()
            t = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                assert main(argv) == 0, name
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t
            got = {k: v for k, v in read_counts().items() if v}
            if isinstance(want, set):       # trains as well: each kernel ran
                assert set(got) == want, (name, got, want)
            else:
                assert got == want, (name, got, want)
            for key, val in got.items():
                launches[key] += val
            text = buf.getvalue()
            numbers = [float(x) for x in re.findall(
                r"-?\b\d+\.\d+(?:e-?\d+)?|\bnan\b|\binf\b", text,
                re.IGNORECASE)]
            if name != "make_synthetic_dataset":
                assert numbers and all(np.isfinite(numbers)), (name, text)
            printed[name] = dict(launches=got, lines=text.splitlines()[-3:],
                                 numbers=len(numbers))
            torch.cuda.empty_cache()
        summary = json.load(open(os.path.join(work, "sweep_summary.json")))
        assert sorted(summary) == ["full_chain_ema"], summary
        assert all(r["n_images"] == 1 for r in summary.values()), summary
        seeds = json.load(open(os.path.join(work, "seed_study.json")))
        assert (seeds["full_25step"]["b1"]["n"],
                seeds["tstart300_10step"]["b8"]["n"]) == (SEED_STUDY_SEEDS,
                                                          8), seeds
        for arm in ("eps", "v", "eps_snr5"):
            assert os.path.exists(os.path.join(work, "ab", f".done_{arm}"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit("tools", seconds=seconds, total_s=sum(seconds.values()),
         sweep_summary=summary, seed_study={
             k: seeds[k] for k in ("full_25step", "tstart300_10step")},
         note="pipeline checkpoints (2 steps from a random start) and "
         "2-step chains: the metrics are not a quality number",
         runs=printed)
    measuring_tools(launches, step_ms)


ROOFLINE_ITERS = 3


def roofline_rows(launches):
    """``tools/roofline.measure`` on the production forward (bfloat16, two
    images' 90 patches, ``ROOFLINE_ITERS`` timed calls) through each
    route: ``flops`` and ``xla_flops`` the same under every route, and
    ``flops`` 90 times one patch's (counted on the meta device); each
    route's kernel launches exact, and its declared launches those of the
    counted call.  Returns {route: measure's dict}."""
    import torch

    from wavedm_tpu_torch.config import reference_profile
    from wavedm_tpu_torch.tools import roofline
    from wavedm_tpu_torch.utils.work import count_work

    cfg = reference_profile()
    unet, x = unet_body(cfg, 1)
    one = count_work(unet, x, torch.empty(1, device="meta"))
    del unet, x
    norms = gn_sites(cfg, 1)
    swish = sum(v for k, v in norms.items() if k[3])
    per_call = {"plain": {},
                "fused_groupnorm": {
                    "group_norm_bf16_swish": swish,
                    "group_norm_bf16": sum(norms.values()) - swish},
                "fused_resblock": {"fused_gn_swish_conv_bf16": sum(
                    fused_sites(cfg, 1).values())}}
    calls = ROOFLINE_ITERS + 2                # a warm, the counted, timed
    out = {}
    for route in roofline.ROUTES:
        reset_counts()
        r = roofline.measure(N_IMAGES, "bfloat16", ROOFLINE_ITERS, route,
                             DEV)
        got = {k: v for k, v in read_counts().items() if v}
        assert got == {k: v * calls for k, v in per_call[route].items()}, (
            route, got)
        assert r["kernels"] == {"kernel:" + k: v for k, v in
                                per_call[route].items()}, (route, r)
        for key, val in got.items():
            launches[key] += val
        out[route] = r
        torch.cuda.empty_cache()
    first = out["plain"]
    for r in out.values():
        assert (r["flops"], r["xla_flops"]) == (first["flops"],
                                                first["xla_flops"]), out
    assert first["flops"] == N_IMAGES * 45 * one.flops, (first, one.flops)
    return out, one


def train_mfu_rows(launches, step_ms):
    """``tools/train_mfu`` in process for the ``train`` phase's two
    profiles, each at that phase's measured ms/step and through the route
    it timed (``fused_resblock``) and the plain one (the GroupNorm kernel
    takes no gradient, so ``fused_groupnorm`` cannot train): the
    production step (bfloat16, 16 crops, the frozen HFRM's conditioning,
    ``rehearsal_flagship``'s own) and the reference one (float32, 8 crops,
    ground-truth conditioning).  Flops identical under both routes;
    launches exact.  Returns {profile: {route: the tool's JSON}}."""
    import contextlib
    import io

    import torch

    from wavedm_tpu_torch.config import reference_profile
    from wavedm_tpu_torch.tools import train_mfu

    pairs = sum(fused_sites(reference_profile(), 1).values())     # 44
    steps = {"production": ["--dtype", "bfloat16"],
             "reference": ["--dtype", "float32", "--batch-size", "1",
                           "--set", "model.use_gt_in_train=true"]}
    out = {}
    for name, argv in steps.items():
        dwt = 2 if name == "reference" else 3
        tag = "bf16" if name == "production" else "f32"
        out[name] = {}
        for route in ("plain", "fused_resblock"):
            fused = route == "fused_resblock"
            buf = io.StringIO()
            reset_counts()
            with contextlib.redirect_stdout(buf):
                rc = train_mfu.main(argv + [
                    "--step-time", str(step_ms[name] / 1e3), "--device",
                    DEV, "--set",
                    f"parallel.fused_resblock={str(fused).lower()}"])
            assert rc == 0, (name, route)
            got = {k: v for k, v in read_counts().items() if v}
            want = {"wavelet_dec": dwt}
            if fused:
                want[f"fused_gn_swish_conv_{tag}"] = pairs
            assert got == want, (name, route, got, want)
            for key, val in got.items():
                launches[key] += val
            out[name][route] = json.loads(buf.getvalue().splitlines()[-1])
            torch.cuda.empty_cache()
        a, b = out[name]["plain"], out[name]["fused_resblock"]
        assert (a["train_flops_per_step"], a["train_xla_flops_per_step"]) \
            == (b["train_flops_per_step"], b["train_xla_flops_per_step"]), (
                name, a, b)
        assert b["train_mfu"] is not None and 0 < b["train_mfu"] < 1, b
    return out


def measuring_tools(launches, step_ms):
    """The measuring tools on the card: the roofline of the production
    forward under each route, and the training MFU of the ``train``
    phase's steps (when that phase ran: ``step_ms``); the card's name and
    power limit beside their figures.  ``trace_summary`` runs in the
    profiling child (:func:`profiling_phase`)."""
    t = time.perf_counter()
    roof, one = roofline_rows(launches)
    for route, r in roof.items():
        emit("tools", tool="roofline", **{k: v for k, v in r.items()
                                          if k != "kernels"})
    emit("tools", tool="roofline", part="one patch, meta device",
         flops_per_patch=one.flops, xla_flops_per_patch=one.xla_flops,
         seconds=time.perf_counter() - t)
    if step_ms is None:
        emit("tools", tool="train_mfu", skipped="no train phase in this run")
        return
    t = time.perf_counter()
    for name, routes in train_mfu_rows(launches, step_ms).items():
        for route, r in routes.items():
            emit("tools", tool="train_mfu", profile=name, route=route,
                 step_ms=step_ms[name], **r)
    emit("tools", tool="train_mfu", seconds=time.perf_counter() - t)


VARIANT_STEPS = 1       # reverse steps of each variant restore (cut from 25;
                        # PR 15: 2)
PIXEL_MB = 128          # patch_micro_batch of the 720x480 pixel restore
SMALL = 256             # side of the pixel path's float32 image
# UNet parameters at full width (the pixel, global and lap profiles)
VARIANT_PARAMS = {"pixel": 109_736_835, "global": 187_478_275,
                  "lap": 68_796_547}


def variant_cfg(name, **changes):
    """A variant profile (``pixel``, ``global``, ``lap``: the shipped
    ``raindrop*.yaml`` configs) with its chain cut to ``VARIANT_STEPS``
    steps (keeping the last x0 estimate) and ``section__key`` changes."""
    from wavedm_tpu_torch.config import PROFILES

    cfg = PROFILES[name]()
    cfg.sampling.sampling_timesteps = VARIANT_STEPS
    cfg.sampling.x0_pred_index = -1
    for key, val in changes.items():
        section, field = key.split("__")
        setattr(getattr(cfg, section), field, val)
    return cfg.validate()


def site_launches(cfg, route, calls):
    """The kernel launches of ``calls`` UNet forwards of ``cfg``'s UNet
    through ``route`` (``fused_groupnorm`` or ``fused_resblock``)."""
    tag = "f32" if cfg.parallel.compute_dtype == "float32" else "bf16"
    if route == "fused_resblock":
        return {f"fused_gn_swish_conv_{tag}":
                sum(fused_sites(cfg, 1).values()) * calls}
    sites = gn_sites(cfg, 1)
    return {f"group_norm_{tag}_swish": calls * sum(
                n for key, n in sites.items() if key[3]),
            f"group_norm_{tag}": calls * sum(
                n for key, n in sites.items() if not key[3])}


def variant_restore(name, rest, inp, want, n_timed=1):
    """:func:`counted_restore`, then ``n_timed`` steady runs.  Returns
    (output, launches, first ms, steady ms per image (None without a
    timed run), peak bytes)."""
    import torch

    torch.cuda.empty_cache()
    out, first_ms, got = counted_restore(rest, inp, want, name)
    peak = torch.cuda.max_memory_allocated()
    runs = [restore_timed(rest, inp)[2] / inp.shape[0]
            for _ in range(n_timed)]
    return out, got, first_ms, sum(runs) / len(runs) if runs else None, peak


def gn_row(gen, sites, n, dtype, tag, swish, phase, timed=True):
    """GroupNorm(+swish) at every ``swish`` site of ``sites`` at batch ``n``
    against its plain version (the tolerances of :func:`check_kernels`),
    its times (unless not ``timed``) summed over one UNet forward: one row
    of the kernel table."""
    import torch
    import torch.nn.functional as F

    from wavedm_tpu_torch.ops import groupnorm_cuda as gn

    atol, rtol = (2e-5, 2e-5) if tag == "f32" else (1e-6, 2.0 ** -6)
    row = dict(source="wavedm_tpu_torch/csrc/groupnorm.cu",
               replaces="wavedm_tpu/ops/groupnorm_pallas.py:27",
               max_abs_err=0.0, ms=0.0, device_ms=0.0, plain_ms=0.0,
               bound_ms=0.0, library_ms=0.0, bound_by="bytes")
    for (c, h, w, sw), count in sorted(sites.items()):
        if sw != swish:
            continue
        x = (torch.randn(n, c, h, w, device=gen.device, generator=gen) * 3
             + 1).to(dtype)
        wt = torch.randn(c, device=gen.device, generator=gen)
        bs = torch.randn(c, device=gen.device, generator=gen)
        y = gn.group_norm(x, wt, bs, 32, 1e-6, swish)
        yp = gn.group_norm_plain(x, wt, bs, 32, 1e-6, swish)
        torch.cuda.synchronize()
        diff = (y.float() - yp.float()).abs()
        excess = float((diff - rtol * yp.float().abs()).max())
        assert excess <= atol, (tag, n, c, h, w, swish, excess)
        row["max_abs_err"] = max(row["max_abs_err"], float(diff.max()))
        if not timed:
            emit(phase, kernel=f"group_norm_{tag}" + ("_swish" if swish
                                                      else ""),
                 shape=[n, c, h, w], max_abs_err=float(diff.max()))
            continue
        wl, bl = wt.to(dtype), bs.to(dtype)

        def lib():
            o = F.group_norm(x, 32, wl, bl, 1e-6)
            return F.silu(o) if swish else o

        vals = dict(ms=time_ms(lambda: gn.group_norm(x, wt, bs, 32, 1e-6,
                                                     swish), 10),
                    device_ms=device_ms(lambda t: gn.group_norm(
                        t, wt, bs, 32, 1e-6, swish), x, 10),
                    plain_ms=compare_ms(lambda: gn.group_norm_plain(
                        x, wt, bs, 32, 1e-6, swish)),
                    library_ms=compare_ms(lib),
                    bound_ms=gn_bound_ms(gn, x, swish))
        emit(phase, kernel=f"group_norm_{tag}" + ("_swish" if swish else ""),
             shape=[n, c, h, w], count_per_forward=count,
             max_abs_err=float(diff.max()),
             share_of_bound=vals["bound_ms"] / vals["device_ms"],
             plan=gn_plan(gn, n, c, h * w, dtype), **vals)
        for key, val in vals.items():
            row[key] += count * val
        del x, y, yp
    return row


def fused_row(gen, cfg, n, dtype, tag, phase, hw=None, timed=True,
              iters=10):
    """The fused kernel at every site of ``cfg``'s UNet at batch ``n``
    (:func:`fused_at`, the tolerances of :func:`check_fused_kernels`): one
    row of the kernel table, timed over one UNet forward."""
    row = dict(source="wavedm_tpu_torch/csrc/fused_resblock.cu",
               replaces="wavedm_tpu/ops/fused_resblock.py:67",
               max_abs_err=0.0, max_rel_err=0.0, bound_by="operations")
    tol = 1e-4 if tag == "f32" else 2.0 ** -7
    fused_at(gen, fused_sites(cfg, n, hw), n, dtype, tag, tol, row,
             iters=iters, phase=phase, timed=timed)
    if timed and row["bytes_ms"] > row["ops_ms"]:
        row["bound_by"] = "bytes"
    return row


def variant_train(name, cfg, phase="variants", steps=2, wavelet=None):
    """``steps`` steady-state steps of ``DiffusionTrainer`` on ``cfg``'s
    domain through ``fused_resblock``, on synthetic crops (with the whole
    image on the global domain): a warm-up step, then the steps with the
    launch counts set to 0 just before them, checked against the fused
    kernel's sites and ``wavelet`` (the wavelet kernels' launches a step);
    every parameter with a nonzero gradient moved.  Returns the counts."""
    import itertools

    import torch

    from wavedm_tpu_torch.cli.train_diffusion import smoke_batches
    from wavedm_tpu_torch.training.trainer import DiffusionTrainer

    trainer = DiffusionTrainer(cfg, device=DEV, log_fn=lambda msg: None)
    batches = list(itertools.islice(smoke_batches(cfg)(0), steps + 1))

    def step(batch):
        if trainer.lap_state is not None:
            return trainer.train_step(trainer.state, trainer.lap_state,
                                      batch, 2e-4)
        return trainer.train_step(trainer.state, batch)

    step(batches[0])
    p0 = {k: p.detach().clone() for k, p in trainer.model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.perf_counter()
    metrics = [step(b) for b in batches[1:]]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3 / steps
    got = {k: v for k, v in read_counts().items() if v}
    tag = "f32" if cfg.parallel.compute_dtype == "float32" else "bf16"
    want = {f"fused_gn_swish_conv_{tag}":
            steps * sum(fused_sites(cfg, 1).values())}
    if cfg.data.global_attn:
        wavelet = {"wavelet_dec": 3}     # cond and gt crops, the total
    want.update({k: steps * v for k, v in (wavelet or {}).items()})
    assert got == want, (name, got, want)
    loss = [float(m.loss) for m in metrics]
    assert all(map(math.isfinite, loss)), loss
    graded = [k for k, p in trainer.model.named_parameters()
              if p.grad is not None and p.grad.any()]
    still = [k for k in graded if torch.equal(
        trainer.model.get_parameter(k).detach(), p0[k])]
    assert not still, (name, still)
    emit(phase, train=name, crops=cfg.training.patch_n,
         patch=cfg.data.patch_size, dtype=cfg.parallel.compute_dtype,
         params_unet=sum(p.numel() for p in trainer.model.parameters()),
         launches=got, ms_per_step=ms,
         peak_bytes=torch.cuda.max_memory_allocated(), loss=loss,
         loss_trans=[float(m.loss_trans) for m in metrics],
         tensors=len(p0), tensors_moved=len(graded))
    del trainer, batches, metrics, p0
    torch.cuda.empty_cache()
    return got


VARIANT_SMALL = {
    "pixel": ({"image_size": 16, "patch_size": 16}, (32, 48)),
    "global": ({"image_size": 8, "patch_size": 32}, (128, 192)),
    "lap": ({"image_size": 8, "patch_size": 32}, (64, 96)),
}


def variant_parity():
    """Each variant path at a small size (width 32, two levels, T = 50) on
    the card (kernels) against the same path on the CPU (plain versions),
    float32, the same weights and noise: a restore through each kernel
    route, within 1e-4 (the CPU tests hold the CPU path to JAX to this
    bound), and one SGD train step through ``fused_resblock``, loss and
    parameters within 1e-4 relative."""
    import dataclasses

    import numpy as np
    import torch

    from wavedm_tpu_torch.config import PROFILES, config_from_dict
    from wavedm_tpu_torch.inference.loader import build_restorer
    from wavedm_tpu_torch.training.trainer import DiffusionTrainer

    rng = np.random.default_rng(SEED)
    for name, (data, (h, w)) in VARIANT_SMALL.items():
        raw = dataclasses.asdict(PROFILES[name]())
        raw["data"].update(data)
        raw["model"].update(ch=32, ch_mult=[1, 2], num_res_blocks=1,
                            attn_resolutions=[data["image_size"] // 2])
        raw["diffusion"]["num_diffusion_timesteps"] = 50
        raw["sampling"].update(sampling_timesteps=3, grid_r=4)
        raw["hfrm"].update(dim=8, enc_blk_nums=[1, 1], middle_blk_num=1,
                           dec_blk_nums=[1, 1])
        raw["training"].update(patch_n=4)
        raw["optim"].update(optimizer="SGD", lr=1e-3)
        nch = 6 if name == "lap" else 3
        images = rng.random((2, h, w, nch), dtype=np.float32)
        sub = 1 if name == "pixel" else 4
        noise = torch.randn(2, 3, h // sub, w // sub,
                            generator=torch.Generator().manual_seed(1))
        weights = None
        for route in ("fused_groupnorm", "fused_resblock"):
            if name == "global" and route == "fused_groupnorm":
                continue        # the global UNet takes no GroupNorm kernel
            raw["parallel"] = {route: True}
            cfg = config_from_dict(raw)
            cpu = build_restorer(cfg, *(weights or (None, None)),
                                 device="cpu")
            weights = weights or (cpu.unet.state_dict(), cpu.hfrm and
                                  cpu.hfrm.state_dict())
            ref, _ = cpu.restore_image(images, noise=noise)
            out, _ = build_restorer(cfg, *weights, device="cuda"
                                    ).restore_image(images, noise=noise)
            err = float(np.abs(out - ref).max())
            emit("variants", parity=name, route=route, shape=list(out.shape),
                 max_abs_err=err, tol=1e-4)
            assert err <= 1e-4, (name, route, err)
        batch = rng.random((4, data["patch_size"], data["patch_size"], 6),
                           dtype=np.float32)
        if name == "global":
            batch = (batch, rng.random((1, h, w, 3), dtype=np.float32))
        d = data["patch_size"] // (1 if name == "pixel" else 4)
        t = torch.tensor([3, 46, 20, 29])
        e = torch.randn(4, 3, d, d, generator=torch.Generator().manual_seed(2))
        steps, lap_sd = [], None
        for dev in ("cpu", "cuda"):
            trainer = DiffusionTrainer(cfg, device=dev, log_fn=lambda m: None)
            trainer.model.load_state_dict(weights[0])
            args = (batch,)
            if trainer.lap_state is not None:
                lap_sd = lap_sd or {k: v.clone() for k, v in
                                    trainer.lap_state.model.state_dict()
                                    .items()}
                trainer.lap_state.model.load_state_dict(lap_sd)
                args = (trainer.lap_state, batch, 2e-4)
            m = trainer.train_step(trainer.state, *args, t=t, e=e)
            steps.append((float(m.loss), float(m.loss_trans), {
                k: v.cpu() for k, v in trainer.model.state_dict().items()}))
        (l0, lt0, sd0), (l1, lt1, sd1) = steps
        errs = [abs(l1 - l0) / abs(l0), abs(lt1 - lt0) / max(abs(lt0), 1e-30),
                max(float((sd1[k] - sd0[k]).abs().max() / sd0[k].abs().max())
                    for k in sd0)]
        emit("variants", parity=name, train_step="SGD",
             loss_rel_err=errs[0], loss_trans_rel_err=errs[1],
             param_rel_err=errs[2], tol_rel=1e-4)
        assert max(errs) <= 1e-4, (name, errs)


def variant_kernel_rows(pix, lap_cfg, n):
    """Every kernel against its plain version at the shapes the variant
    paths give it, timed: {row name: (row, the run whose launches it
    counts)}.  ``n``: patches a UNet call of each run (``pixel``,
    ``pixel_small``, ``lap``)."""
    import torch

    from wavedm_tpu_torch.ops import wavelet_cuda as wv
    from wavedm_tpu_torch.ops.wavelet import conv_weights

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    f32, bf16 = torch.float32, torch.bfloat16
    new = {}
    # the DWT of the global domain's whole image, (1, 3, 480, 720)
    x = torch.rand(1, 3, HEIGHT, WIDTH, device=gen.device,
                   generator=gen) * 2 - 1
    z, z_plain = wv.wavelet_dec_cuda(x), wv.wavelet_dec_plain(x)
    torch.cuda.synchronize()
    err = float((z - z_plain).abs().max())
    assert err <= 2e-6, err
    bank = torch.as_tensor(conv_weights(2, 3), device=x.device)
    new["wavelet_dec@global_total"] = (dict(
        source="wavedm_tpu_torch/csrc/wavelet.cu",
        replaces="wavedm_tpu/ops/wavelet_pallas.py:44", max_abs_err=err,
        ms=time_ms(lambda: wv.wavelet_dec_cuda(x)),
        device_ms=device_ms(wv.wavelet_dec_cuda, x),
        **host_times(lambda: wv.wavelet_dec_cuda(x)),
        plain_ms=time_ms(lambda: wv.wavelet_dec_plain(x)),
        bound_ms=bound_ms(x, z), bound_by="bytes",
        library_ms=time_ms(lambda: torch.nn.functional.conv2d(
            x, bank, stride=4, groups=3))), "train_global")
    del x, z, z_plain

    pix32 = variant_cfg("pixel")
    for cfg, m, dtype, tag, path, run in (
            (pix, n["pixel"], bf16, "bf16", "pixel", "pixel_fused_groupnorm"),
            (pix32, n["pixel_small"], f32, "f32", "pixel_small",
             "pixel_small_fused_groupnorm"),
            (lap_cfg, n["lap"], f32, "f32", "lap", "lap_fused_groupnorm")):
        sites = gn_sites(cfg, m)
        for swish in (True, False):
            name = f"group_norm_{tag}" + ("_swish" if swish else "")
            new[f"{name}@{path}"] = (gn_row(gen, sites, m, dtype, tag, swish,
                                            "variants"), run)
    for key, cfg, m, dtype, tag, run, iters in (
            ("pixel", pix, n["pixel"], bf16, "bf16", "pixel_fused_resblock",
             5),
            ("pixel_small", pix32, n["pixel_small"], f32, "f32",
             "pixel_small_fused_resblock", 1),
            ("lap", lap_cfg, n["lap"], f32, "f32", "lap_fused_resblock", 5),
            ("lap_train", lap_cfg, lap_cfg.training.patch_n, f32, "f32",
             "train_lap", 5)):
        # the lap domain trains on the 4x smaller coarse level of its crops
        hw = ((lap_cfg.data.patch_size // 4,) * 2 if key == "lap_train"
              else None)
        new[f"fused_gn_swish_conv_{tag}@{key}"] = (fused_row(
            gen, cfg, m, dtype, tag, "variants", hw, iters=iters), run)
    # the pixel domain's training shapes (20 crops of 128x128), checked but
    # not timed.  The global UNet's ResnetBlocks are the flagship's, at the
    # flagship's batches (90 patches, 8 training crops): the ``kernels``
    # and ``train`` phases hold them.
    fused_row(gen, pix32, pix32.training.patch_n, f32, "f32", "variants",
              timed=False)
    torch.cuda.empty_cache()
    return new


def variants_phase(launches, rows):
    """The three variant paths of the shipped configs at full width,
    random weights from seed 61, each chain cut to ``VARIANT_STEPS`` steps:

    - each path at a small size on the card against the CPU
      (:func:`variant_parity`);
    - every kernel against its plain version at the shapes these paths
      give it (:func:`variant_kernel_rows`), each a new row of the kernel
      table, its launches those of the run below that used it;
    - pixel (``raindrop.yaml``, 109.7 M params): one 720x480 image, 874
      patches of 128x128 in micro-batches of ``PIXEL_MB``, bfloat16 through
      ``fused_groupnorm`` and through ``fused_resblock`` and float32
      through ``fused_resblock``: in one UNet call and in the restore,
      each bfloat16 route within twice the other's distance to float32;
      then float32 on a 256x256 image (81 patches) through both routes,
      held within 1e-3 (summation order);
    - global attention (``raindrop_wavelet_global.yaml``, float32): two
      720x480 images through ``fused_resblock`` at B = 2, and again in
      micro-batches of 16 patches, held within 1e-3 (each patch attends
      to its own image either way);
    - Laplacian (``raindrop_lap.yaml``, float32): one 720x480 [cond | gt]
      pair through ``fused_groupnorm`` and ``fused_resblock``, within 1e-3;
    - one steady-state training step of each domain (``fused_resblock``).
    """
    import numpy as np
    import torch

    from wavedm_tpu_torch.diffusion.sampling import overlapping_grid_corners
    from wavedm_tpu_torch.inference.loader import build_restorer

    t_phase = time.perf_counter()
    image = synthetic_images(SEED, 1)
    counts = {}
    pix = variant_cfg("pixel", parallel__compute_dtype="bfloat16",
                      parallel__fused_groupnorm=True,
                      sampling__patch_micro_batch=PIXEL_MB)
    glob = variant_cfg("global", parallel__fused_resblock=True)
    lap_cfg = variant_cfg("lap")

    def patches(cfg, h, w):
        return len(overlapping_grid_corners(h, w, cfg.data.image_size,
                                            cfg.sampling.grid_r))

    k_pix = patches(pix, HEIGHT, WIDTH)
    k_small = patches(pix, SMALL, SMALL)
    k_glob = N_IMAGES * patches(glob, HEIGHT // 4, WIDTH // 4)
    k_lap = patches(lap_cfg, HEIGHT // 4, WIDTH // 4)
    variant_parity()
    new = variant_kernel_rows(pix, lap_cfg, {
        "pixel": PIXEL_MB, "pixel_small": k_small, "lap": k_lap})

    # ---- pixel: 720x480 in bfloat16 through both kernel routes; float32
    chunks = -(-k_pix // PIXEL_MB)
    rest = build_restorer(pix, None, device="cuda")
    n_pix = sum(p.numel() for p in rest.unet.parameters())
    assert n_pix == VARIANT_PARAMS["pixel"], n_pix
    unet_sd = rest.unet.state_dict()
    # one UNet call of the chain: its first micro-batch at t = 499
    p = pix.data.image_size
    corners = overlapping_grid_corners(HEIGHT, WIDTH, p,
                                       pix.sampling.grid_r)[:PIXEL_MB]
    probe_gen = torch.Generator(device="cuda").manual_seed(SEED)
    cond = torch.as_tensor(image, device=probe_gen.device).permute(
        0, 3, 1, 2) * 2 - 1
    probe = torch.cat([torch.cat([cond[:, :, i:i + p, j:j + p]
                                  for i, j in corners]),
                       torch.randn(len(corners), 3, p, p, generator=probe_gen,
                                   device=probe_gen.device)], dim=1)
    t_probe = torch.full((len(corners),), 499.0, device=probe_gen.device)
    outs, eps = {}, {}
    for route, cfg, n_timed in (
            ("fused_groupnorm", pix, 1),
            ("fused_resblock", variant_cfg(
                "pixel", parallel__compute_dtype="bfloat16",
                parallel__fused_resblock=True,
                sampling__patch_micro_batch=PIXEL_MB), 1),
            ("f32_fused_resblock", variant_cfg(
                "pixel", parallel__fused_resblock=True,
                sampling__patch_micro_batch=PIXEL_MB), 0)):
        if route != "fused_groupnorm":
            rest = build_restorer(cfg, unet_sd, device="cuda")
        kind = ("fused_groupnorm" if route == "fused_groupnorm"
                else "fused_resblock")
        out, got, first_ms, ms, peak = variant_restore(
            f"pixel {route}", rest, image,
            site_launches(cfg, kind, VARIANT_STEPS * chunks), n_timed)
        with torch.no_grad():
            eps[route] = rest.unet(probe, t_probe)
        del rest
        outs[route] = out
        counts[f"pixel_{route}"] = got
        emit("variants", path="pixel", route=route,
             dtype=cfg.parallel.compute_dtype, params_unet=n_pix,
             patches=k_pix, micro_batch=PIXEL_MB, steps=VARIANT_STEPS,
             launches=got, first_ms_per_image=first_ms, ms_per_image=ms,
             peak_bytes=peak)
    # one UNet call and the chain: each bfloat16 route against the float32
    # one.  The two bfloat16 routes round at different points at 64 of the
    # 71 norm sites, so they part by about as much as either parts from
    # float32 (the flagship's production chain, from the HFRM band, keeps
    # them within that gap; this chain starts from noise): each route is
    # held within twice the other's distance to float32, which a wrong
    # kernel result at any site would exceed by far.
    def dist(a, b):
        return float((a - b).abs().max())

    ref = "f32_fused_resblock"
    fwd = [dist(eps[r], eps[ref]) for r in ("fused_groupnorm",
                                            "fused_resblock")]
    gaps = [dist(outs[r], outs[ref]) for r in ("fused_groupnorm",
                                               "fused_resblock")]
    emit("variants", path="pixel",
         forward_fused_resblock_vs_fused_groupnorm=dist(
             eps["fused_resblock"], eps["fused_groupnorm"]),
         forward_fused_groupnorm_vs_f32=fwd[0],
         forward_fused_resblock_vs_f32=fwd[1],
         chain_fused_resblock_vs_fused_groupnorm=dist(
             outs["fused_resblock"], outs["fused_groupnorm"]),
         chain_mean_abs_diff=float((outs["fused_resblock"]
                                    - outs["fused_groupnorm"]).abs().mean()),
         chain_fused_groupnorm_vs_f32=gaps[0],
         chain_fused_resblock_vs_f32=gaps[1])
    assert max(fwd) <= 2 * min(fwd), fwd
    assert max(gaps) <= 2 * min(gaps), gaps
    del outs, eps, probe, cond

    y0, x0 = (HEIGHT - SMALL) // 2, (WIDTH - SMALL) // 2
    small = image[:, y0:y0 + SMALL, x0:x0 + SMALL]
    small_outs = {}
    for route in ("fused_groupnorm", "fused_resblock"):
        cfg = variant_cfg("pixel", **{f"parallel__{route}": True})
        rest = build_restorer(cfg, unet_sd, device="cuda")
        # float32 through cuDNN takes seconds here: its first run only
        out, got, first_ms, ms, peak = variant_restore(
            f"pixel_small {route}", rest, small,
            site_launches(cfg, route, VARIANT_STEPS),
            int(route == "fused_resblock"))
        del rest
        small_outs[route] = out
        counts[f"pixel_small_{route}"] = got
        emit("variants", path="pixel", image=[SMALL, SMALL], route=route,
             dtype="float32", patches=k_small, steps=VARIANT_STEPS,
             launches=got, first_ms_per_image=first_ms, ms_per_image=ms,
             peak_bytes=peak)
    diff = float((small_outs["fused_resblock"]
                  - small_outs["fused_groupnorm"]).abs().max())
    emit("variants", path="pixel", image=[SMALL, SMALL],
         fused_resblock_vs_fused_groupnorm=diff, tol_abs=1e-3)
    assert diff <= 1e-3, diff
    del unet_sd, small_outs
    torch.cuda.empty_cache()

    # ---- global attention: two images, B = 2, unbatched and micro-batched
    images = synthetic_images(SEED)
    rest = build_restorer(glob, None, None, device="cuda")
    n_glob = sum(p.numel() for p in rest.unet.parameters())
    assert n_glob == VARIANT_PARAMS["global"], n_glob
    unet_sd, hfrm_sd = rest.unet.state_dict(), rest.hfrm.state_dict()
    glob_outs = {}
    for mb in (0, 16):
        if mb:
            rest = build_restorer(variant_cfg(
                "global", parallel__fused_resblock=True,
                sampling__patch_micro_batch=mb), unet_sd, hfrm_sd,
                device="cuda")
        calls = VARIANT_STEPS * (-(-k_glob // mb) if mb else 1)
        want = dict(site_launches(glob, "fused_resblock", calls),
                    wavelet_dec=2, wavelet_rec=1)
        out, got, first_ms, ms, peak = variant_restore(
            f"global mb{mb}", rest, images, want)
        del rest
        glob_outs[mb] = out
        counts[f"global_mb{mb}"] = got
        emit("variants", path="global", route="fused_resblock",
             dtype="float32", params_unet=n_glob, images=N_IMAGES,
             patches=k_glob, micro_batch=mb, steps=VARIANT_STEPS,
             launches=got, first_ms_per_image=first_ms, ms_per_image=ms,
             peak_bytes=peak)
    diff = float((glob_outs[16] - glob_outs[0]).abs().max())
    emit("variants", path="global", micro_batch16_vs_unbatched=diff,
         tol_abs=1e-3)
    assert diff <= 1e-3, diff
    del unet_sd, hfrm_sd, glob_outs
    torch.cuda.empty_cache()

    # ---- Laplacian: one [cond | gt] pair, both kernel routes
    pair = np.concatenate([image, synthetic_images(SEED + 1, 1)], axis=-1)
    lap_outs, unet_sd = {}, None
    for route in ("fused_groupnorm", "fused_resblock"):
        cfg = variant_cfg("lap", **{f"parallel__{route}": True})
        rest = build_restorer(cfg, unet_sd, device="cuda")
        if unet_sd is None:
            unet_sd = rest.unet.state_dict()
            n_lap = sum(p.numel() for p in rest.unet.parameters())
            assert n_lap == VARIANT_PARAMS["lap"], n_lap
        out, got, first_ms, ms, peak = variant_restore(
            f"lap {route}", rest, pair, site_launches(cfg, route,
                                                      VARIANT_STEPS))
        del rest
        lap_outs[route] = out
        counts[f"lap_{route}"] = got
        emit("variants", path="lap", route=route, dtype="float32",
             params_unet=n_lap, patches=k_lap, steps=VARIANT_STEPS,
             launches=got, first_ms_per_image=first_ms, ms_per_image=ms,
             peak_bytes=peak)
    diff = float((lap_outs["fused_resblock"] - lap_outs["fused_groupnorm"])
                 .abs().max())
    emit("variants", path="lap", fused_resblock_vs_fused_groupnorm=diff,
         tol_abs=1e-3)
    assert diff <= 1e-3, diff
    del unet_sd, lap_outs
    torch.cuda.empty_cache()

    # ---- one steady-state training step of each domain
    for name in ("pixel", "global", "lap"):
        counts[f"train_{name}"] = variant_train(
            name, variant_cfg(name, parallel__fused_resblock=True))

    for name, (row, run) in new.items():
        launches[name] = counts[run].get(name.split("@")[0], 0)
        assert launches[name] > 0, f"kernel {name} never ran on its path"
        rows[name] = row
        emit("variants", kernel=name, launches=launches[name],
             per="call (wavelet) or UNet forward",
             **{k: v for k, v in row.items() if k not in ("source",
                                                          "replaces")})
    emit("variants", seconds=time.perf_counter() - t_phase)


SWITCH_SIDE = 256       # the pixel switches' image: 81 patches of 128x128
GRAD_SHAPE = (90, 6, 256, 256)   # a wavelet_in_unet UNet call's input
SWITCH_CROPS = 8        # crops of each switch's training step
AUX_BATCH = 8           # stage 1's batch of 720x480 pairs, aux terms on
# the reference profile's UNet, taking the DWT itself on 256x256 pixels
WAVELET_IN_UNET = dict(
    data__wavelet_in_unet=True, data__image_size=256, data__patch_size=256,
    model__in_channels=3, model__pred_channels=3, model__out_ch=48,
    model__use_other_channels=False, model__other_channels_begin=0,
    sampling__grid_r=64)
# the pixel profile with its 128x128 patches cut into 2x2 tiles of 64x64,
# or with the FFT amplitude and phase beside the cond pixels
WINDOW = dict(data__use_window=True, data__window_size=2, model__out_ch=12)
FFT = dict(data__use_fft=True, model__in_channels=9)
SWITCH_SMALL = {
    "wavelet_in_unet": ("reference", {
        "data": {"wavelet_in_unet": True, "image_size": 32,
                 "patch_size": 32},
        "model": {"in_channels": 3, "pred_channels": 3, "out_ch": 48,
                  "use_other_channels": False, "other_channels_begin": 0,
                  "attn_resolutions": [16]},
        "sampling": {"grid_r": 16}}, (64, 96)),
    "use_window": ("pixel", {
        "data": {"use_window": True, "window_size": 2, "image_size": 16,
                 "patch_size": 16},
        "model": {"out_ch": 12, "attn_resolutions": [8]},
        "sampling": {"grid_r": 8}}, (32, 48)),
    "use_fft": ("pixel", {
        "data": {"use_fft": True, "image_size": 16, "patch_size": 16},
        "model": {"in_channels": 9, "attn_resolutions": [8]},
        "sampling": {"grid_r": 8}}, (32, 48)),
}


def switch_parity():
    """Each switch at a small size (width 32, two levels, T = 50) on the
    card (kernels) against the same path on the CPU (plain versions),
    float32, the same weights and noise: a 3-step restore through each
    kernel route within 1e-4 (the CPU tests hold the CPU path to JAX to
    this bound), and one SGD train step through ``fused_resblock``, loss
    and parameters within 1e-4 relative (under ``wavelet_in_unet`` its
    backward runs the DWT kernel as the IWT's gradient)."""
    import dataclasses

    import numpy as np
    import torch

    from wavedm_tpu_torch.config import PROFILES, config_from_dict
    from wavedm_tpu_torch.inference.loader import build_restorer
    from wavedm_tpu_torch.training.trainer import DiffusionTrainer

    rng = np.random.default_rng(SEED + 9)
    for name, (base, changes, (h, w)) in SWITCH_SMALL.items():
        raw = dataclasses.asdict(PROFILES[base]())
        for section, values in changes.items():
            raw[section].update(values)
        raw["model"].update(ch=32, ch_mult=[1, 2], num_res_blocks=1)
        raw["diffusion"]["num_diffusion_timesteps"] = 50
        raw["sampling"].update(sampling_timesteps=3)
        raw["training"].update(patch_n=4)
        raw["optim"].update(optimizer="SGD", lr=1e-3)
        images = rng.random((2, h, w, 3), dtype=np.float32)
        noise = torch.randn(2, 3, h, w,
                            generator=torch.Generator().manual_seed(1))
        weights = None
        for route in ("fused_groupnorm", "fused_resblock"):
            raw["parallel"] = {route: True}
            cfg = config_from_dict(raw)
            cpu = build_restorer(cfg, weights, device="cpu")
            weights = weights or cpu.unet.state_dict()
            ref, _ = cpu.restore_image(images, noise=noise)
            reset_counts()
            out, _ = build_restorer(cfg, weights, device=DEV
                                    ).restore_image(images, noise=noise)
            err = float(np.abs(out - ref).max())
            emit("switches", parity=name, route=route, shape=list(out.shape),
                 max_abs_err=err, tol=1e-4,
                 launches={k: v for k, v in read_counts().items() if v})
            assert err <= 1e-4, (name, route, err)
        p = raw["data"]["patch_size"]
        batch = rng.random((4, p, p, 6), dtype=np.float32)
        t = torch.tensor([3, 46, 20, 29])
        e = torch.randn(4, 3, p, p, generator=torch.Generator().manual_seed(2))
        steps = []
        for dev in ("cpu", DEV):
            trainer = DiffusionTrainer(cfg, device=dev, log_fn=lambda m: None)
            trainer.model.load_state_dict(weights)
            reset_counts()
            m = trainer.train_step(trainer.state, batch, t=t, e=e)
            steps.append((float(m.loss), {
                k: v.cpu() for k, v in trainer.model.state_dict().items()}))
        counts = {k: v for k, v in read_counts().items() if v}
        if name == "wavelet_in_unet":
            assert counts.get("wavelet_rec_backward") == 1, counts
        (l0, sd0), (l1, sd1) = steps
        errs = [abs(l1 - l0) / abs(l0),
                max(float((sd1[k] - sd0[k]).abs().max() / sd0[k].abs().max())
                    for k in sd0)]
        emit("switches", parity=name, train_step="SGD", launches=counts,
             loss_rel_err=errs[0], param_rel_err=errs[1], tol_rel=1e-4)
        assert max(errs) <= 1e-4, (name, errs)


def wavelet_grad_rows():
    """The DWT/IWT kernels where ``wavelet_in_unet`` puts them, at a
    full-width restore's UNet call (90 patches of 256x256): the DWT of
    each 3-channel slice of the (90, 6, 256, 256) input, read in place and
    written into its half of the (90, 96, 64, 64) tensor conv_in takes;
    the IWT of the (90, 48, 64, 64) output; and under autograd each
    Function's backward (the other kernel on the gradient, the gradient's
    channel slices for the DWT) against plain autograd of the plain
    version, within 1e-6 of the gradient's scale.  Returns the rows of
    the kernel table: {name: row}; the DWT's backward runs on no path
    (the UNet's input takes no gradient) and gets none."""
    import types

    import torch
    import torch.nn.functional as F

    from wavedm_tpu_torch.ops import wavelet_cuda as wv
    from wavedm_tpu_torch.ops.wavelet import conv_weights

    gen = torch.Generator(device=DEV).manual_seed(SEED + 7)
    src = dict(source="wavedm_tpu_torch/csrc/wavelet.cu", bound_by="bytes")
    dec_at, rec_at = "wavedm_tpu/ops/wavelet_pallas.py:44", \
        "wavedm_tpu/ops/wavelet_pallas.py:60"
    bank = torch.as_tensor(conv_weights(2, 3), device=DEV)
    tol = 2e-6
    x6 = torch.rand(GRAD_SHAPE, device=DEV, generator=gen) * 2 - 1
    z = wv.wavelet_dec_cat([x6[:, :3], x6[:, 3:]])
    zp = torch.cat([wv.wavelet_dec_plain(x6[:, :3]),
                    wv.wavelet_dec_plain(x6[:, 3:])], dim=1)
    y = wv.wavelet_rec_cuda(z[:, :48].contiguous())
    torch.cuda.synchronize()
    dec_err = float((z - zp).abs().max())
    rt_err = float((y - x6[:, :3]).abs().max())
    assert dec_err <= tol and rt_err <= tol, (dec_err, rt_err)
    rows = {}
    xs = x6[:, :3]
    rows["wavelet_dec@wavelet_in_unet"] = dict(
        src, replaces=dec_at, max_abs_err=dec_err,
        ms=time_ms(lambda: wv.wavelet_dec_cuda(xs)),
        device_ms=device_ms(lambda t: wv.wavelet_dec_cuda(t[:, :3]), x6),
        **host_times(lambda: wv.wavelet_dec_cuda(xs)),
        plain_ms=time_ms(lambda: wv.wavelet_dec_plain(xs)),
        bound_ms=bound_ms(xs, z[:, :48]),
        library_ms=time_ms(lambda: F.conv2d(xs, bank, stride=4, groups=3)))
    z48 = z[:, :48].contiguous()
    y = wv.wavelet_rec_cuda(z48)
    rec_err = float((y - wv.wavelet_rec_plain(z48)).abs().max())
    assert rec_err <= tol, rec_err
    z_lib = F.conv2d(xs, bank, stride=4, groups=3)
    rows["wavelet_rec@wavelet_in_unet"] = dict(
        src, replaces=rec_at, max_abs_err=rec_err,
        ms=time_ms(lambda: wv.wavelet_rec_cuda(z48)),
        device_ms=device_ms(wv.wavelet_rec_cuda, z48),
        **host_times(lambda: wv.wavelet_rec_cuda(z48)),
        plain_ms=time_ms(lambda: wv.wavelet_rec_plain(z48)),
        bound_ms=bound_ms(z48, y),
        library_ms=time_ms(lambda: F.conv_transpose2d(z_lib, bank, stride=4,
                                                      groups=3)))
    del z_lib, zp

    # the gradients: the Functions' backward against plain autograd
    g = torch.randn(y.shape, device=DEV, generator=gen)
    zq, zr = z48.clone().requires_grad_(), z48.clone().requires_grad_()
    (wv.wavelet_rec_cuda(zq) * g).sum().backward()
    (wv.wavelet_rec_plain(zr) * g).sum().backward()
    gz = torch.randn(z.shape, device=DEV, generator=gen)
    xq, xr = x6.clone().requires_grad_(), x6.clone().requires_grad_()
    (wv.wavelet_dec_cat([xq[:, :3], xq[:, 3:]]) * gz).sum().backward()
    (torch.cat([wv.wavelet_dec_plain(xr[:, :3]),
                wv.wavelet_dec_plain(xr[:, 3:])], dim=1) * gz
     ).sum().backward()
    torch.cuda.synchronize()
    diffs = {"rec_backward": float((zq.grad - zr.grad).abs().max()),
             "dec_backward": float((xq.grad - xr.grad).abs().max())}
    errs = {"rec_backward": diffs["rec_backward"] / float(
                zr.grad.abs().max()),
            "dec_backward": diffs["dec_backward"] / float(
                xr.grad.abs().max())}
    assert max(errs.values()) <= 1e-6, errs
    del zq, zr, xq, xr
    rows["wavelet_rec_backward@wavelet_in_unet_train"] = dict(
        src, replaces=dec_at, max_abs_err=diffs["rec_backward"],
        ms=time_ms(lambda: wv.WaveletRec.backward(None, g)),
        device_ms=device_ms(lambda t: wv.WaveletRec.backward(None, t), g),
        **host_times(lambda: wv.WaveletRec.backward(None, g)),
        plain_ms=time_ms(lambda: wv.wavelet_dec_plain(g)),
        bound_ms=bound_ms(g, z48),
        library_ms=time_ms(lambda: F.conv2d(g, bank, stride=4, groups=3)))
    # the DWT's backward on the gradient's two channel slices: measured,
    # no row (no path runs it)
    ctx = types.SimpleNamespace(widths=[3, 3], needs_input_grad=(True, True))
    emit("switches", kernel="wavelet_dec_backward", shape=list(gz.shape),
         grad_rel_err=errs["dec_backward"], tol_rel=1e-6,
         ms=time_ms(lambda: wv.WaveletDecCat.backward(ctx, gz)),
         device_ms=device_ms(lambda t: wv.WaveletDecCat.backward(ctx, t),
                             gz),
         plain_ms=time_ms(lambda: torch.cat(
             [wv.wavelet_rec_plain(gz[:, :48]),
              wv.wavelet_rec_plain(gz[:, 48:])], dim=1)),
         library_ms=time_ms(lambda: torch.cat(
             [F.conv_transpose2d(gz[:, :48], bank, stride=4, groups=3),
              F.conv_transpose2d(gz[:, 48:], bank, stride=4, groups=3)],
             dim=1)),
         bound_ms=bound_ms(gz, x6), launches_on_paths=0)
    emit("switches", kernel="wavelet_grad", rec_backward_rel_err=errs[
        "rec_backward"], dec_backward_rel_err=errs["dec_backward"],
         tol_rel=1e-6, dec_err=dec_err, rec_err=rec_err, roundtrip_err=rt_err,
         tol=tol)
    del x6, z, z48, y, g, gz
    torch.cuda.empty_cache()
    return rows


def aux_parity():
    """Stage 1's aux models on the card against the CPU, float32: HFRM
    (tlc=...) at full width on one 720x480 image, WDNet and SAM at small
    sizes, and a small HFRM (dim 16) step with the GAN and perceptual
    terms from the same weights: both losses, the PSNR and every gradient
    of the generator against the CPU's, the discriminator's against its
    float64 gradient (:func:`disc_grad_f64`)."""
    import numpy as np
    import torch

    from wavedm_tpu_torch.config import config_from_dict
    from wavedm_tpu_torch.inference.loader import init_random_
    from wavedm_tpu_torch.models.hfrm import HFRM
    from wavedm_tpu_torch.models.sam import SAM
    from wavedm_tpu_torch.models.wdnet import WDNet
    from wavedm_tpu_torch.training.hfrm_trainer import HFRMTrainer

    # HFRM with TLC at full width on one 720x480 image: windows of half
    # the image's sides at each level (base size half the training size)
    tlc = ((HEIGHT // 2, WIDTH // 2), (HEIGHT, WIDTH))
    x = torch.from_numpy(synthetic_images(SEED + 2, 1)).permute(0, 3, 1, 2)
    res = []
    for dev in ("cpu", DEV):
        with torch.device("meta"):
            m = HFRM(tlc=tlc)
        m = m.to_empty(device=dev)
        with torch.no_grad():
            if res:
                m.load_state_dict(res[0][1])
            else:
                init_random_(m, torch.Generator().manual_seed(SEED))
                for name, p in m.named_parameters():
                    if name.endswith(("beta", "gamma")):
                        p.fill_(0.5)
            res.append((m(x.to(dev)).cpu(), m.state_dict()))
    with torch.no_grad():       # the same network, global pooling
        for mod in m.modules():
            if hasattr(mod, "tlc"):
                mod.tlc = None
        plain_pool = m(x.to(DEV)).cpu()
    err = float((res[1][0] - res[0][0]).abs().max() / res[0][0].abs().max())
    moved = float((plain_pool - res[1][0]).abs().max())
    emit("switches", check="HFRM(tlc) 720x480, card vs CPU (float32)",
         tlc=tlc, rel_err=err, tol_rel=1e-4,
         tlc_vs_global_pool=moved)
    assert err <= 1e-4 and moved > 1e-3, (err, moved)

    for name, net, shape in (("WDNet", WDNet, (2, 48, 32, 48)),
                             ("SAM", lambda: SAM(64, 32), (2, 64, 16, 24))):
        xs = torch.randn(shape, generator=torch.Generator().manual_seed(3))
        outs, sd = [], None
        for dev in ("cpu", DEV):
            m = net().to(dev)
            if sd is None:
                init_random_(m, torch.Generator().manual_seed(SEED))
                sd = m.state_dict()
            m.load_state_dict(sd)
            with torch.no_grad():
                outs.append(m(xs.to(dev)).cpu())
        err = float((outs[1] - outs[0]).abs().max() / outs[0].abs().max())
        emit("switches", check=f"{name} {list(shape)}, card vs CPU",
             rel_err=err, tol_rel=1e-4)
        assert err <= 1e-4, (name, err)

    cfg = config_from_dict({"hfrm": {
        "dim": 16, "enc_blk_nums": [1, 1], "middle_blk_num": 1,
        "dec_blk_nums": [1, 1], "use_gan": True, "use_perceptual": True}})
    batch = np.random.default_rng(SEED).random((2, 64, 96, 6),
                                               dtype=np.float32)
    out, weights = [], None
    for dev in ("cpu", DEV):
        tr = HFRMTrainer(cfg, device=dev, log_fn=lambda s: None)
        nets = (tr.model, tr.disc_state.model, tr.vgg)
        if weights is None:
            init_random_(tr.model, torch.Generator().manual_seed(SEED))
            with torch.no_grad():
                for name, p in tr.model.named_parameters():
                    if name.endswith(("beta", "gamma")):
                        p.fill_(0.5)
            weights = [{k: v.clone() for k, v in net.state_dict().items()}
                       for net in nets]
        for net, sd in zip(nets, weights):
            net.load_state_dict(sd)
        if not out:
            d_ref = disc_grad_f64(tr, batch)
        loss, psnr = tr.train_step(batch)
        grads = {f"0.{k}": p.grad.cpu() for k, p in tr.model.named_parameters()}
        if out:
            grads.update({f"1.{k}": p.grad.cpu() for k, p in
                          tr.disc_state.model.named_parameters()})
        else:
            grads.update(d_ref)
        out.append(([float(loss), float(tr.d_loss), float(psnr)], grads))
    (s_cpu, g_cpu), (s_gpu, g_gpu) = out
    scalar_err = max(abs(a - b) / abs(a) for a, b in zip(s_cpu, s_gpu))
    # the discriminator's conv biases before an InstanceNorm have an exact
    # gradient of 0 (the norm cancels a per-channel constant): float noise
    # on either side, not compared
    noise = {f"1.model.{i}.bias" for i in (2, 5, 8)}
    errs = sorted(((float((g_gpu[k] - g).abs().max() / g.abs().max()), k,
                    float(g.abs().max())) for k, g in g_cpu.items()
                   if k not in noise), reverse=True)
    grad_err = errs[0][0]
    emit("switches", check="small HFRM step with GAN + perceptual, card "
         "(float32) vs CPU (float32; the discriminator's gradient float64)",
         g_loss=s_gpu[0], d_loss=s_gpu[1],
         scalar_rel_err=scalar_err, grad_rel_err=grad_err,
         worst=errs[:6], tol_rel=dict(scalars=1e-4, grad=1e-4))
    assert scalar_err <= 1e-4 and grad_err <= 1e-4, (scalar_err, grad_err)


def disc_grad_f64(tr, batch):
    """The gradient of ``tr``'s discriminator loss at its current weights,
    in float64 on the CPU, on the batch and the generator's float32 output
    (the reference of the card's float32 step: PyTorch's float32 conv
    backward on the CPU parts from float64 by 6% at the discriminator's
    4x4 stride-2 convs on these inputs; the card's, TF32 off, by 3e-6)."""
    import copy

    import torch

    x = torch.as_tensor(batch).permute(0, 3, 1, 2)
    cond, gt = x[:, :3].contiguous(), x[:, 3:].contiguous()
    with torch.no_grad():
        fake = tr.model(cond.to(tr.device)).double().cpu()
    disc = copy.deepcopy(tr.disc_state.model).cpu().double()
    cond, gt = cond.double(), gt.double()
    d_loss = 0.5 * (torch.mean(torch.square(disc(cond, gt) - 1.0))
                    + torch.mean(torch.square(disc(cond, fake))))
    d_loss.backward()
    return {f"1.{k}": p.grad.float() for k, p in disc.named_parameters()}


def hfrm_aux_step():
    """One ``HFRMTrainer`` step at full width (dim 32, float32, TF32 off,
    ``hfrm.remat``) with the perceptual and GAN terms on, at batch
    ``AUX_BATCH`` of 720x480 pairs: both losses finite, the discriminator
    moved, VGG19 frozen; the first (cold) step's ms, then a second step's
    as the steady ms per step, and the peak memory."""
    import numpy as np
    import torch

    from wavedm_tpu_torch.config import reference_profile
    from wavedm_tpu_torch.training.hfrm_trainer import HFRMTrainer

    cfg = reference_profile()
    cfg.hfrm.use_gan = cfg.hfrm.use_perceptual = cfg.hfrm.remat = True
    tr = HFRMTrainer(cfg, device=DEV, log_fn=lambda s: None)
    cond, gt = synthetic_images(SEED), synthetic_images(SEED + 1)
    reps = AUX_BATCH // N_IMAGES
    batch = torch.from_numpy(np.concatenate(
        [np.concatenate([cond, gt], axis=-1)] * reps)).to(DEV)
    d0 = {k: v.clone() for k, v in tr.disc_state.model.state_dict().items()}
    v0 = {k: v.clone() for k, v in tr.vgg.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    loss, psnr = tr.train_step(batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    peak = torch.cuda.max_memory_allocated()
    g_loss, d_loss = float(loss), float(tr.d_loss)
    assert math.isfinite(g_loss) and math.isfinite(d_loss), (g_loss, d_loss)
    assert tr.disc_state.step == 1
    assert all(not torch.equal(v, d0[k]) for k, v in
               tr.disc_state.model.state_dict().items() if k.endswith(
                   "weight")), "the discriminator did not move"
    assert all(torch.equal(v, v0[k]) for k, v in tr.vgg.state_dict().items())
    t = time.perf_counter()
    loss, _ = tr.train_step(batch)
    torch.cuda.synchronize()
    steady_ms = (time.perf_counter() - t) * 1e3
    peak = max(peak, torch.cuda.max_memory_allocated())
    assert math.isfinite(float(loss)) and tr.disc_state.step == 2
    emit("switches", train="hfrm_gan_perceptual", batch=list(batch.shape),
         params_hfrm=sum(p.numel() for p in tr.model.parameters()),
         params_disc=sum(p.numel() for p in tr.disc_state.model.parameters()),
         params_vgg=sum(p.numel() for p in tr.vgg.parameters()),
         remat=True, dtype="float32", first_step_ms=ms,
         ms_per_step=steady_ms, peak_bytes=peak,
         g_loss=g_loss, d_loss=d_loss, psnr=float(psnr))
    del tr, batch, d0, v0
    torch.cuda.empty_cache()


def switches_phase(launches, rows):
    """The UNet's switches that no shipped config turns on, and stage 1's
    aux terms, at full width, random weights from seed 61, chains cut to
    ``VARIANT_STEPS`` steps:

    - each switch at a small size on the card against the CPU
      (:func:`switch_parity`);
    - the DWT/IWT kernels at ``wavelet_in_unet``'s shapes, forward and the
      IWT's backward, new rows of the kernel table, their gradients
      against plain autograd (:func:`wavelet_grad_rows`);
    - ``wavelet_in_unet`` (the reference profile's UNet on 256x256 pixel
      patches: conv_in 96, out_ch 48): two 720x480 images, 90 patches, in
      bfloat16 through ``fused_groupnorm`` and in float32 through
      ``fused_resblock``, each UNet call launching two DWTs and one IWT;
      one float32 training step on ``SWITCH_CROPS`` crops whose backward
      launches the DWT kernel as the IWT's gradient;
    - ``use_window`` (window 2: conv_in 24, out_ch 12) and ``use_fft``
      (conv_in 12) on the pixel profile: one 256x256 image (81 patches of
      128x128) in bfloat16 through ``fused_groupnorm``, and one float32
      training step each;
    - stage 1's aux models on the card against the CPU
      (:func:`aux_parity`), and one full-width HFRMTrainer step with the
      GAN and perceptual terms (:func:`hfrm_aux_step`).
    """
    import torch

    from wavedm_tpu_torch.diffusion.sampling import overlapping_grid_corners
    from wavedm_tpu_torch.inference.loader import build_restorer
    from wavedm_tpu_torch.models.unet import conv_in_channels

    t_phase = time.perf_counter()
    counts = {}
    switch_parity()
    new = wavelet_grad_rows()
    images = synthetic_images(SEED)

    def patches(cfg, h, w):
        return len(overlapping_grid_corners(h, w, cfg.data.image_size,
                                            cfg.sampling.grid_r))

    # ---- wavelet_in_unet: B = 2, bfloat16 and float32, and training
    per_call = {"wavelet_dec": 2, "wavelet_rec": 1}
    outs = {}
    for route, dtype in (("fused_groupnorm", "bfloat16"),
                         ("fused_resblock", "float32")):
        cfg = variant_cfg("reference", parallel__compute_dtype=dtype,
                          **{f"parallel__{route}": True}, **WAVELET_IN_UNET)
        k = N_IMAGES * patches(cfg, HEIGHT, WIDTH)
        rest = build_restorer(cfg, None, device=DEV)
        assert rest.hfrm is None
        n_params = sum(p.numel() for p in rest.unet.parameters())
        want = site_launches(cfg, route, VARIANT_STEPS)
        want.update({key: VARIANT_STEPS * v for key, v in per_call.items()})
        out, got, first_ms, ms, peak = variant_restore(
            f"wavelet_in_unet {route}", rest, images, want,
            int(dtype == "bfloat16"))
        del rest
        outs[dtype] = out
        counts[f"wavelet_in_unet_{dtype}"] = got
        emit("switches", path="wavelet_in_unet", route=route, dtype=dtype,
             params_unet=n_params, conv_in=conv_in_channels(cfg),
             images=N_IMAGES,
             patches=k, steps=VARIANT_STEPS, launches=got,
             first_ms_per_image=first_ms / N_IMAGES,
             ms_per_image=ms, peak_bytes=peak)
    emit("switches", path="wavelet_in_unet", bf16_vs_f32=float(
        (outs["bfloat16"] - outs["float32"]).abs().max()))
    del outs
    counts["wavelet_in_unet_train"] = variant_train(
        "wavelet_in_unet", variant_cfg(
            "reference", parallel__fused_resblock=True,
            training__patch_n=SWITCH_CROPS, **WAVELET_IN_UNET),
        phase="switches", steps=1,
        wavelet=dict(per_call, wavelet_rec_backward=1))

    # ---- use_window and use_fft on the pixel profile
    y0, x0 = (HEIGHT - SWITCH_SIDE) // 2, (WIDTH - SWITCH_SIDE) // 2
    small = images[:1, y0:y0 + SWITCH_SIDE, x0:x0 + SWITCH_SIDE]
    gen = torch.Generator(device=DEV).manual_seed(SEED + 8)
    for name, changes in (("use_window", WINDOW), ("use_fft", FFT)):
        cfg = variant_cfg("pixel", parallel__compute_dtype="bfloat16",
                          parallel__fused_groupnorm=True, **changes)
        k = patches(cfg, SWITCH_SIDE, SWITCH_SIDE)
        sites = gn_sites(cfg, k)
        for swish in (True, False):
            gn_row(gen, sites, k, torch.bfloat16, "bf16", swish, "switches",
                   timed=False)
        rest = build_restorer(cfg, None, device=DEV)
        n_params = sum(p.numel() for p in rest.unet.parameters())
        out, got, first_ms, ms, peak = variant_restore(
            name, rest, small, site_launches(cfg, "fused_groupnorm",
                                             VARIANT_STEPS))
        del rest
        counts[name] = got
        emit("switches", path=name, route="fused_groupnorm",
             dtype="bfloat16", params_unet=n_params,
             conv_in=conv_in_channels(cfg),
             image=[SWITCH_SIDE, SWITCH_SIDE], patches=k,
             steps=VARIANT_STEPS, launches=got, first_ms_per_image=first_ms,
             ms_per_image=ms, peak_bytes=peak)
        tcfg = variant_cfg("pixel", parallel__fused_resblock=True,
                           training__patch_n=SWITCH_CROPS, **changes)
        fused_row(torch.Generator(device=DEV).manual_seed(SEED + 9), tcfg,
                  SWITCH_CROPS, torch.float32, "f32", "switches",
                  timed=False)
        counts[f"{name}_train"] = variant_train(name, tcfg,
                                                phase="switches", steps=1)

    # ---- stage 1's aux models and terms
    hfrm_aux_step()
    aux_parity()

    runs = {"wavelet_dec@wavelet_in_unet": "wavelet_in_unet_bfloat16",
            "wavelet_rec@wavelet_in_unet": "wavelet_in_unet_bfloat16",
            "wavelet_rec_backward@wavelet_in_unet_train":
                "wavelet_in_unet_train"}
    for name, row in new.items():
        launches[name] = counts[runs[name]].get(name.split("@")[0], 0)
        assert launches[name] > 0, f"kernel {name} never ran on its path"
        rows[name] = row
        emit("switches", kernel=name, launches=launches[name], per="call",
             **{k: v for k, v in row.items() if k not in ("source",
                                                          "replaces")})
    emit("switches", seconds=time.perf_counter() - t_phase)


MULTIGPU_DEADLINE = 900.0   # seconds each world may live, the wait included
BUILD_DIR = os.path.join(ROOT, "wavedm_tpu_torch", "_build")
WORLDS = {}                 # the multigpu phase's worlds, once started
CHILDREN = []               # other processes the script starts


def _gate(name):
    return os.path.join(BUILD_DIR, f"multigpu_{name}.gate")


def start_multigpu():
    """Start the multigpu phase's two worlds (``parallel/dryrun.py``):
    world 1 over NCCL, as torchrun starts it (env rendezvous on
    127.0.0.1, the card's lock at a path of its own, since this process
    may hold the default one), and world 2 over gloo with both ranks on
    the card (NCCL refuses two ranks on one device).  They start before
    the card phase: their start-up (imports, the group, the card's
    context) and their tiny phases run beside nvcc's build and
    ``small_parity``, which time nothing.  Their tiny phases wait for
    :func:`open_gates` ``(".build")``, once this process has built the
    kernel library; :func:`await_multigpu` holds the timed phases until
    they are done, and each world then waits at its gate until
    :func:`multigpu_phase` opens it, so its flagship phases run alone."""
    from wavedm_tpu_torch.parallel.dryrun import start_dryrun

    os.makedirs(BUILD_DIR, exist_ok=True)
    for name in ("nccl_world1", "gloo_world2"):
        for path in [_gate(name), f"{_gate(name)}.build"] + [
                f"{_gate(name)}.ready{r}" for r in range(2)]:
            if os.path.exists(path):
                os.remove(path)
    WORLDS["nccl_world1"] = start_dryrun(
        1, "cuda", "nccl", full=True, lock=True, rendezvous="env",
        gate=_gate("nccl_world1"), deadline=MULTIGPU_DEADLINE,
        env={"WAVEDM_GPU_LOCK": os.path.join(BUILD_DIR, "multigpu.lock")})
    WORLDS["gloo_world2"] = start_dryrun(
        2, "cuda:0", "gloo", full=True, gate=_gate("gloo_world2"),
        deadline=MULTIGPU_DEADLINE)


def open_gates(suffix=""):
    """Open the gate ``<gate><suffix>`` of every started world."""
    for name in WORLDS:
        with open(_gate(name) + suffix, "w") as f:
            f.write("open\n")


def await_multigpu(timeout_s=300.0):
    """Wait until every rank of :func:`start_multigpu` has done its tiny
    phases (or one has ended: :func:`multigpu_phase` reports it); returns
    the seconds waited."""
    t = time.perf_counter()
    while time.perf_counter() - t < timeout_s:
        pending = [w for name, w in WORLDS.items()
                   for r, p in enumerate(w.procs)
                   if p.poll() is None
                   and not os.path.exists(f"{_gate(name)}.ready{r}")]
        if not pending:
            break
        time.sleep(0.05)
    return time.perf_counter() - t


def multigpu_phase(launches):
    """Open the gates of :func:`start_multigpu`'s worlds and collect them.
    Every check is the ranks' own (a failing rank fails the phase); here
    the restore() means are held to the union of the ranks' per-image
    metrics, and the launches of the runs that went through DDP, FSDP2
    and the sharded chain join the kernel table's counts."""
    import numpy as np

    t = time.perf_counter()
    open_gates()
    for name, world in WORLDS.items():
        reports = world.join()
        # every phase ran on every rank, FSDP2's included: a missing check
        # fails here, not only a failing one
        for r in reports:
            ph = r["phases"]
            assert ph["tiny_train_step"]["sharded_leaves"] > 0, (name, ph)
            assert ph["flagship_fsdp_placement"]["params"] == 156_492_675
        checks = reports[0]["phases"]["flagship_steps"]["checks"]
        gates = ["f32_ddp_vs_one_process", "f32_fsdp_vs_ddp"] + (
            ["bf16_ddp_vs_one_process", "bf16_fsdp_vs_ddp"]
            if len(reports) == 1 else [])
        assert all(checks.get(k, 2.0) <= 1.0 for k in gates), (name, checks)
        if len(reports) == 1:
            world1 = checks
        else:
            # the bfloat16 step over ranks: its loss within world 1's
            # bf16-vs-f32 loss gap of world 1's loss (one global batch)
            gap = abs(world1["bf16_ref_loss"] - world1["f32_ref_loss"])
            checks["bf16_ddp_loss_err"] = err = abs(
                checks["bf16_ddp_loss"] - world1["bf16_ref_loss"])
            checks["bf16_vs_f32_loss_gap"] = gap
            assert err <= gap, (name, err, gap)
        done = reports[0]["phases"]["flagship_restore"]["checks"]
        assert done["f32_max_abs_err"] <= 1e-3, (name, done)
        assert done["bf16_max_abs_err"] <= done["bf16_vs_f32_gap"], done
        ranks_launches = dict.fromkeys(read_counts(), 0)
        for r in reports:
            for phase in ("flagship_steps", "flagship_restore"):
                for counts in r["phases"][phase]["launches"].values():
                    for key, val in counts.items():
                        ranks_launches[key] = ranks_launches.get(key, 0) + val
        for key in launches:
            launches[key] += ranks_launches.get(key, 0)
        # restore(): every rank reports the means over all ranks' images
        res = [r["phases"]["flagship_restore"]["checks"] for r in reports]
        scores = [s for c in res for s in c["scores"]]
        union = np.mean([s[1:] for s in scores], axis=0)
        for c in res:
            got = [c["restore"][k] for k in ("psnr_torch", "psnr_y",
                                             "psnr_np_y", "ssim")]
            assert c["restore"]["n_images"] == 2, c["restore"]
            assert np.allclose(got, union, rtol=0, atol=1e-12), (got, union)
        want = ["fused_gn_swish_conv_f32", "fused_gn_swish_conv_bf16",
                "wavelet_dec", "wavelet_rec", "group_norm_f32_swish",
                "group_norm_bf16_swish"]
        assert all(ranks_launches[k] > 0 for k in want), ranks_launches
        r0 = reports[0]
        emit("multigpu", world=name, backend=r0["backend"],
             ranks=[r["device"] for r in reports],
             seconds=[r["s"] for r in reports],
             phase_seconds={k: v["s"] for k, v in r0["phases"].items()},
             collectives=r0["collectives"],
             tiny=r0["phases"]["tiny_train_step"],
             sampler=r0["phases"]["sharded_sampler"],
             placement=r0["phases"]["flagship_fsdp_placement"],
             steps=r0["phases"]["flagship_steps"]["checks"],
             restore={k: v for k, v in res[0].items() if k != "scores"},
             restore_union=union.tolist(),
             tiny_seconds=[r["tiny_s"] for r in reports],
             peak_bytes=[r.get("peak_bytes") for r in reports],
             launches={k: v for k, v in ranks_launches.items() if v})
    emit("multigpu", seconds=time.perf_counter() - t)


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
    versions, timed; the DWT/IWT also at 1 and 8 images and on the
    ``wavelet_in_unet`` slice), ``restore`` (the production restore through
    ``fused_groupnorm``: a first run, then five timed runs), ``sweep``
    (the GroupNorm kernel under each launch plan, :func:`gn_sweep`), the
    training phases ``train``, ``train_data``, ``train_hfrm`` and
    ``pipeline``, ``tools`` (after ``pipeline``, whose checkpoints it
    reads; the training MFU only after ``train``, whose ms/step it takes),
    ``serve``, ``variants``, ``switches`` and ``multigpu``
    (``profiling`` runs alone: see :func:`main`)."""
    if "sweep" in phases:
        gn_sweep(ref_cfg, N_IMAGES * 45)
    if "kernels" in phases:
        rows = check_kernels(ref_cfg, N_IMAGES * 45)
        rows.update(wavelet_sizes())
        for name, row in rows.items():
            emit("kernels", kernel=name, per="call (wavelet) or UNet "
                 "forward at N = 90 (GroupNorm)", **row)
    scratch = dict.fromkeys(read_counts(), 0)
    step_ms = train_phase(scratch) if "train" in phases else None
    if "train_data" in phases:
        train_data_phase(scratch)
    if "train_hfrm" in phases:
        train_hfrm_phase()
    if "pipeline" in phases or "tools" in phases:
        unet_ckpt, hfrm_ckpt, root = pipeline_phase(scratch,
                                                    keep="tools" in phases)
        if "tools" in phases:
            tools_phase(scratch, unet_ckpt, hfrm_ckpt, step_ms)
            shutil.rmtree(root, ignore_errors=True)
    if "serve" in phases:
        serve_phase(scratch, {})
    if "variants" in phases:
        variants_phase(scratch, {})
    if "switches" in phases:
        switches_phase(scratch, {})
    if "multigpu" in phases:
        start_multigpu()
        open_gates(".build")
        multigpu_phase(scratch)
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
    ap.add_argument("--gate", help=argparse.SUPPRESS)    # profiling child
    ap.add_argument("--phases", help="comma-separated subset of "
                    "kernels,restore,sweep,train,train_data,train_hfrm,"
                    "pipeline,"
                    "tools,serve,variants,switches,multigpu to run alone, "
                    "or profiling by itself; no final lines")
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
    if args.phases == "profiling":      # alone: no census, no data library
        if args.gate:                   # the parent's build is done
            t = time.perf_counter()
            while not os.path.exists(args.gate):
                assert time.perf_counter() - t < 300, "no build gate"
                time.sleep(0.05)
        _build.library()
        profiling_phase()
        return 0
    from concurrent.futures import ThreadPoolExecutor

    from wavedm_tpu_torch.native import build as native_build

    # nvcc's processes, and the host compiler's build of the data library,
    # run beside the start-up below
    pool = ThreadPoolExecutor(2)
    built = pool.submit(_build.build)
    native = pool.submit(native_build.status)
    pool.shutdown(wait=False)
    from wavedm_tpu_torch.config import production_profile, reference_profile
    from wavedm_tpu_torch.inference.loader import build_hfrm, build_restorer

    if not args.phases:
        start_multigpu()
        # torch.profiler leaves each later launch of its process dearer on
        # the host: the profiling phase runs in a child process, started
        # now (its start-up beside nvcc), profiling once the build's gate
        # opens, beside small_parity; done before the first timed phase
        gate = os.path.join(BUILD_DIR, "profiling.gate")
        if os.path.exists(gate):
            os.remove(gate)
        profiler = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--phases",
             "profiling", "--gate", gate]
            + (["--tree", args.tree] if args.tree else []),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        CHILDREN.append(profiler)
    from wavedm_tpu_torch.tools.roofline import card_line

    smi = card_line("cuda")             # nvidia-smi's name, power limit
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("card", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, tf32=False,
         package=os.path.dirname(_build.CSRC_DIR))

    # a UNet's first forward on the meta device (the norm sites' census)
    # costs seconds of one-time set-up: paid here, while nvcc runs
    gn_sites(reference_profile(), N_IMAGES * 45)
    t = time.perf_counter()
    built.result()
    _build.library()
    open_gates(".build")
    if not args.phases:
        with open(gate, "w") as f:
            f.write("open\n")
    emit("build", waited_s=time.perf_counter() - t,
         nvcc_seconds=_build.last_build_seconds, library=_build.LIB_PATH,
         ptxas=ptxas_report(_build.last_ptxas))
    pil, decoders = image_decoders()
    emit("native", **native_phase(native.result()), pil=pil,
         decoders=decoders)

    ref_cfg = reference_profile()
    ref_cfg.sampling.sampling_timesteps = REF_STEPS
    prod_cfg = production_profile()
    for cfg in (ref_cfg, prod_cfg):
        cfg.parallel.fused_groupnorm = True
    if args.phases:
        return partial(set(args.phases.split(",")), ref_cfg, prod_cfg)
    # checks alone, no timing: it may run beside the multigpu worlds'
    # start-up and the profiling child; the timed phases wait for them
    small_parity()
    t = time.perf_counter()
    out, err = profiler.communicate(timeout=300)
    lines = [json.loads(line) for line in out.splitlines()
             if line.startswith('{"phase": "profiling"')]
    assert profiler.returncode == 0 and lines, err[-3000:]
    waited_s = time.perf_counter() - t
    for line in lines:
        emit("profiling", process="child", child_s=line["s"],
             **{k: v for k, v in line.items() if k not in ("phase", "s")})
    emit("profiling", process="child", waited_s=waited_s)
    emit("multigpu", part="start-up and tiny phases beside the build and "
         "small_parity", waited_s=await_multigpu())
    k_per_image = 45
    rows = check_kernels(ref_cfg, N_IMAGES * k_per_image)
    # the 1-image rows' launches: the serve phase's batch-1 restore
    rows.update(wavelet_rows(torch.Generator(device="cuda").manual_seed(
        SEED + 11), 1, "kernels", "@1_image"))
    rows.update(check_fused_kernels(ref_cfg))
    check_whole_image_kernels(prod_cfg)

    images = synthetic_images(SEED)
    launches = dict.fromkeys(rows, 0)
    outs = {}
    for name, cfg in (("reference", ref_cfg), ("production", prod_cfg)):
        rest = build_restorer(cfg, None, None, device="cuda")
        n_unet = sum(p.numel() for p in rest.unet.parameters())
        n_hfrm = sum(p.numel() for p in rest.hfrm.parameters())
        assert (n_unet, n_hfrm) == (156_492_675, 15_941_667), (n_unet, n_hfrm)
        steps = len(rest.seq)
        tag = "f32" if cfg.parallel.compute_dtype == "float32" else "bf16"
        want = {f"group_norm_{tag}_swish": 45 * steps,
                f"group_norm_{tag}": 6 * steps,
                "wavelet_dec": 2, "wavelet_rec": 1}
        out, first_ms, got = counted_restore(rest, images, want, name,
                                             launches)
        peak = torch.cuda.max_memory_allocated()
        # the reference profile's float32 runs take seconds: its counted
        # run is its time
        steady_ms = (first_ms if name == "reference"
                     else restore_timed(rest, images)[2])
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
    want = {"fused_gn_swish_conv_bf16": 44 * len(fr_rest.seq),
            "wavelet_dec": 2, "wavelet_rec": 1}
    fr_out, fr_first_ms, got = counted_restore(
        fr_rest, images, want, "restore_fused_resblock", launches)
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
    sampler_phase(images, unet_sd, hfrm_sd, bf16_gap, launches)
    del unet_sd
    torch.cuda.empty_cache()
    eval_phase(launches)
    serve_phase(launches, rows)
    variants_phase(launches, rows)
    switches_phase(launches, rows)

    # the reference profile (float32, TF32 off, REF_STEPS from noise) with
    # the fused kernel at all 44 pairs, against the reference restore with
    # fused_groupnorm + cuDNN: the same weights (one seed draws one network
    # in either dtype), inputs and noise.  Float32 on both sides, so they
    # part by summation order only: held to 1e-3 absolute on images in
    # [0, 1] (5.6e-5 measured on the H100 over 25 steps), far below the
    # 0.37 that this profile's bfloat16 run parts from its float32 one.
    ref_out, ref_ms = outs["reference"]
    fr_ref_cfg = reference_profile()
    fr_ref_cfg.sampling.sampling_timesteps = REF_STEPS
    fr_ref_cfg.parallel.fused_resblock = True
    fr_ref_cfg.validate()
    fr_ref = build_restorer(fr_ref_cfg, None, None, device="cuda")
    want = {"fused_gn_swish_conv_f32": 44 * len(fr_ref.seq),
            "wavelet_dec": 2, "wavelet_rec": 1}
    fr_ref_out, fr_ref_first_ms, got = counted_restore(
        fr_ref, images, want, "restore_fused_resblock reference", launches)
    fr_ref_ms = fr_ref_first_ms         # seconds a run: its counted run
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

    step_ms = train_phase(launches)

    # both stages on real pairs, then chained as a user runs them
    train_data_phase(launches)
    train_hfrm_phase()
    unet_ckpt, hfrm_ckpt, root = pipeline_phase(launches, keep=True)
    tools_phase(launches, unet_ckpt, hfrm_ckpt, step_ms)
    for path in (root, os.path.join(ROOT, "wavedm_tpu_torch", "_build",
                                    "smoke_data")):
        shutil.rmtree(path, ignore_errors=True)
    multigpu_phase(launches)

    for key, val in launches.items():
        assert val > 0, f"kernel {key} never ran on the main path"
    kernels = [dict(name=key, route="cuda", source=row["source"],
                    replaces=row["replaces"], launches=launches[key],
                    max_abs_err=row["max_abs_err"], ms=row["ms"],
                    device_ms=row["device_ms"], host_ms=row.get("host_ms"),
                    host_median_ms=row.get("host_median_ms"),
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
    try:
        rc = main()
    finally:
        for world in WORLDS.values():     # none outlives the script
            world.close()
        for child in CHILDREN:
            if child.poll() is None:
                child.kill()
                child.wait()
    sys.exit(rc)
