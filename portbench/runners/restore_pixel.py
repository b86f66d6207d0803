"""Closed-loop restoration on the pixel path: one caller, one
``restore_image_device`` call of ``batch`` images at a time, each
synchronised before the next, as ``runners/restore.py`` runs the wavelet
path.

Set-up makes, from the seed, on the device: the pixel UNet's weights
(``lib/pixel.py``; the path has no HFRM), a pool of ``pool`` call inputs
(the workload's images in seeded orders, ``batch`` a call) and their x_T
noise at the images' own size; it builds the program's restorer on them
and warms it up.  Call k of the window restores pool entry k mod
``pool``.  The outputs of the first ``check_within`` calls are kept; after
the window ``check_calls`` of them, drawn from the seed, are restored
again by the float32 pixel reference (``reference/pixel.py``) from the
same weights, images and noise, and compared: ``img_rms_gap`` is held
to its limit; ``img_max_gap`` is reported, as random weights clamp
nearly every output pixel to 0 or 1 and leave the largest gap no reading
a fault has to pass.

The record has the restore runner's fields, under its kind
(``lib/record.py``), so every restore metric reads it; the work of a call
is the pixel reference's (``lib/pixel.restore_call``).  Traced, it also
holds the chain's step counters over the traced calls
(``trace["chain_counts"]``, from the program's ``profiling.CHAIN``; None
where the program keeps no such counters).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from portbench.lib import pixel, session
from portbench.lib.compare import image_gaps
from portbench.lib.record import Record
from portbench.lib.weights import generator, sub_seed
from portbench.reference.pixel import restore
from portbench.reference.precision import Prec
from wavedm_tpu_torch.inference.loader import build_unet
from wavedm_tpu_torch.inference.restoration import DiffusiveRestoration


def chain_counts() -> Optional[Dict[str, float]]:
    """The program's chain step counters now, or None where it keeps
    none."""
    try:
        from wavedm_tpu_torch.utils.profiling import CHAIN
    except ImportError:
        return None
    with CHAIN.lock:
        return dict(CHAIN)


def _inputs(ctx, images: np.ndarray):
    """(pool, batch, H, W, 3) float32 inputs and (pool, batch, 3, H, W)
    noise, on the device."""
    wl, dev = ctx.workload, ctx.device
    pool, b = wl["pool"], wl["batch"]
    rng = np.random.default_rng(sub_seed(ctx.seed, "order"))
    n = len(images)
    stream = np.concatenate([rng.permutation(n)
                             for _ in range(-(-pool * b // n))])
    idx = torch.as_tensor(stream[:pool * b].reshape(pool, b), device=dev)
    x = torch.as_tensor(images, device=dev).float() / 255.0
    h, w = images.shape[1:3]
    pc = ctx.raw["model"]["pred_channels"]
    noise = torch.randn((pool, b, pc, h, w),
                        generator=generator(ctx.seed, "noise", dev),
                        device=dev)
    return x[idx], noise


def run(ctx) -> dict:
    dev, wl = ctx.device, ctx.workload
    pool, b = wl["pool"], wl["batch"]
    images = session.load_pairs(wl, clean=False)
    inputs, noise = _inputs(ctx, images)
    sd = pixel.seeded(ctx.raw, ctx.seed, dev)
    restorer = DiffusiveRestoration(ctx.cfg, build_unet(ctx.cfg, sd, dev),
                                    None, dev)
    del sd

    def call(k: int) -> torch.Tensor:
        return restorer.restore_image_device(inputs[k % pool],
                                             noise=noise[k % pool])[0]

    for k in range(wl["warmup"]):
        call(k)
    session.sync(dev)
    session.reset_peak(dev)
    kept, call_s, host_s = {}, [], []
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    while True:
        k = len(call_s)
        ts = time.perf_counter()
        out = call(k)
        th = time.perf_counter()
        session.sync(dev)
        te = time.perf_counter()
        call_s.append(te - ts)
        host_s.append(th - ts)
        if k < wl["check_within"]:
            kept[k] = out
        if te - t0 >= ctx.seconds:
            break
    window_s = te - t0
    peak = session.peak_bytes(dev)
    traced = None
    if ctx.trace:
        def traced_call(i: int, spans: session.Spans) -> None:
            with spans("restore_call"):
                call(len(call_s) + i)
            with spans("sync"):
                session.sync(dev)

        before = chain_counts()
        traced = session.profile(dev, traced_call, wl["trace_calls"])
        after = chain_counts()
        traced["chain_counts"] = (None if before is None else
                                  {k: after[k] - before[k] for k in after})
    del restorer, out
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    h, w = images.shape[1:3]
    work = pixel.restore_call(ctx.raw, b, h, w)
    rng = np.random.default_rng(sub_seed(ctx.seed, "check"))
    sample = sorted(rng.choice(len(kept), min(wl["check_calls"], len(kept)),
                               replace=False).tolist())
    unet = pixel.reference(ctx.raw, ctx.seed, dev)
    ref = restore(ctx.raw, unet,
                  torch.cat([inputs[k % pool] for k in sample])
                  .permute(0, 3, 1, 2),
                  torch.cat([noise[k % pool] for k in sample]), Prec(),
                  wl["reference_chunk"])
    prog = torch.cat([kept[k] for k in sample]).permute(0, 3, 1, 2)
    numbers = image_gaps(prog, ref)
    record = Record("restore", setup_s=setup_s, window_s=window_s,
                    n_calls=len(call_s), items=b * len(call_s),
                    call_s=call_s, host_s=host_s,
                    work_per_call=work["total"], conv_per_call=work["conv"],
                    peak_mem_bytes=peak, trace=traced)
    return dict(record=record, numbers=numbers,
                attempted=b * len(call_s), failed=0)
