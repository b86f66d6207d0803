"""Stage-2 training fed by the port's native crop stream: the program's
train step (``make_train_step``), as ``runners/train.py`` drives it, on the
batches ``RainDrop.train_batches`` decodes and cuts from image files while
the card trains (``data/raindrop.py``, the data library's crop stream
behind its prefetch thread).

Set-up makes the split: ``pairs`` PNG pairs in ``input/`` and ``gt/`` of
a fresh folder under ``portbench/_cache``, pair i a symbolic link to pair
i mod n of the workload's ``images`` (its n pairs, which must be there),
so the stream decodes real photos as stored, in an epoch of ``pairs``,
and nothing is written back to disk during the window (copies would be);
the folder is removed when the run ends.  The stream reads
``training.batch_size`` pairs a step, ``patch_n`` crops of ``patch_size``
pixels from each, epoch after epoch; the epoch order and the crop
positions come from the run's seed (``training.seed`` set from it).  t
and noise are ``slots`` seeded sets, as ``runners/train.py`` draws them.
Steps 1 to 3 take the stream's first three batches and are the warm-up;
their losses, first gradients, changes and EMA changes are kept, as
``runners/train.py`` keeps them.  The window runs from step 4, each step
taking the stream's next batch, reading the loss to the host every 10
steps, and closes on such a read.  The host's wait for the stream in the
window is printed on standard error.

After the window the program is freed and the float32 reference trains
the same three steps from the same weights, on the crops the stream gave,
with the same timesteps and noise (``train_gaps``).  Those crops are
checked too: each has to be a window of its pair as the benchmark's own
PNG reader (``lib/images.py``) decodes the source files (``crop_gap``, the
largest difference of a crop from its closest window; 1 where no window
of any pair has the crop's first and last pixels).  The record is the
training runner's, under its kind (``lib/record.py``).
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from portbench import registry
from portbench.lib import flops, session
from portbench.lib.compare import train_gaps
from portbench.lib.images import load_images
from portbench.lib.record import Record
from portbench.lib.weights import generator, reference, seeded, sub_seed
from portbench.reference.precision import Prec
from portbench.reference.train import run_steps
from portbench.runners.train import CHECKED_STEPS, LOG_EVERY
from wavedm_tpu_torch.config import config_from_dict
from wavedm_tpu_torch.data.raindrop import RainDrop
from wavedm_tpu_torch.inference.loader import build_hfrm, build_unet
from wavedm_tpu_torch.training.state import create_train_state
from wavedm_tpu_torch.training.train_step import make_train_step


class _Split(RainDrop):
    """The RainDrop reader with its training split at ``folder``."""

    def __init__(self, cfg, folder: str):
        super().__init__(cfg)
        self.folder = folder

    def train_dir(self) -> str:
        return self.folder


def source_pairs(src: str):
    """The paths of ``src``'s pairs: ``input/`` in name order, each with
    the file of its name in ``gt/``."""
    names = sorted(os.listdir(os.path.join(src, "input")))
    return ([os.path.join(src, "input", n) for n in names],
            [os.path.join(src, "gt", n) for n in names])


def link_pairs(wl: dict) -> str:
    """A fresh folder of ``pairs`` PNG pairs, pair i a link to pair i mod
    n of the workload's ``images``; raises where that folder has no
    ``input/``."""
    src = os.path.join(registry.REPO, wl["images"])
    if not os.path.isdir(os.path.join(src, "input")):
        raise FileNotFoundError(f"train_stream: {wl['images']} has no "
                                f"input/ folder")
    inputs, gts = source_pairs(src)
    cache = os.path.join(registry.ROOT, "_cache")
    os.makedirs(cache, exist_ok=True)
    dest = tempfile.mkdtemp(prefix="stream-", dir=cache)
    for sub in ("input", "gt"):
        os.makedirs(os.path.join(dest, sub))
    for i in range(wl["pairs"]):
        j = i % len(inputs)
        for sub, path in (("input", inputs[j]), ("gt", gts[j])):
            os.symlink(os.path.abspath(path),
                       os.path.join(dest, sub, f"{i:04d}.png"))
    return dest


def stream(ctx, split: str):
    """The native crop stream over epochs 0, 1, ... of ``split``:
    (batch, P, P, 6) float32 host arrays in [0, 1]."""
    raw = json.loads(json.dumps(ctx.raw))
    raw["training"]["seed"] = sub_seed(ctx.seed, "stream") % 2 ** 31
    data = _Split(config_from_dict(raw), split)
    return itertools.chain.from_iterable(
        data.train_batches(epoch, use_native=True)
        for epoch in itertools.count())


def crop_gap(crops: np.ndarray, pairs: np.ndarray) -> float:
    """The largest gap of a crop (N, P, P, 6) from its closest window of
    the decoded pairs ((pairs, H, W, 6) uint8), in [0, 1] units."""
    p = crops.shape[1]
    worst = 0.0
    for crop in crops:
        ends = np.rint(crop[[0, -1], [0, -1]] * 255.0).astype(np.uint8)
        best = 1.0
        for pair in pairs:
            h, w = pair.shape[0] - p + 1, pair.shape[1] - p + 1
            at = ((pair[:h, :w] == ends[0]).all(-1)
                  & (pair[p - 1:, p - 1:] == ends[1]).all(-1))
            for y, x in np.argwhere(at):
                win = pair[y:y + p, x:x + p].astype(np.float64) / 255.0
                best = min(best, float(np.abs(crop - win).max()))
        worst = max(worst, best)
    return worst


def slots(ctx):
    """The slots' t (slots, batch) and noise (slots, batch, 3, P/4, P/4),
    on the device, drawn as ``runners/train.py`` draws them."""
    wl, raw, dev = ctx.workload, ctx.raw, ctx.device
    size, b = raw["data"]["patch_size"], wl["batch"]
    gen = generator(ctx.seed, "steps", dev)
    ts = torch.randint(0, raw["diffusion"]["num_diffusion_timesteps"],
                       (wl["slots"], b), generator=gen, device=dev)
    es = torch.randn((wl["slots"], b, raw["model"]["pred_channels"],
                      size // 4, size // 4), generator=gen, device=dev)
    return ts, es


def run(ctx) -> dict:
    split = link_pairs(ctx.workload)
    try:
        return _run(ctx, split)
    finally:
        shutil.rmtree(split, ignore_errors=True)


def _run(ctx, split: str) -> dict:
    dev, wl, raw = ctx.device, ctx.workload, ctx.raw
    b, n_slots = wl["batch"], wl["slots"]
    tr = raw["training"]
    if b != tr["batch_size"] * tr["patch_n"]:
        raise ValueError("batch must be training.batch_size x patch_n")
    batches = stream(ctx, split)
    ts, es = slots(ctx)
    with_hfrm = not raw["model"]["use_gt_in_train"]
    sd_u, sd_h = seeded(raw, ctx.seed, dev, with_hfrm)
    model = build_unet(ctx.cfg, sd_u, dev, train=True)
    hfrm = build_hfrm(ctx.cfg, sd_h, dev) if with_hfrm else None
    state = create_train_state(model, ctx.cfg.optim, ctx.seed)
    step = make_train_step(ctx.cfg, model, hfrm)

    def call(k: int, batch):
        return step(state, batch, t=ts[k % n_slots], e=es[k % n_slots])

    rows = [torch.as_tensor(next(batches), device=dev)
            for _ in range(CHECKED_STEPS)]
    named = list(model.named_parameters())
    beta1 = ctx.cfg.optim.beta1
    losses = [call(0, rows[0]).loss]
    moments = [state.optimizer.state[p].get("exp_avg", torch.zeros(()))
               for _, p in named]
    grad = torch.stack([m.norm().to(dev) for m in moments]) / (1.0 - beta1)
    losses += [call(k, rows[k]).loss for k in range(1, CHECKED_STEPS)]
    change = torch.stack([(p.detach() - sd_u[n]).norm() for n, p in named])
    prog = dict(loss=torch.stack(losses).tolist(),
                grad=dict(zip((n for n, _ in named), grad.tolist())),
                change=dict(zip((n for n, _ in named), change.tolist())))
    if raw["model"]["ema"]:
        ema = torch.stack([(state.ema[n].double() - sd_u[n].double()).norm()
                           for n, _ in named])
        prog["ema"] = dict(zip((n for n, _ in named), ema.tolist()))
    del sd_u, sd_h, moments

    session.sync(dev)
    session.reset_peak(dev)
    k, host_s, wait_s = CHECKED_STEPS, [], 0.0
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    while True:
        tw = time.perf_counter()
        batch = next(batches)
        ts0 = time.perf_counter()
        wait_s += ts0 - tw
        out = call(k, batch)
        if (k - CHECKED_STEPS) % LOG_EVERY == 0:
            host_s.append(time.perf_counter() - ts0)
        k += 1
        if (k - CHECKED_STEPS) % LOG_EVERY == 0:
            float(out.loss)
            te = time.perf_counter()
            if te - t0 >= ctx.seconds:
                break
    window_s, steps = te - t0, k - CHECKED_STEPS
    print(f"train_stream: the stream kept the host waiting "
          f"{1e3 * wait_s / steps:.3f} ms a step ({steps} steps)",
          file=sys.stderr)
    peak = session.peak_bytes(dev)
    traced = None
    if ctx.trace:
        def traced_step(i: int, spans: session.Spans) -> None:
            with spans("data"):
                batch = next(batches)
            with spans("train_step"):
                m = call(k + i, batch)
            if (i + 1) % LOG_EVERY == 0:
                with spans("log_read"):
                    float(m.loss)

        traced = session.profile(dev, traced_step, wl["trace_steps"])
    del model, hfrm, state, step, out, named
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    work = flops.train_step(raw, b, raw["data"]["patch_size"])
    unet, hfrm = reference(raw, ctx.seed, dev, with_hfrm)
    ref = run_steps(raw, unet, hfrm, rows, list(ts[:CHECKED_STEPS]),
                    list(es[:CHECKED_STEPS]), Prec())
    record = Record("train", setup_s=setup_s, window_s=window_s,
                    n_calls=steps, items=b * steps, host_s=host_s,
                    work_per_call=work["total"], conv_per_call=work["conv"],
                    peak_mem_bytes=peak, trace=traced)
    numbers, where = train_gaps(prog, ref)
    inputs, gts = source_pairs(os.path.join(registry.REPO, wl["images"]))
    decoded = np.concatenate([load_images(inputs)[..., :3],
                              load_images(gts)[..., :3]], axis=-1)
    numbers["crop_gap"] = crop_gap(torch.cat(rows).cpu().numpy(), decoded)
    return dict(record=record, numbers=numbers, where=where,
                attempted=steps, failed=0)
