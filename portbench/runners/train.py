"""Stage-2 training: the program's train step (``make_train_step``, the
step ``DiffusionTrainer`` runs) called back to back on device batches.

Set-up makes, from the seed, on the device: the UNet's (and, where the
configuration conditions on it, the frozen HFRM's) weights, a pool of
``pool`` crops of ``patch_size`` pixels cut from the workload's
[degraded | clean] pairs at seeded positions, and ``slots`` sets of
timesteps and noise.  It builds the program's model, train state and step
once; steps 1 to 3 go through that step on rows 0 .. 3 ``batch`` - 1 of
the pool, and are the warm-up.  Their losses, each parameter's first
gradient (Adam's first moment after step 1, over 1 - beta1), each
parameter's change after step 3 and, where the configuration keeps an
EMA, the change of each parameter's EMA shadow after step 3 (in float64)
are kept.  Step k takes the pool's rows
from k ``batch`` (mod ``pool``) and slot k mod ``slots``.  The window runs
from step 4, reading the loss to the host every 10 steps as the trainer's
log does, and closes on such a read.

After the window the program is freed and the float32 reference trains
the same three steps from the same weights, crops, timesteps and noise
(``lib/compare.py``: ``loss_gap``, ``grad_gap``, ``change_gap``,
``ema_gap``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.lib import flops, session
from portbench.lib.compare import train_gaps
from portbench.lib.weights import generator, reference, seeded, sub_seed
from portbench.reference.precision import Prec
from portbench.reference.train import run_steps
from wavedm_tpu_torch.inference.loader import build_hfrm, build_unet
from wavedm_tpu_torch.training.state import create_train_state
from wavedm_tpu_torch.training.train_step import make_train_step

CHECKED_STEPS = 3
LOG_EVERY = 10


def _feed(ctx):
    """The crop pool (pool, P, P, 6) and the slots' t (slots, batch) and
    noise (slots, batch, 3, P/4, P/4), on the device."""
    wl, raw, dev = ctx.workload, ctx.raw, ctx.device
    size, b = raw["data"]["patch_size"], wl["batch"]
    pairs = session.load_pairs(wl, clean=True)
    n, h, w = pairs.shape[:3]
    rng = np.random.default_rng(sub_seed(ctx.seed, "crops"))
    at = zip(rng.integers(0, n, wl["pool"]),
             rng.integers(0, h - size + 1, wl["pool"]),
             rng.integers(0, w - size + 1, wl["pool"]))
    src = torch.as_tensor(pairs, device=dev)
    crops = torch.stack([src[i, y:y + size, x:x + size] for i, y, x in at])
    gen = generator(ctx.seed, "steps", dev)
    ts = torch.randint(0, raw["diffusion"]["num_diffusion_timesteps"],
                       (wl["slots"], b), generator=gen, device=dev)
    es = torch.randn((wl["slots"], b, raw["model"]["pred_channels"],
                      size // 4, size // 4), generator=gen, device=dev)
    return crops.float() / 255.0, ts, es


def run(ctx) -> dict:
    dev, wl, raw = ctx.device, ctx.workload, ctx.raw
    b, pool, slots = wl["batch"], wl["pool"], wl["slots"]
    if pool % b or pool < CHECKED_STEPS * b:
        raise ValueError("pool must hold whole batches, three at least")
    crops, ts, es = _feed(ctx)
    with_hfrm = not raw["model"]["use_gt_in_train"]
    sd_u, sd_h = seeded(raw, ctx.seed, dev, with_hfrm)
    model = build_unet(ctx.cfg, sd_u, dev, train=True)
    hfrm = build_hfrm(ctx.cfg, sd_h, dev) if with_hfrm else None
    state = create_train_state(model, ctx.cfg.optim, ctx.seed)
    step = make_train_step(ctx.cfg, model, hfrm)

    def call(k: int):
        r = (k * b) % pool
        return step(state, crops[r:r + b], t=ts[k % slots], e=es[k % slots])

    named = list(model.named_parameters())
    beta1 = ctx.cfg.optim.beta1
    losses = [call(0).loss]
    moments = [state.optimizer.state[p].get("exp_avg", torch.zeros(()))
               for _, p in named]
    grad = torch.stack([m.norm().to(dev) for m in moments]) / (1.0 - beta1)
    losses += [call(k).loss for k in range(1, CHECKED_STEPS)]
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
    k, host_s = CHECKED_STEPS, []
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    while True:
        ts0 = time.perf_counter()
        out = call(k)
        if (k - CHECKED_STEPS) % LOG_EVERY == 0:
            host_s.append(time.perf_counter() - ts0)
        k += 1
        if (k - CHECKED_STEPS) % LOG_EVERY == 0:
            float(out.loss)
            te = time.perf_counter()
            if te - t0 >= ctx.seconds:
                break
    window_s, steps = te - t0, k - CHECKED_STEPS
    peak = session.peak_bytes(dev)
    traced = None
    if ctx.trace:
        def traced_step(i: int, spans: session.Spans) -> None:
            with spans("train_step"):
                m = call(k + i)
            if (i + 1) % LOG_EVERY == 0:
                with spans("log_read"):
                    float(m.loss)

        traced = session.profile(dev, traced_step, wl["trace_steps"])
    del model, hfrm, state, step, out, named
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    work = flops.train_step(raw, b, raw["data"]["patch_size"])
    unet, hfrm = reference(raw, ctx.seed, dev, with_hfrm)
    rows = [crops[k * b:(k + 1) * b] for k in range(CHECKED_STEPS)]
    ref = run_steps(raw, unet, hfrm, rows, list(ts[:CHECKED_STEPS]),
                    list(es[:CHECKED_STEPS]), Prec())
    record = dict(setup_s=setup_s, window_s=window_s, n_calls=steps,
                  items=b * steps, host_s=host_s,
                  work_per_call=work["total"], conv_per_call=work["conv"],
                  peak_mem_bytes=peak, trace=traced)
    numbers, where = train_gaps(prog, ref)
    return dict(record=record, numbers=numbers, where=where,
                attempted=steps, failed=0)
