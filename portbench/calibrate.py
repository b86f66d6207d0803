"""The readings that a cell's correctness limits are set from.

  python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
      [--control-seeds 4,5,6] [--seconds 0.5]

For each of ``--seeds``, one whole run of the cell (``harness.run_cell``,
a short window) in this process, and its compared numbers: the program's
readings.  For each of ``--control-seeds``, the cell's inputs and weights
as a run with that seed makes them, restored or trained by the reference
in the configuration's precision and by the control (the reference one
precision lower, the configuration file's ``precision.control``), and the
same numbers of the control against the reference; for a training cell
also the fault of half the batch left out (the loss the mean over the
other half), read the same way, and how far the reference's EMA moved
each leaf, in float32 spacings of the leaf (``ema_spacings``).  One JSON
line each, on standard output.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import torch  # noqa: E402

from portbench import registry  # noqa: E402
from portbench.harness import make_ctx, run_cell  # noqa: E402
from portbench.lib.compare import (EMA_SPACINGS, FLOAT32_SPACING,  # noqa: E402
                                   SILENT_GRAD, image_gaps, train_gaps)
from portbench.lib.session import load_pairs  # noqa: E402
from portbench.lib.weights import reference  # noqa: E402
from portbench.reference.precision import Prec, float32_matmuls  # noqa: E402
from portbench.reference.sampler import restore  # noqa: E402
from portbench.reference.train import run_steps  # noqa: E402


def _in_precision(kind: str, fn):
    """``fn(Prec(kind))`` with TF32 on for the ``tf32`` control."""
    float32_matmuls(kind == "tf32")
    try:
        return fn(Prec(kind))
    finally:
        float32_matmuls(False)


def restore_control(ctx, control: str) -> dict:
    wl = ctx.workload
    inputs, noise = registry.runner("restore")._inputs(
        ctx, load_pairs(wl, clean=False))
    n = wl["check_calls"]
    imgs = inputs[:n].flatten(0, 1).permute(0, 3, 1, 2)
    z = noise[:n].flatten(0, 1)
    unet, hfrm = reference(ctx.raw, ctx.seed, ctx.device, True)

    def run(prec):
        return restore(ctx.raw, unet, hfrm, imgs, z, prec,
                       wl["reference_chunk"])

    ref = _in_precision("float32", run)
    return {"control": image_gaps(_in_precision(control, run), ref)}


def train_control(ctx, control: str) -> dict:
    runner = registry.runner("train")
    raw, b = ctx.raw, ctx.workload["batch"]
    crops, ts, es = runner._feed(ctx)
    with_hfrm = not raw["model"]["use_gt_in_train"]
    steps = runner.CHECKED_STEPS
    rows = [crops[k * b:(k + 1) * b] for k in range(steps)]

    def run(prec, half=False):
        unet, hfrm = reference(raw, ctx.seed, ctx.device, with_hfrm)
        keep = b // 2 if half else b
        return run_steps(raw, unet, hfrm, [r[:keep] for r in rows],
                         [t[:keep] for t in ts[:steps]],
                         [e[:keep] for e in es[:steps]], prec)

    ref = _in_precision("float32", run)
    out = {"control": train_gaps(_in_precision(control, run), ref)[0],
           "half_batch": train_gaps(
               _in_precision("float32", lambda p: run(p, True)), ref)[0]}
    if "ema" in ref:
        # each moving leaf's reference EMA change in float32 spacings of
        # the leaf
        floor = statistics.median(ref["grad"].values()) * SILENT_GRAD
        moved = sorted(ref["ema"][k] / (FLOAT32_SPACING * ref["norm"][k])
                       for k in ref["ema"] if ref["grad"][k] >= floor)
        out["ema_spacings"] = dict(
            leaves=len(moved), held=sum(m >= EMA_SPACINGS for m in moved),
            quartiles=statistics.quantiles(moved, n=4))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=0.5)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in seeds:
        t0 = time.perf_counter()
        r = run_cell(args.workload, seed, args.seconds, False, dev, t0)
        print(json.dumps({"cell": args.workload, "seed": seed,
                          "program": {k: v["value"] for k, v in
                                      r["checked"].items()},
                          "where": r["where"],
                          "metrics": {k: v["value"] for k, v in
                                      r["metrics"].items()},
                          "s": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    for seed in controls:
        t0 = time.perf_counter()
        ctx = make_ctx(args.workload, seed, 0.0, False, dev, t0)
        control = ctx.config_file["precision"]["control"]
        fn = (restore_control if ctx.workload["runner"] == "restore"
              else train_control)
        out = fn(ctx, control)
        print(json.dumps(dict(cell=args.workload, seed=seed,
                              control_kind=control, s=time.perf_counter() - t0,
                              **out)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
