"""The control readings of a pixel restore cell, from which its
correctness limits are set (``calibrate.py`` gives the program's).

  python3 portbench/calibrate_pixel.py --workload restore_pixel_b1 \
      --control-seeds 4,5,6

For each seed, the cell's first ``check_calls`` inputs, noise and weights
as a run with that seed makes them, restored by the pixel reference
(``reference/pixel.py``) in the configuration's precision and by the
control (the reference one precision lower, the configuration file's
``precision.control``), and ``image_gaps`` of the control against the
reference: one JSON line each, on standard output.  The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import torch  # noqa: E402

from portbench import registry  # noqa: E402
from portbench.calibrate import _in_precision  # noqa: E402
from portbench.harness import make_ctx  # noqa: E402
from portbench.lib import pixel  # noqa: E402
from portbench.lib.compare import image_gaps  # noqa: E402
from portbench.lib.session import load_pairs  # noqa: E402
from portbench.reference.pixel import restore  # noqa: E402


def pixel_control(ctx, control: str) -> dict:
    wl = ctx.workload
    inputs, noise = registry.runner(wl["runner"])._inputs(
        ctx, load_pairs(wl, clean=False))
    n = wl["check_calls"]
    imgs = inputs[:n].flatten(0, 1).permute(0, 3, 1, 2)
    z = noise[:n].flatten(0, 1)
    unet = pixel.reference(ctx.raw, ctx.seed, ctx.device)

    def run(prec):
        return restore(ctx.raw, unet, imgs, z, prec, wl["reference_chunk"])

    ref = _in_precision("float32", run)
    return {"control": image_gaps(_in_precision(control, run), ref)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control-seeds", required=True)
    args = ap.parse_args(argv)
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in (int(s) for s in args.control_seeds.split(",") if s):
        t0 = time.perf_counter()
        ctx = make_ctx(args.workload, seed, 0.0, False, dev, t0)
        control = ctx.config_file["precision"]["control"]
        out = pixel_control(ctx, control)
        print(json.dumps(dict(cell=args.workload, seed=seed,
                              control_kind=control,
                              s=time.perf_counter() - t0, **out)),
              flush=True)
        if dev == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
