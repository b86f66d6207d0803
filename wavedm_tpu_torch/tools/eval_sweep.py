"""Post-training evaluation sweep: the reference 25-step protocol against
truncated refinement, raw against EMA weights, then the per-band
diagnostic; one log a row.

The port's counterpart of the JAX package's ``scripts/r3_eval_sweep.sh``,
with ``scripts/r5_sweep_resume.sh``'s resume: the same eight rows
(:data:`ROWS`), each run through ``cli.eval_diffusion`` in this process
at ``--eval-batch 8``, its whole output kept in ``<out>/<row>.full.log``
and the lines matching ``psnr|ssim|images|loaded`` (the port's eval
prints "loading" where JAX's prints "loaded": both kept) in
``<out>/<row>.log``, the form ``tools/summarize_sweep.py`` reads.  A row
whose log already holds a psnr line is skipped, and the diagnostic
(``tools/diag_quality.py --split both --n 8`` into ``<out>/diag.log``)
once its log holds an "LL MSE" line, so a rerun finishes only what is
left.

  python -m wavedm_tpu_torch.tools.eval_sweep [--ckpt <unet>.pth.tar] \\
      [--hfrm-ckpt saved_models/r3_hfrm/best.pth.tar] \\
      [--out results/torch/r3_sweep] [--rows full_chain,t300_s10] \\
      [--diag-n 8] [--device cpu] [-- extra eval_diffusion flags]

The config is ``rehearsal_flagship.yaml``'s (the built-in profile), the
UNet checkpoint by default the newest under ``saved_models/r3_ddpm``, as
in JAX.  Flags after ``--`` go to every row's ``cli.eval_diffusion`` (say
``--n-images 2 --set sampling.grid_r=8``); ``--diag-n 0`` leaves the
diagnostic out.  Runs on the card unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import os
import sys

from wavedm_tpu_torch.tools.common import grep, out_path, run_logged

__all__ = ["parse_args", "ROWS", "FILTER", "CONFIG", "main"]

_T = ["--sampling-timesteps", "10", "--init-ll", "hfrm",
      "--x0-pred-index", "-1"]
ROWS = (
    ("full_chain", []),
    ("full_chain_ema", ["--ema"]),
    ("t300_s10", ["--t-start", "300"] + _T),
    ("t300_s10_ema", ["--ema", "--t-start", "300"] + _T),
    ("t200_s10", ["--t-start", "200"] + _T),
    ("t400_s10", ["--t-start", "400"] + _T),
    ("t300_s5", ["--t-start", "300", "--sampling-timesteps", "5",
                 "--init-ll", "hfrm", "--x0-pred-index", "-1"]),
    ("t300_s10_cond", ["--t-start", "300", "--sampling-timesteps", "10",
                       "--init-ll", "cond", "--x0-pred-index", "-1"]),
)
FILTER = r"psnr|ssim|images|loaded|loading"
CONFIG = "rehearsal_flagship"   # rehearsal_flagship.yaml, as in JAX
CKPT_DIR = os.path.join("saved_models", "r3_ddpm")


def _done(path: str, marker: str) -> bool:
    if not os.path.exists(path):
        return False
    with open(path) as f:
        return marker in f.read()


def parse_args(argv=None):
    """(the flags, the flags after ``--`` for the stages' CLIs)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    extra = argv[argv.index("--") + 1:] if "--" in argv else []
    argv = argv[:argv.index("--")] if "--" in argv else argv
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default="",
                    help="UNet checkpoint (default: the newest under "
                    "saved_models/r3_ddpm)")
    ap.add_argument("--hfrm-ckpt", default=os.path.join(
        "saved_models", "r3_hfrm", "best.pth.tar"))
    ap.add_argument("--out", default=out_path("r3_sweep"))
    ap.add_argument("--rows", default="",
                    help="comma-separated subset of the rows (default: all, "
                    "in order)")
    ap.add_argument("--eval-batch", type=int, default=8)
    ap.add_argument("--diag-n", type=int, default=8,
                    help="images a split for the per-band diagnostic "
                    "(0: none)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv), extra


def main(argv=None) -> int:
    args, extra = parse_args(argv)

    from wavedm_tpu_torch.cli import eval_diffusion
    from wavedm_tpu_torch.tools import diag_quality
    from wavedm_tpu_torch.utils.checkpoint import find_latest_checkpoint

    ckpt = args.ckpt or find_latest_checkpoint(CKPT_DIR)
    if not ckpt:
        print(f"no checkpoint under {CKPT_DIR}", file=sys.stderr)
        return 1
    names = [n for n, _ in ROWS]
    wanted = args.rows.split(",") if args.rows else names
    unknown = sorted(set(wanted) - set(names))
    if unknown:
        print(f"unknown rows {unknown}; the rows are {names}",
              file=sys.stderr)
        return 2
    device = ["--device", args.device] if args.device else []
    print(f"evaluating {ckpt}")
    os.makedirs(args.out, exist_ok=True)
    for name, row in ROWS:
        if name not in wanted:
            continue
        log = os.path.join(args.out, f"{name}.log")
        if _done(log, "psnr"):
            print(f"=== {name} : done (skipping)")
            continue
        print(f"=== {name} : {' '.join(row)}")
        rc, text = run_logged(eval_diffusion.main, [
            "--config", CONFIG, "--resume", ckpt, "--hfrm-ckpt",
            args.hfrm_ckpt, "--eval-batch", str(args.eval_batch)]
            + row + device + extra,
            os.path.join(args.out, f"{name}.full.log"))
        with open(log, "w") as f:
            f.write(grep(text, FILTER))
        if rc:
            return rc
    diag = os.path.join(args.out, "diag.log")
    if args.diag_n and not _done(diag, "LL MSE"):
        overrides = [a for i, a in enumerate(extra)
                     if a == "--set" or (i and extra[i - 1] == "--set")]
        rc, text = run_logged(diag_quality.main, [
            "--config", CONFIG, "--resume", ckpt, "--hfrm-ckpt",
            args.hfrm_ckpt, "--split", "both", "--n", str(args.diag_n)]
            + overrides + device, os.path.join(args.out, "diag.full.log"))
        with open(diag, "w") as f:
            f.write("".join(line + "\n"
                            for line in text.splitlines()[-60:]))
        if rc:
            return rc
    print("sweep done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
