"""Rehearsal-scale parameterization A/B: can a better parameterization make
the 25-step reference protocol win?

Three arms with identical budgets, seed and data (the dress rehearsal's
synthetic task and its frozen HFRM):
  eps       the reference loss (the baseline)
  v         the velocity parameterization (``training.pred_type=v``)
  eps_snr5  eps with min-SNR-5 weighting (``training.snr_gamma=5.0``)

Each arm trains stage 2 for ``--steps`` steps, then is evaluated under the
25-step full chain (the reference protocol) and the t300_s10 production
profile (``--t-start 300 --sampling-timesteps 10 --init-ll hfrm
--x0-pred-index -1``) at ``--eval-batch 8``.

The port's counterpart of the JAX package's ``scripts/r5_vpred_ab.sh``,
each stage in this process: ``<out>/train_<arm>.log``,
``<out>/eval_<arm>_<protocol>.full.log`` and the grep-filtered
``<out>/eval_<arm>_<protocol>.log`` (``psnr|ssim|images``), and a
``<out>/.done_<arm>`` sentinel that makes a rerun skip a finished arm.
Unlike the JAX script it does not wait on another pipeline or commit its
results.

  python -m wavedm_tpu_torch.tools.vpred_rehearsal_ab [--steps 12000] \\
      [--hfrm-ckpt results/torch/rehearsal/hfrm/best.pth.tar] \\
      [--data-dir results/torch/rehearsal/data] \\
      [--out results/torch/r5_vpred_ab] [--n-images 8] \\
      [--device cpu] [-- extra flags for every stage's CLI]

Runs on the card unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import os
import sys

from wavedm_tpu_torch.tools.common import grep, out_path, run_logged

__all__ = ["parse_args", "ARMS", "PROTOCOLS", "CONFIG", "main"]

CONFIG = "rehearsal"            # rehearsal_wavelet.yaml, as in JAX

ARMS = (("eps", []),
        ("v", ["--set", "training.pred_type=v"]),
        ("eps_snr5", ["--set", "training.snr_gamma=5.0"]))
PROTOCOLS = (("full_chain", []),
             ("t300", ["--t-start", "300", "--sampling-timesteps", "10",
                       "--init-ll", "hfrm", "--x0-pred-index", "-1"]))


def parse_args(argv=None):
    """(the flags, the flags after ``--`` for the stages' CLIs)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    extra = argv[argv.index("--") + 1:] if "--" in argv else []
    argv = argv[:argv.index("--")] if "--" in argv else argv
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=12000)
    ap.add_argument("--hfrm-ckpt", default=out_path(
        "rehearsal", "hfrm", "best.pth.tar"),
        help="the frozen stage-1 file (default: the dress rehearsal's)")
    ap.add_argument("--data-dir", default=out_path("rehearsal", "data"))
    ap.add_argument("--out", default=out_path("r5_vpred_ab"))
    ap.add_argument("--n-images", type=int, default=0,
                    help="cap each eval's image count (0: the whole split)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv), extra


def main(argv=None) -> int:
    args, extra = parse_args(argv)

    from wavedm_tpu_torch.cli import eval_diffusion, train_diffusion
    from wavedm_tpu_torch.utils.checkpoint import find_latest_checkpoint

    os.makedirs(args.out, exist_ok=True)
    common = (["--config", CONFIG, "--set",
               f"data.data_dir={args.data_dir}", "--hfrm-ckpt",
               args.hfrm_ckpt]
              + (["--device", args.device] if args.device else []))
    for name, sets in ARMS:
        sentinel = os.path.join(args.out, f".done_{name}")
        if os.path.exists(sentinel):
            print(f"arm {name}: already done")
            continue
        print(f"=== arm {name} ===")
        ckdir = os.path.join(args.out, f"ckpt_{name}")
        rc, _ = run_logged(train_diffusion.main, common + sets + extra + [
            "--max-steps", str(args.steps), "--ckpt-dir", ckdir],
            os.path.join(args.out, f"train_{name}.log"))
        ckpt = find_latest_checkpoint(ckdir)
        if rc or not ckpt:
            print(f"arm {name}: train failed (rc {rc})", file=sys.stderr)
            return rc or 1
        for proto, flags in PROTOCOLS:
            stem = os.path.join(args.out, f"eval_{name}_{proto}")
            rc, text = run_logged(eval_diffusion.main, common + [
                "--resume", ckpt, "--eval-batch", "8",
                "--n-images", str(args.n_images)] + flags + sets + extra,
                stem + ".full.log")
            with open(stem + ".log", "w") as f:
                f.write(grep(text, r"psnr|ssim|images"))
            if rc:
                return rc
        open(sentinel, "w").close()
    print("v-pred A/B complete")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
