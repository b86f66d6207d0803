"""Full-protocol dress rehearsal on one card, no external data needed:
synthetic RainDrop-layout dataset -> stage-1 HFRM -> stage-2 wavelet
diffusion -> CLI eval (three PSNR variants, SSIM, image dumps).

The port's counterpart of the JAX package's ``scripts/dress_rehearsal.sh``,
each stage in this process: ``tools.make_synthetic_dataset`` ->
``cli.train_hfrm --max-steps STEPS1`` -> ``cli.train_diffusion
--max-steps STEPS2`` -> ``cli.eval_diffusion`` of the newest diffusion
checkpoint, on ``rehearsal_wavelet.yaml`` (the built-in ``rehearsal``
profile).  Stage 2 and the eval take the HFRM's ``best`` file
(``lastest`` where no epoch beat ``hfrm.best_psnr_init``).  The JAX
script passes no ``--hfrm-ckpt`` to its stage 2, whose trainer then
raises: that config trains on the HFRM's conditioning
(``use_gt_in_train: false``).

  python -m wavedm_tpu_torch.tools.dress_rehearsal [--steps1 1800] \\
      [--steps2 6000] [--work results/torch/rehearsal] [--device cpu] \\
      [--n-train 32] [--n-test 8] [-- extra flags for every stage's CLI]

Everything goes under ``--work``: ``data/`` (the dataset), ``hfrm/`` and
``ddpm/`` (the checkpoints), ``images/`` (the eval dumps), and
``<stage>.log``.  Flags after ``--`` go to both trainers and the eval
(say ``--set model.ch=32``).  Runs on the card unless ``--device`` names
another.
"""

from __future__ import annotations

import argparse
import os
import sys

from wavedm_tpu_torch.tools.common import out_path, run_logged

__all__ = ["parse_args", "CONFIG", "main"]

CONFIG = "rehearsal"            # rehearsal_wavelet.yaml, as in JAX


def parse_args(argv=None):
    """(the flags, the flags after ``--`` for the stages' CLIs)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    extra = argv[argv.index("--") + 1:] if "--" in argv else []
    argv = argv[:argv.index("--")] if "--" in argv else argv
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps1", type=int, default=1800,
                    help="stage-1 (HFRM) steps (JAX: STEPS1)")
    ap.add_argument("--steps2", type=int, default=6000,
                    help="stage-2 (diffusion) steps (JAX: STEPS2)")
    ap.add_argument("--work", default=out_path("rehearsal"))
    ap.add_argument("--n-train", type=int, default=32)
    ap.add_argument("--n-test", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv), extra


def main(argv=None) -> int:
    args, extra = parse_args(argv)

    from wavedm_tpu_torch.cli import eval_diffusion, train_diffusion, \
        train_hfrm
    from wavedm_tpu_torch.tools import make_synthetic_dataset
    from wavedm_tpu_torch.utils.checkpoint import find_latest_checkpoint

    w = args.work
    data, hfrm, ddpm = (os.path.join(w, d) for d in ("data", "hfrm", "ddpm"))
    common = (["--config", CONFIG, "--set", f"data.data_dir={data}"]
              + (["--device", args.device] if args.device else []) + extra)

    def stage(name, main, stage_argv):
        rc, _ = run_logged(main, stage_argv, os.path.join(w, f"{name}.log"))
        if rc:
            raise SystemExit(f"dress rehearsal: {name} exited {rc}")

    stage("make_synthetic_dataset", make_synthetic_dataset.main,
          ["--data-dir", data, "--n-train", str(args.n_train),
           "--n-test", str(args.n_test)])
    stage("train_hfrm", train_hfrm.main,
          common + ["--max-steps", str(args.steps1), "--ckpt-dir", hfrm])
    hfrm_ckpt = os.path.join(hfrm, "best.pth.tar")
    if not os.path.exists(hfrm_ckpt):
        hfrm_ckpt = os.path.join(hfrm, "lastest.pth.tar")
    stage("train_diffusion", train_diffusion.main,
          common + ["--max-steps", str(args.steps2), "--ckpt-dir", ddpm,
                    "--hfrm-ckpt", hfrm_ckpt])
    latest = find_latest_checkpoint(ddpm)
    if not latest:
        raise SystemExit(f"dress rehearsal: no checkpoint in {ddpm}")
    stage("eval_diffusion", eval_diffusion.main,
          common + ["--resume", latest, "--hfrm-ckpt", hfrm_ckpt,
                    "--image-folder", os.path.join(w, "images")])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
