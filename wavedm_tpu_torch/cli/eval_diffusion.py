"""Evaluate a diffusion checkpoint: restore the RainDrop test pairs (or
synthetic ones) and report PSNR in three variants and SSIM.

The port's counterpart of ``scripts/eval_diffusion.py``:

  python -m wavedm_tpu_torch.cli.eval_diffusion \\
      --config wavedm_tpu/configs/raindrop_wavelet.yaml --resume <ckpt> \\
      [--hfrm-ckpt <ckpt>] [--image-folder results/images] [--eval-batch 8]
  python -m wavedm_tpu_torch.cli.eval_diffusion --config production --smoke

``--config`` takes a YAML file or a built-in profile (``reference``,
``production``); a machine without ``yaml`` needs the latter.  Every
shipped config runs: the wavelet path (the only one that reads
``--hfrm-ckpt``), the pixel path (``raindrop.yaml``), global attention
(``raindrop_wavelet_global.yaml``) and the Laplacian path
(``raindrop_lap.yaml``, which restores from each [cond | gt] pair).
``--resume`` takes a reference ``.pth``/``.pth.tar`` or the port's own
checkpoint; without it the weights are random (seeded).  Runs on the card
unless ``--device`` names another.  Under ``torchrun --nproc-per-node N``
each rank restores its own stripe of the pairs and every rank prints the
means over all of them; rank 0 writes the dumps.
"""

from __future__ import annotations

import argparse
import itertools

__all__ = ["main"]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True,
                   help="YAML config, or a built-in profile (reference, "
                   "production, pixel, global, lap)")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="SECTION.KEY=VALUE",
                   help="config override, repeatable (YAML-parsed value)")
    p.add_argument("--resume", default="", help="Diffusion checkpoint "
                   "(reference .pth/.pth.tar or the port's own)")
    p.add_argument("--hfrm-ckpt", default="")
    p.add_argument("--image-folder", default="",
                   help="Dump restored/cond/gt images here")
    p.add_argument("--grid-r", type=int, default=None)
    p.add_argument("--sampling-timesteps", type=int, default=None)
    p.add_argument("--x0-pred-index", type=int, default=None,
                   help="Which x0 estimate to output (reference: -5)")
    p.add_argument("--whole-image", action="store_true",
                   help="Non-tiled chain (sampling.whole_image)")
    p.add_argument("--t-start", type=int, default=None,
                   help="Truncated refinement: run the chain over "
                        "[0, t_start) from noised init_ll (sampling.t_start)")
    p.add_argument("--solver", default=None, choices=["ddim", "dpmpp2m"],
                   help="reverse-chain update rule (sampling.solver)")
    p.add_argument("--init-ll", default=None,
                   choices=["hfrm", "cond", "noise"],
                   help="LL source noised to t_start (sampling.init_ll)")
    p.add_argument("--test-set", default="raindrop",
                   help="accepted as JAX's script accepts it; read by "
                        "nothing (the RainDrop test split is the one set)")
    p.add_argument("--smoke", action="store_true",
                   help="Synthetic pairs instead of the RainDrop test split")
    p.add_argument("--ema", action="store_true",
                   help="Evaluate the checkpoint's EMA weights")
    p.add_argument("--n-images", type=int, default=0,
                   help="Cap image count (of each process's stripe under "
                        "torchrun)")
    p.add_argument("--eval-batch", type=int, default=1,
                   help="Restore N same-geometry images per batch")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import numpy as np

    from wavedm_tpu_torch.config import load_config
    from wavedm_tpu_torch.inference.loader import build_restorer
    from wavedm_tpu_torch.parallel.distributed import (initialize_multihost,
                                                       process_count,
                                                       process_index)
    from wavedm_tpu_torch.utils.gpu_lock import acquire_gpu_lock

    initialize_multihost(device=args.device)
    acquire_gpu_lock("eval_diffusion", args.device)
    cfg = load_config(args.config, args.overrides)
    for name, val in (("grid_r", args.grid_r),
                      ("sampling_timesteps", args.sampling_timesteps),
                      ("x0_pred_index", args.x0_pred_index),
                      ("t_start", args.t_start),
                      ("init_ll", args.init_ll),
                      ("solver", args.solver)):
        if val is not None:
            setattr(cfg.sampling, name, val)
    if args.whole_image:
        cfg.sampling.whole_image = True
    cfg.validate()

    if args.resume:
        print(f"=> loading checkpoint '{args.resume}'")
    else:
        print("Pre-trained diffusion model path is missing! (random weights)")
    restorer = build_restorer(cfg, args.resume or None,
                              args.hfrm_ckpt or cfg.hfrm.ckpt_path or None,
                              device=args.device, ema=args.ema)

    if args.smoke:
        from wavedm_tpu_torch.data.synthetic import SyntheticPairs

        src = SyntheticPairs(n_images=args.n_images or 2)
        samples = ((np.concatenate(src[i], axis=-1), f"synthetic{i}")
                   for i in range(process_index(), len(src),
                                  process_count()))
    else:
        from wavedm_tpu_torch.data.raindrop import RainDrop

        samples = RainDrop(cfg, process_index(),
                           process_count()).eval_samples()
        if args.n_images:
            samples = itertools.islice(samples, args.n_images)
    res = restorer.restore(samples, save_dir=args.image_folder or None,
                           eval_batch=args.eval_batch)
    print("psnr all torch", res["psnr_torch"])
    print("psnr all np", res["psnr_np_y"])
    print("psnr all GPU", res["psnr_y"])
    print("ssim all", res["ssim"])
    print(f"({res['n_images']} images)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
