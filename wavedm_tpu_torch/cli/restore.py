"""Restore degraded images (no ground truth needed).

The port's counterpart of ``scripts/restore.py``: decode, the canonical
720x480 eval resize (PIL's LANCZOS, in numpy), geometry-bucketed batches,
the on-device restoration, PNG outputs ``{name}_restored.png``.

  python -m wavedm_tpu_torch.cli.restore --config production \\
      --resume <ckpt> --hfrm-ckpt <ckpt> --input 'photos/*.png' --out restored/

``--config`` takes a YAML file or a built-in profile (``reference``,
``production``): the wavelet, pixel (``raindrop.yaml``) and
global-attention (``raindrop_wavelet_global.yaml``) paths; only the
wavelet path reads ``--hfrm-ckpt``.  The Laplacian path
(``raindrop_lap.yaml``) restores from [cond | gt] pairs and is refused
here (``cli/eval_diffusion.py`` runs it).  Inputs are any image JAX's PIL
reads (``utils/images.read_image``: PNG and BMP in numpy, JPEG through
the port's data library or PIL, WebP, GIF, TIFF and the rest through
PIL); a directory lists the extensions JAX's script lists (.png, .jpg,
.jpeg, .bmp, .webp), and a file named by a glob or path is read whatever
its name, or raises naming why.  Without ``--resume`` the weights are
random (seeded).  Runs on the card unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from typing import List

__all__ = ["list_inputs", "main"]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True,
                   help="YAML config, or a built-in profile (reference, "
                   "production, pixel, global, lap)")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="SECTION.KEY=VALUE",
                   help="config override, repeatable (YAML-parsed value)")
    p.add_argument("--resume", default="",
                   help="Diffusion checkpoint (random weights without it)")
    p.add_argument("--hfrm-ckpt", default="")
    p.add_argument("--input", required=True,
                   help="image file, directory, or glob")
    p.add_argument("--out", required=True, help="Output directory")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--ema", action="store_true")
    p.add_argument("--t-start", type=int, default=None)
    p.add_argument("--sampling-timesteps", type=int, default=None)
    p.add_argument("--init-ll", default=None,
                   choices=["hfrm", "cond", "noise"])
    p.add_argument("--solver", default=None, choices=["ddim", "dpmpp2m"],
                   help="reverse-chain update rule (sampling.solver)")
    p.add_argument("--x0-pred-index", type=int, default=None)
    p.add_argument("--grid-r", type=int, default=None)
    p.add_argument("--no-resize", action="store_true",
                   help="Keep native geometry (rounded up to /16) instead of "
                        "the 720x480 eval canonicalization")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def list_inputs(spec: str) -> List[str]:
    """A directory's image files, a glob's matches, or the one path."""
    if os.path.isdir(spec):
        return sorted(
            os.path.join(spec, f) for f in os.listdir(spec)
            if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp",
                                   ".webp")))
    if any(ch in spec for ch in "*?["):
        return sorted(glob.glob(spec))
    return [spec]


def main(argv=None) -> int:
    args = parse_args(argv)
    import numpy as np
    import torch

    from wavedm_tpu_torch.config import load_config
    from wavedm_tpu_torch.data.raindrop import restore_input
    from wavedm_tpu_torch.inference.loader import build_restorer
    from wavedm_tpu_torch.inference.restoration import refuse_lap
    from wavedm_tpu_torch.utils.gpu_lock import acquire_gpu_lock
    from wavedm_tpu_torch.utils.images import read_image, save_image

    cfg = load_config(args.config, args.overrides)
    refuse_lap(cfg, "cli.restore")
    acquire_gpu_lock("restore", args.device)
    for name, val in (("t_start", args.t_start),
                      ("sampling_timesteps", args.sampling_timesteps),
                      ("init_ll", args.init_ll),
                      ("x0_pred_index", args.x0_pred_index),
                      ("grid_r", args.grid_r),
                      ("solver", args.solver)):
        if val is not None:
            setattr(cfg.sampling, name, val)
    cfg.validate()

    paths = list_inputs(args.input)
    if not paths:
        raise SystemExit(f"no inputs match {args.input!r}")
    os.makedirs(args.out, exist_ok=True)
    if not args.resume:
        print("Pre-trained diffusion model path is missing! (random weights)")
    restorer = build_restorer(cfg, args.resume or None,
                              args.hfrm_ckpt or cfg.hfrm.ckpt_path or None,
                              device=args.device, ema=args.ema)

    # geometry-bucketed batches: same-size images restore together
    buckets = {}
    for p in paths:
        arr = restore_input(read_image(p), args.no_resize)
        buckets.setdefault(arr.shape, []).append((p, arr))

    generator = torch.Generator(device=restorer.device).manual_seed(
        cfg.training.seed)
    n_done = 0
    t0 = time.time()
    for shape, items in buckets.items():
        for s in range(0, len(items), args.batch):
            chunk = items[s:s + args.batch]
            batch = np.stack([a for _, a in chunk])
            out, _ = restorer.restore_image(batch, generator=generator)
            for (path, _), img in zip(chunk, out):
                name = os.path.splitext(os.path.basename(path))[0]
                save_image(img, os.path.join(args.out, f"{name}_restored.png"))
                n_done += 1
            print(f"[{n_done}/{len(paths)}] {shape[1]}x{shape[0]} "
                  f"batch of {len(chunk)} done "
                  f"({(time.time() - t0) / n_done:.2f} s/image incl. build)")
    print(f"restored {n_done} images -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
