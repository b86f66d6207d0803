"""Quality-loop diagnostic: decompose the full pipeline's PSNR into per-band
causes.

For each image it prints the PSNR-Y (against the ground truth) of:
  input               : the degraded input unchanged
  hfrm                : the stage-1 output alone
  [inLL |hfrmHF]      : the input's LL band + HFRM's high bands
  [gtLL |hfrmHF]      : the oracle LL (the machinery's ceiling)
  [diffLL|hfrmHF]     : the real full pipeline
  [diffLL|gtHF]       : the diffusion LL with perfect high bands (isolates
                        the LL)
and the wavelet-domain LL MSE of input, HFRM and diffusion against the
ground truth's LL.  Run it on train-split images and on held-out ones to
tell under-fitting from over-fitting.

The port's counterpart of the JAX package's ``tools/diag_quality.py``,
with its flags, output and draws: the sampler is the restorer's own
(``DiffusiveRestoration._make_sampler``), x_T is one draw seeded with
``training.seed`` for every image (noised from the input's LL under
``data.begin_from_noise: false``), and the kept x0 estimate is picked as
JAX picks it.

  python -m wavedm_tpu_torch.tools.diag_quality --config rehearsal \\
      --resume <ckpt>.pth.tar --hfrm-ckpt <hfrm>.pth.tar --split both --n 4 \\
      [--ema] [--x0-pred-index -5] [--sampling-timesteps 25] [--device cpu]

Checkpoints are the port's own (a JAX Orbax directory is converted first
by ``cli/convert_orbax.py``); ``--resume ''`` restores with random
weights.  Runs on the card unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np

__all__ = ["diagnose_image", "run", "main"]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True,
                    help="YAML config, or a built-in profile (rehearsal, "
                    "rehearsal_flagship, reference, production, ...)")
    ap.add_argument("--resume", required=True)
    ap.add_argument("--hfrm-ckpt", required=True)
    ap.add_argument("--split", default="both",
                    choices=["train", "test", "both"])
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--ema", action="store_true")
    ap.add_argument("--x0-pred-index", type=int, default=None)
    ap.add_argument("--sampling-timesteps", type=int, default=None)
    ap.add_argument("--no-begin-from-noise", action="store_true")
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    metavar="SECTION.KEY=VALUE")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def diagnose_image(restorer, pair: np.ndarray, noise,
                   generator=None) -> Tuple[Dict[str, np.ndarray],
                                            Dict[str, float]]:
    """One (H, W, 6) [cond | gt] pair in [0, 1]: the six (H, W, 3)
    reconstructions by name and the three LL MSEs.  ``noise``: the x_T
    draw, (1, pred_channels, H/4, W/4); ``generator`` draws the chain's
    step noise (eta > 0 only)."""
    import torch

    from wavedm_tpu_torch.inference.restoration import (
        data_transform, inverse_data_transform)
    from wavedm_tpu_torch.ops.wavelet import wavelet_dec, wavelet_rec

    cfg, m, dev = restorer.cfg, restorer.cfg.model, restorer.device
    x = torch.as_tensor(pair, dtype=torch.float32, device=dev).permute(
        2, 0, 1)[None]
    cond, gt = x[:, :3], x[:, 3:]
    h, w = cond.shape[2:]
    sampler = restorer._make_sampler(h // 4, w // 4, m.use_other_channels)
    with torch.no_grad():
        cond_w = wavelet_dec(data_transform(cond))
        gt_w = wavelet_dec(data_transform(gt))
        restored = restorer.hfrm(cond)
        hfrm_w = wavelet_dec(data_transform(restored))
        x_init = torch.as_tensor(noise, dtype=torch.float32, device=dev)
        if not cfg.data.begin_from_noise:
            a_t = torch.cumprod(1.0 - restorer.betas, dim=0)[-1]
            x_init = (cond_w[:, :m.pred_channels] * torch.sqrt(a_t)
                      + x_init * torch.sqrt(1.0 - a_t))
        x_other = (hfrm_w[:, m.other_channels_begin:]
                   if m.use_other_channels else None)
        _, x0_preds = sampler(x_init, cond_w, x_other, generator, None,
                              None)
        # the tiled sampler keeps only the estimate at x0_pred_index
        sel = 0 if x0_preds.shape[0] == 1 else cfg.sampling.x0_pred_index
        diff_ll = x0_preds[sel].float()

        def rec(ll, hf):
            full = torch.cat([ll[:, :3], hf[:, 3:]], dim=1)
            return hwc(inverse_data_transform(wavelet_rec(full)))

        def hwc(t):
            return t[0].permute(1, 2, 0).float().cpu().numpy()

        def mse(a, b):
            return float(torch.mean((a[:, :3] - b[:, :3]) ** 2))

        rows = {
            "input": hwc(cond),
            "hfrm": hwc(restored),
            "inLL|hfrmHF": rec(cond_w, hfrm_w),
            "gtLL|hfrmHF": rec(gt_w, hfrm_w),
            "diffLL|hfrmHF": rec(diff_ll, hfrm_w),
            "diffLL|gtHF": rec(diff_ll, gt_w),
        }
        ll_mse = {"inLL": mse(cond_w, gt_w), "hfrmLL": mse(hfrm_w, gt_w),
                  "diffLL": mse(diff_ll, gt_w)}
    return rows, ll_mse


def run(restorer, split: str, n: int,
        draw: Callable[[Tuple[int, ...]], "object"],
        generator: Optional[Callable[[], "object"]] = None) -> None:
    """Print the diagnosis of the first ``n`` pairs of each split wanted
    (``train``, ``test`` or ``both``) under ``cfg.data.data_dir``.
    ``draw(shape)`` gives an image's x_T; ``generator()`` its step
    noise's generator."""
    from wavedm_tpu_torch.data.raindrop import RainDropDataset
    from wavedm_tpu_torch.utils import metrics as M

    cfg = restorer.cfg
    splits = {"train": "train", "test": "raindrop_test"}
    for sp in (["train", "test"] if split == "both" else [split]):
        root = os.path.join(cfg.data.data_dir, "raindrop", splits[sp])
        ds = RainDropDataset(root, cfg.data.patch_size, 1,
                             parse_patches=False)
        k = min(n, len(ds))
        print(f"== split {sp} ({k} images) ==")
        for i in range(k):
            pair, img_id = ds._eval_sample(i)
            h, w = pair.shape[:2]
            rows, ll_mse = diagnose_image(
                restorer, pair,
                draw((1, cfg.model.pred_channels, h // 4, w // 4)),
                generator() if generator else None)
            gt0 = pair[..., 3:]
            print(f"-- {sp}/{img_id}")
            for key, v in rows.items():
                print(f"   {key:>14}: "
                      f"{M.psnr_y(gt0, np.clip(v, 0, 1)):6.2f} dB")
            print("   LL MSE  " + "  ".join(f"{key}={v:.5f}"
                                            for key, v in ll_mse.items()))


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from wavedm_tpu_torch.config import load_config
    from wavedm_tpu_torch.inference.loader import build_restorer
    from wavedm_tpu_torch.utils.gpu_lock import acquire_gpu_lock

    acquire_gpu_lock("diag_quality", args.device)
    cfg = load_config(args.config, args.overrides)
    if args.x0_pred_index is not None:
        cfg.sampling.x0_pred_index = args.x0_pred_index
    if args.sampling_timesteps is not None:
        cfg.sampling.sampling_timesteps = args.sampling_timesteps
    if args.no_begin_from_noise:
        cfg.data.begin_from_noise = False
    cfg.validate()
    restorer = build_restorer(cfg, args.resume or None, args.hfrm_ckpt or None,
                              device=args.device, ema=args.ema)
    seed = cfg.training.seed

    # as JAX: the same key, so the same x_T, for every image
    def draw(shape):
        gen = torch.Generator(device=restorer.device).manual_seed(seed)
        return torch.randn(shape, generator=gen, device=restorer.device)

    def step_generator():
        return torch.Generator(device=restorer.device).manual_seed(seed + 1)

    run(restorer, args.split, args.n, draw, step_generator)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
