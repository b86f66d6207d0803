"""Teacher-forced probe: eps-MSE and implied-x0-MSE per timestep.

Tells "the model cannot predict eps" (capacity, training) from "the DDIM
rollout compounds small errors" (exposure bias): it feeds the true x_t at
a ladder of t values and prints the per-element eps MSE and x0 MSE, on
training-distribution crops of train or test images.

The port's counterpart of the JAX package's ``tools/diag_teacher_forced.py``,
with its flags, output and draws: the crops are
``RainDropDataset._train_sample(0, default_rng(0))``, the ladder is
10 ... 960, and a v-parameterized checkpoint's output is turned into the
implied eps first.

  python -m wavedm_tpu_torch.tools.diag_teacher_forced --config rehearsal \\
      --resume <ckpt>.pth.tar --hfrm-ckpt <hfrm>.pth.tar [--split test] \\
      [--n-crops 16] [--ema] [--device cpu]

Checkpoints are the port's own (``--resume ''``: random weights).  Runs
on the card unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, List, Tuple

import numpy as np

__all__ = ["T_LADDER", "crops_of", "probe", "report", "main"]

T_LADDER = (10, 40, 100, 200, 300, 400, 600, 800, 960)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True,
                    help="YAML config, or a built-in profile")
    ap.add_argument("--resume", required=True)
    ap.add_argument("--hfrm-ckpt", required=True)
    ap.add_argument("--split", default="test", choices=["train", "test"])
    ap.add_argument("--n-crops", type=int, default=16)
    ap.add_argument("--ema", action="store_true")
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    metavar="SECTION.KEY=VALUE")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def crops_of(cfg, split: str, n_crops: int) -> np.ndarray:
    """(n_crops, P, P, 6) [cond | gt] crops of the split's first image,
    drawn as JAX draws them."""
    from wavedm_tpu_torch.data.raindrop import RainDropDataset

    root = os.path.join(cfg.data.data_dir, "raindrop",
                        "train" if split == "train" else "raindrop_test")
    ds = RainDropDataset(root, cfg.data.patch_size, n_crops,
                         parse_patches=True)
    return ds._train_sample(0, np.random.default_rng(0))


def probe(restorer, crops: np.ndarray,
          noise: Callable[[int, Tuple[int, ...]], "object"]
          ) -> Tuple[Tuple[float, float, float], List[Tuple[int, float,
                                                             float]]]:
    """(gt LL variance, cond LL MSE, HFRM LL MSE) and, for each t of
    ``T_LADDER``, (t, eps MSE, x0 MSE).  ``noise(k, shape)`` is the k-th
    rung's eps draw, NCHW."""
    import torch

    from wavedm_tpu_torch.inference.restoration import data_transform
    from wavedm_tpu_torch.ops.wavelet import wavelet_dec

    cfg, m, dev = restorer.cfg, restorer.cfg.model, restorer.device
    unet = restorer.unet
    x = torch.as_tensor(crops, dtype=torch.float32, device=dev).permute(
        0, 3, 1, 2)
    with torch.no_grad():
        cond_w = wavelet_dec(data_transform(x[:, :3]))
        gt_w = wavelet_dec(data_transform(x[:, 3:]))
        hfrm_w = wavelet_dec(data_transform(restorer.hfrm(x[:, :3])))
        x_tar = gt_w[:, :m.pred_channels]
        other = hfrm_w[:, m.other_channels_begin:]
        abar = torch.cumprod(1.0 - restorer.betas.to(dev), dim=0)
        header = (float(torch.var(x_tar, correction=0)),
                  float(torch.mean((cond_w[:, :3] - x_tar) ** 2)),
                  float(torch.mean((hfrm_w[:, :3] - x_tar) ** 2)))
        rows = []
        n = x.shape[0]
        for k, t in enumerate(T_LADDER):
            a = abar[t]
            e = torch.as_tensor(noise(k, tuple(x_tar.shape)),
                                dtype=torch.float32, device=dev)
            xt = x_tar * torch.sqrt(a) + e * torch.sqrt(1 - a)
            out = unet(torch.cat([cond_w, xt, other], dim=1),
                       torch.full((n,), float(t), device=dev)).float()
            if cfg.training.pred_type == "v":
                # a v-parameterized checkpoint: the implied epsilon
                et = torch.sqrt(1 - a) * xt + torch.sqrt(a) * out
            else:
                et = out
            x0_hat = (xt - et * torch.sqrt(1 - a)) / torch.sqrt(a)
            rows.append((t, float(torch.mean((et - e) ** 2)),
                         float(torch.mean((x0_hat - x_tar) ** 2))))
    return header, rows


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from wavedm_tpu_torch.config import load_config
    from wavedm_tpu_torch.inference.loader import build_restorer
    from wavedm_tpu_torch.utils.gpu_lock import acquire_gpu_lock

    acquire_gpu_lock("diag_teacher_forced", args.device)
    cfg = load_config(args.config, args.overrides)
    restorer = build_restorer(cfg, args.resume or None, args.hfrm_ckpt or None,
                              device=args.device, ema=args.ema)
    crops = crops_of(cfg, args.split, args.n_crops)
    gen = torch.Generator(device=restorer.device).manual_seed(0)

    def noise(k, shape):
        return torch.randn(shape, generator=gen, device=restorer.device)

    report(restorer, crops, noise)
    return 0


def report(restorer, crops: np.ndarray, noise) -> None:
    """Print :func:`probe`'s numbers as JAX's tool prints them."""
    (var, cond_mse, hfrm_mse), rows = probe(restorer, crops, noise)
    print(f"gt LL var {var:.4f}  cond LL mse {cond_mse:.4f}  "
          f"hfrm LL mse {hfrm_mse:.4f}")
    print(f"{'t':>5} {'eps_mse':>9} {'x0_mse':>9}")
    for t, em, xm in rows:
        print(f"{t:>5} {em:>9.4f} {xm:>9.4f}")


if __name__ == "__main__":
    raise SystemExit(main())
