"""Train the wavelet-domain conditional diffusion UNet (stage 2).

The port's counterpart of ``scripts/train_diffusion.py``:

  python -m wavedm_tpu_torch.cli.train_diffusion \\
      --config wavedm_tpu/configs/raindrop_wavelet.yaml --smoke
  python -m wavedm_tpu_torch.cli.train_diffusion --config ... --smoke \\
      --set model.ch=32 --set model.ch_mult=[1,2] --max-steps 2 --device cpu

``--smoke`` trains on synthetic crops assembled as the JAX script does.
The RainDrop data path is not ported (its decoder needs PIL, which the
card's machine lacks) and raises.  Runs on the card unless ``--device``
names another.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Iterator, Optional

import numpy as np

from wavedm_tpu_torch.config import Config

__all__ = ["smoke_batches", "main"]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True, help="Path to YAML config")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="SECTION.KEY=VALUE",
                   help="config override, repeatable (YAML-parsed value)")
    p.add_argument("--resume", default="",
                   help="Checkpoint to resume from, or 'auto' for the newest "
                        "under the checkpoint dir")
    p.add_argument("--ckpt-dir", default="", help="Checkpoint output dir "
                   "(default <data_dir>/ckpts; none for --smoke)")
    p.add_argument("--max-steps", type=int, default=0,
                   help="Stop after N steps (0 = run n_epochs; 20 for "
                        "--smoke)")
    p.add_argument("--smoke", action="store_true",
                   help="Synthetic data, 20 steps")
    p.add_argument("--hfrm-ckpt", default="",
                   help="Frozen HFRM .pth checkpoint (needed when "
                        "use_gt_in_train=False)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def smoke_batches(cfg: Config, n_crops: Optional[int] = None,
                  n_batches: int = 10
                  ) -> Callable[[int], Iterator[np.ndarray]]:
    """batch_iter_fn for :meth:`DiffusionTrainer.fit`: per epoch,
    ``n_batches`` batches of ``n_crops`` (default ``training.patch_n``)
    random (P, P, 6) [cond | gt] crops of one synthetic 720x480 pair."""
    from wavedm_tpu_torch.data.synthetic import SyntheticPairs

    src = SyntheticPairs(n_images=4, seed=cfg.training.seed)
    p = cfg.data.patch_size
    n_crops = n_crops or cfg.training.patch_n

    def batches(epoch: int) -> Iterator[np.ndarray]:
        rng = np.random.default_rng(epoch)
        for _ in range(n_batches):
            crops = np.empty((n_crops, p, p, 6), np.float32)
            cond, gt = src[int(rng.integers(0, len(src)))]
            for k in range(n_crops):
                y = rng.integers(0, cond.shape[0] - p)
                x = rng.integers(0, cond.shape[1] - p)
                crops[k, ..., :3] = cond[y:y + p, x:x + p]
                crops[k, ..., 3:] = gt[y:y + p, x:x + p]
            yield crops

    return batches


def main(argv=None) -> int:
    args = parse_args(argv)
    from wavedm_tpu_torch.config import load_config
    from wavedm_tpu_torch.training.trainer import DiffusionTrainer
    from wavedm_tpu_torch.utils.checkpoint import find_latest_checkpoint

    cfg = load_config(args.config, args.overrides)
    if args.seed is not None:
        cfg.training.seed = args.seed
    trainer = DiffusionTrainer(
        cfg, hfrm_state_dict=args.hfrm_ckpt or cfg.hfrm.ckpt_path or None,
        device=args.device)
    ckpt_dir = args.ckpt_dir or (
        None if args.smoke else os.path.join(cfg.data.data_dir, "ckpts"))
    if args.resume == "auto":
        latest = find_latest_checkpoint(ckpt_dir) if ckpt_dir else None
        if latest:
            trainer.resume(latest)
        else:
            print("=> --resume auto: no checkpoint found, starting fresh")
    elif args.resume:
        trainer.resume(args.resume)

    if not args.smoke:
        raise NotImplementedError(
            "the RainDrop data path is not ported (its decoder needs PIL; "
            "ROADMAP 'Left out'): use --smoke")
    trainer.fit(smoke_batches(cfg), max_steps=args.max_steps or 20,
                ckpt_dir=ckpt_dir)
    print("smoke training done at step", trainer.state.step)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
