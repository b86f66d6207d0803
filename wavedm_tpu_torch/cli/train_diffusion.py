"""Train the conditional diffusion UNet (stage 2).

The port's counterpart of ``scripts/train_diffusion.py``:

  python -m wavedm_tpu_torch.cli.train_diffusion \\
      --config wavedm_tpu/configs/raindrop_wavelet_production.yaml \\
      --hfrm-ckpt saved_models/hfrm/lastest.pth.tar
  python -m wavedm_tpu_torch.cli.train_diffusion --config ... --smoke \\
      --set model.ch=32 --set model.ch_mult=[1,2] --max-steps 2 --device cpu

Without ``--smoke`` it trains on random crops of
``<data_dir>/raindrop/train`` (``data.device_cache`` keeps the decoded split
on the card) and every ``training.validation_freq`` steps restores two
pairs of ``<data_dir>/raindrop/raindrop_test`` with the UNet's current
(not EMA) weights, printing PSNR and SSIM and dumping the images under
``<val-folder>/step<N>``; on the wavelet path validation needs HFRM
weights and is skipped without them.  ``--smoke`` trains on synthetic
crops assembled as the JAX script does.  Every shipped config trains: the
wavelet, pixel (``raindrop.yaml``), global-attention
(``raindrop_wavelet_global.yaml``: batches carry each image's 720x480
whole, and ``data.device_cache`` is not used) and Laplacian
(``raindrop_lap.yaml``) domains.  Runs on the card unless ``--device``
names another.

Data-parallel over several cards, one process each (the Laplacian domain
trains on one):

  torchrun --nproc-per-node 4 -m wavedm_tpu_torch.cli.train_diffusion \
      --config ... --hfrm-ckpt ...

Each rank reads its own stripe of the split (every ``N``-th pair), so the
global batch is ``training.batch_size * patch_n`` crops times the number of
processes; rank 0 validates and writes checkpoints.
"""

from __future__ import annotations

import argparse
import itertools
import os
from typing import Callable, Iterator, Optional

import numpy as np

from wavedm_tpu_torch.config import Config

__all__ = ["smoke_batches", "make_validate", "main"]


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
                   help="Frozen HFRM .pth checkpoint (wavelet path: needed "
                        "when use_gt_in_train=False and for validation)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--val-folder", default=os.path.join("results", "images"),
                   help="In-train validation dumps go to <dir>/step<N>")
    return p.parse_args(argv)


def smoke_batches(cfg: Config, n_crops: Optional[int] = None,
                  n_batches: int = 10
                  ) -> Callable[[int], Iterator[np.ndarray]]:
    """batch_iter_fn for :meth:`DiffusionTrainer.fit`: per epoch,
    ``n_batches`` batches of ``n_crops`` (default ``training.patch_n``)
    random (P, P, 6) [cond | gt] crops of one synthetic 720x480 pair; with
    ``data.global_attn`` each comes with that pair's (1, 480, 720, 3) cond
    image as its whole image."""
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
            yield (crops, cond[None]) if cfg.data.global_attn else crops

    return batches


VAL_PAIRS = 2      # eval pairs restored by each in-train validation


def make_validate(trainer, dataset, hfrm_weights,
                  val_folder: str) -> Callable:
    """validate_fn for :meth:`DiffusionTrainer.fit`: restore the first
    ``VAL_PAIRS`` eval pairs of ``dataset`` with the training UNet's current
    weights through one ``DiffusiveRestoration`` kept across calls, print
    PSNR and SSIM, dump the images under ``<val_folder>/step<N>``.  On the
    wavelet path it skips when there are no HFRM weights (``hfrm_weights``
    None and no frozen HFRM in the trainer)."""
    from wavedm_tpu_torch.inference.loader import build_hfrm
    from wavedm_tpu_torch.inference.restoration import DiffusiveRestoration

    box = {}
    need_hfrm = trainer.cfg.data.wavelet_domain

    def validate(state, step: int) -> None:
        if need_hfrm and trainer.hfrm is None and hfrm_weights is None:
            print(f"[validate @ {step}] skipped: no HFRM checkpoint")
            return
        if "r" not in box:
            hfrm = (None if not need_hfrm else trainer.hfrm
                    if trainer.hfrm is not None else
                    build_hfrm(trainer.cfg, hfrm_weights, trainer.device))
            box["r"] = DiffusiveRestoration(trainer.cfg, state.model, hfrm,
                                            device=trainer.device)
        state.model.eval()
        try:
            res = box["r"].restore(
                itertools.islice(dataset.eval_samples(), VAL_PAIRS),
                save_dir=os.path.join(val_folder, f"step{step}"),
                reduce=False)              # rank 0 validates alone
        finally:
            state.model.train()
        print(f"[validate @ {step}] psnr {res['psnr_torch']:.3f} "
              f"ssim {res['ssim']:.4f}")

    return validate


def main(argv=None) -> int:
    args = parse_args(argv)
    from wavedm_tpu_torch.config import load_config
    from wavedm_tpu_torch.parallel.distributed import (initialize_multihost,
                                                       process_count,
                                                       process_index)
    from wavedm_tpu_torch.training.trainer import DiffusionTrainer
    from wavedm_tpu_torch.utils.checkpoint import find_latest_checkpoint
    from wavedm_tpu_torch.utils.gpu_lock import acquire_gpu_lock

    # the process group first, as the JAX script's multihost rendezvous
    initialize_multihost(device=args.device)
    acquire_gpu_lock("train_diffusion", args.device)
    cfg = load_config(args.config, args.overrides)
    if args.seed is not None:
        cfg.training.seed = args.seed
    hfrm_weights = args.hfrm_ckpt or cfg.hfrm.ckpt_path or None
    trainer = DiffusionTrainer(cfg, hfrm_state_dict=hfrm_weights,
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

    if args.smoke:
        trainer.fit(smoke_batches(cfg), max_steps=args.max_steps or 20,
                    ckpt_dir=ckpt_dir)
        print("smoke training done at step", trainer.state.step)
        return 0
    from wavedm_tpu_torch.data.raindrop import RainDrop

    dataset = RainDrop(cfg, process_index(), process_count(),
                       device=trainer.device)
    trainer.fit(dataset.train_batches, max_steps=args.max_steps or None,
                ckpt_dir=ckpt_dir,
                validate_fn=make_validate(trainer, dataset, hfrm_weights,
                                          args.val_folder))
    print("training done at step", trainer.state.step)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
