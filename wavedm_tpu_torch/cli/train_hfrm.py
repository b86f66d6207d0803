"""Train HFRM, the stage-1 restorer.

The port's counterpart of ``scripts/train_hfrm.py``:

  python -m wavedm_tpu_torch.cli.train_hfrm \\
      --config wavedm_tpu/configs/raindrop_wavelet.yaml
  python -m wavedm_tpu_torch.cli.train_hfrm --config production --smoke \\
      --device cpu --set hfrm.dim=8 --set hfrm.enc_blk_nums=[1,1] \\
      --set hfrm.dec_blk_nums=[1,1] --set hfrm.middle_blk_num=1

It trains on the whole pairs of ``<data_dir>/raindrop/train`` at the eval
geometry (720x480), ``hfrm.batch_size`` a step, streamed from the PNG
files or, with ``data.device_cache``, gathered from the decoded split held
on the card.  ``--smoke`` trains on synthetic 192x128 pairs in batches of
2.  Checkpoints (``lastest``, ``best``) go to ``--ckpt-dir``; ``lastest``
is what ``--hfrm-ckpt`` of the other entry points takes.  The opt-in loss
terms come on with ``--set hfrm.use_perceptual=true`` (VGG19 features,
torchvision weights from ``hfrm.vgg_ckpt``) and ``--set hfrm.use_gan=true``
(the PatchGAN discriminator, checkpointed with the generator).  Runs on
the card unless ``--device`` names another.  Under ``torchrun
--nproc-per-node N`` it trains data-parallel, each rank on its own stripe
of the split (a global batch of ``hfrm.batch_size * N``).
"""

from __future__ import annotations

import argparse
import os
from typing import Iterator

import numpy as np

__all__ = ["main"]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True,
                   help="YAML config, or a built-in profile (reference, "
                   "production, pixel, global, lap)")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="SECTION.KEY=VALUE",
                   help="config override, repeatable (YAML-parsed value)")
    p.add_argument("--resume", default="", help="HFRM checkpoint to resume")
    p.add_argument("--ckpt-dir", default=os.path.join("saved_models",
                                                      "raindrop"))
    p.add_argument("--max-steps", type=int, default=0,
                   help="Stop after N steps (0 = run hfrm.n_epochs; 10 for "
                        "--smoke)")
    p.add_argument("--smoke", action="store_true",
                   help="Synthetic 192x128 pairs in batches of 2")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from wavedm_tpu_torch.config import load_config
    from wavedm_tpu_torch.parallel.distributed import (initialize_multihost,
                                                       process_count,
                                                       process_index)
    from wavedm_tpu_torch.training.hfrm_trainer import HFRMTrainer
    from wavedm_tpu_torch.utils.gpu_lock import acquire_gpu_lock

    initialize_multihost(device=args.device)
    acquire_gpu_lock("train_hfrm", args.device)
    cfg = load_config(args.config, args.overrides)
    trainer = HFRMTrainer(cfg, device=args.device)
    if args.resume:
        trainer.resume(args.resume)

    if args.smoke:
        from wavedm_tpu_torch.data.synthetic import SyntheticPairs

        src = SyntheticPairs(n_images=4, height=128, width=192)

        def batches(epoch: int) -> Iterator[np.ndarray]:
            rng = np.random.default_rng(epoch)
            for _ in range(5):
                batch = np.empty((2, 128, 192, 6), np.float32)
                for b in range(2):
                    c, g = src[int(rng.integers(0, len(src)))]
                    batch[b, ..., :3] = c
                    batch[b, ..., 3:] = g
                yield batch

        trainer.fit(batches, max_steps=args.max_steps or 10,
                    ckpt_dir=args.ckpt_dir)
        print("smoke HFRM training done at step", trainer.state.step)
        return 0

    from wavedm_tpu_torch.data.raindrop import RainDropDataset

    ds = RainDropDataset(os.path.join(cfg.data.data_dir, "raindrop", "train"),
                         patch_size=0, patch_n=1, parse_patches=False,
                         process_index=process_index(),
                         process_count=process_count())
    bs, seed = cfg.hfrm.batch_size, cfg.training.seed
    if cfg.data.device_cache:
        from wavedm_tpu_torch.data.device_cache import to_unit

        # the split decoded once, as uint8 on the card; a step's batch is
        # one gather there
        cache = torch.from_numpy(np.stack([
            (ds._eval_sample(i)[0] * 255.0 + 0.5).astype(np.uint8)
            for i in ds.indices])).to(trainer.device)

        def batches(epoch: int) -> Iterator[torch.Tensor]:
            order = np.random.default_rng(seed + epoch).permutation(
                cache.shape[0])
            for s in range(0, len(order) - bs + 1, bs):
                idx = torch.from_numpy(order[s:s + bs]).to(trainer.device)
                yield to_unit(cache[idx])
    else:
        def batches(epoch: int) -> Iterator[np.ndarray]:
            buf = []
            for pair, _ in ds.epoch(epoch, seed):
                buf.append(pair)
                if len(buf) == bs:
                    yield np.stack(buf)
                    buf = []

    trainer.fit(batches, max_steps=args.max_steps or None,
                ckpt_dir=args.ckpt_dir)
    print("HFRM training done at step", trainer.state.step)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
