"""Sampling-seed variance study of a trained chain.

Two hypotheses explain a batch-8 PSNR below the batch-1 PSNR of the same
image: (a) the 25-step chain from noise has about 1 dB of noise-seed
variance, so a single-seed PSNR means little, or (b) batched restoration
parts from per-image restoration at trained weights.  This tool tells
them apart: per-element PSNRs at batch 1 (N seeds) and at batch 8 (N/8
batches, every element its own draw) must agree in their MEAN if batching
is sound; a batch defect moves the batch-8 mean, seed variance widens
both spreads alike.  The t_start production chain is measured beside it
(expected far tighter: it starts from the HFRM LL, not pure noise).

The port's counterpart of the JAX package's ``tools/seed_study.py``, with
its flags and output: the first heavy ``SyntheticPairs(seed=10061)``
pair, the reference config (``raindrop_wavelet.yaml``) with
``--set`` overrides, chains ``full_25step`` and ``tstart300_10step``,
seeds 1000 + s (batch 1) and 2000 + s (batch 8).

  python -m wavedm_tpu_torch.tools.seed_study [--seeds 16] \\
      [--out results/torch/r4_seed_study.json] [--dtype bfloat16] \\
      [--ckpt-dir saved_models/r3_ddpm] \\
      [--hfrm-ckpt saved_models/r3_hfrm/best.pth.tar] [--device cpu]

The UNet is the newest port checkpoint under ``--ckpt-dir`` (its raw
weights, as JAX reads ``state.params``); ``--tstart-steps`` sets the
second chain's steps (JAX: 10).  Writes one JSON file (JAX's default is
a file the repository holds; the port's lies under ``results/torch/``).
Runs on the card unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
from typing import Callable, Dict

import numpy as np

from wavedm_tpu_torch.tools.common import out_path

__all__ = ["CHAINS", "CONFIG", "stats", "chain_config", "study", "main"]

CHAINS = (("full_25step", 0), ("tstart300_10step", 300))
CONFIG = "reference"            # raindrop_wavelet.yaml, as in JAX


def stats(v) -> Dict[str, float]:
    v = np.asarray(v, np.float64)
    return {"mean": round(float(v.mean()), 3),
            "std": round(float(v.std(ddof=1)), 3),
            "min": round(float(v.min()), 3),
            "max": round(float(v.max()), 3),
            "n": int(v.size)}


def chain_config(cfg, dtype: str, t_start: int = 0, tstart_steps: int = 10):
    """The config of one chain: ``cfg`` in ``dtype``, and with ``t_start``
    the truncated chain from the HFRM LL keeping its last estimate."""
    c = copy.deepcopy(cfg)
    c.parallel.compute_dtype = dtype
    if t_start:
        c.sampling.t_start = t_start
        c.sampling.sampling_timesteps = tstart_steps
        c.sampling.x0_pred_index = -1
        c.sampling.init_ll = "hfrm"
    return c.validate()


def study(restorer, cond: np.ndarray, gt: np.ndarray, seeds: int,
          draw: Callable[[int, tuple], "object"]) -> dict:
    """One chain's batch-1 and batch-8 statistics.  ``cond``: (1, H, W, 3);
    ``draw(key, shape)`` gives the x_T of seed ``key`` (1000 + s at batch
    1, 2000 + s at batch 8), NCHW."""
    from wavedm_tpu_torch.utils.metrics import psnr_torch

    h, w = cond.shape[1:3]
    pc = restorer.cfg.model.pred_channels

    def psnrs(batch, key):
        out, _ = restorer.restore_image(
            batch, noise=draw(key, (len(batch), pc, h // 4, w // 4)))
        return [float(psnr_torch(gt, o)) for o in out]

    b1 = [p for s in range(seeds) for p in psnrs(cond, 1000 + s)]
    c8 = np.repeat(cond, 8, axis=0)
    b8 = [p for s in range(max(1, seeds // 8)) for p in psnrs(c8, 2000 + s)]
    return {"b1": stats(b1), "b8": stats(b8),
            "b8_minus_b1_mean": round(float(np.mean(b8) - np.mean(b1)), 3)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=16)
    ap.add_argument("--out", default=out_path("r4_seed_study.json"))
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    metavar="SECTION.KEY=VALUE")
    ap.add_argument("--ckpt-dir", default=os.path.join("saved_models",
                                                       "r3_ddpm"))
    ap.add_argument("--hfrm-ckpt", default=os.path.join(
        "saved_models", "r3_hfrm", "best.pth.tar"))
    ap.add_argument("--tstart-steps", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch

    from wavedm_tpu_torch.config import load_config
    from wavedm_tpu_torch.data.synthetic import SyntheticPairs
    from wavedm_tpu_torch.inference.loader import build_restorer
    from wavedm_tpu_torch.utils.checkpoint import find_latest_checkpoint
    from wavedm_tpu_torch.utils.gpu_lock import acquire_gpu_lock

    acquire_gpu_lock("seed_study", args.device)
    cfg = load_config(CONFIG, args.overrides)
    latest = find_latest_checkpoint(args.ckpt_dir)
    if not latest:
        raise SystemExit(f"a trained checkpoint under {args.ckpt_dir} is "
                         "required for this study")
    cond, gt = SyntheticPairs(seed=61 + 10_000, severity="heavy")[0]
    cond = cond[None]

    out = {"checkpoint": latest, "dtype": args.dtype, "seeds": args.seeds}
    for label, t_start in CHAINS:
        r = build_restorer(chain_config(cfg, args.dtype, t_start,
                                        args.tstart_steps),
                           latest, args.hfrm_ckpt, device=args.device)

        def draw(key, shape):
            gen = torch.Generator(device=r.device).manual_seed(key)
            return torch.randn(shape, generator=gen, device=r.device)

        out[label] = study(r, cond, gt, args.seeds, draw)
        print(label, out[label], flush=True)
        del r

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
