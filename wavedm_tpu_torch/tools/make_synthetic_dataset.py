"""Materialize the synthetic raindrop task as an on-disk dataset in the
RainDrop layout:

  <data_dir>/raindrop/train/{input,gt}/*.png
  <data_dir>/raindrop/raindrop_test/{input,gt}/*.png

so the real pipelines (folder listing, decode, n-crop sampling, the
720x480 eval rule) run end to end when no RainDrop data is present: the
dress rehearsal's stand-in dataset.

The port's counterpart of the JAX package's
``tools/make_synthetic_dataset.py``: the same pairs
(``data/synthetic.py``'s ``SyntheticPairs``, test split seeded with
``--seed`` + 10000), rounded to uint8 as JAX rounds them and written by
the port's own PNG writer (``utils/images.write_png``, no PIL); the files
decode to the same pixels as JAX's PIL-written ones.

  python -m wavedm_tpu_torch.tools.make_synthetic_dataset \\
      [--data-dir results/torch/data] [--n-train 32] [--n-test 8] [--seed 0]

JAX writes to ``./data``, where the repository holds the RainDrop test
split; the port's default is ``results/torch/data``.  Host only.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from wavedm_tpu_torch.tools.common import out_path

__all__ = ["write_split", "main"]


def write_split(root: str, n: int, seed: int, severity: str) -> None:
    """``n`` pairs of ``SyntheticPairs(n, seed, severity)`` as
    ``{input,gt}/{i:04d}.png`` under ``root``."""
    from wavedm_tpu_torch.data.synthetic import SyntheticPairs
    from wavedm_tpu_torch.utils.images import write_png

    src = SyntheticPairs(n_images=n, seed=seed, severity=severity)
    for sub in ("input", "gt"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(n):
        cond, gt = src[i]
        for sub, arr in (("input", cond), ("gt", gt)):
            write_png(os.path.join(root, sub, f"{i:04d}.png"),
                      np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-dir", default=out_path("data"))
    ap.add_argument("--n-train", type=int, default=32)
    ap.add_argument("--n-test", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--severity", default="heavy", choices=["light", "heavy"],
                    help="degradation strength (heavy: ~20 dB input PSNR)")
    args = ap.parse_args(argv)

    base = os.path.join(args.data_dir, "raindrop")
    for split, n, seed in (("train", args.n_train, args.seed),
                           ("raindrop_test", args.n_test, args.seed + 10_000)):
        write_split(os.path.join(base, split), n, seed, args.severity)
        print(f"{split}: wrote {n} pairs under {os.path.join(base, split)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
