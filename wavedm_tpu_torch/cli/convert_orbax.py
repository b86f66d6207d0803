"""Convert a JAX package Orbax checkpoint into the port's checkpoint file.

  python -m wavedm_tpu_torch.cli.convert_orbax --config production \\
      <orbax checkpoint dir> <out>.pth.tar

Runs where ``orbax`` is installed (the JAX package's host), on the CPU.
``--config`` (a YAML file or ``reference`` / ``production``, with
``--set`` overrides) must be the one the checkpoint was trained with: it
sets the model's shape, the optimizer's hyperparameters and the
``pred_type`` the port's loaders check.  The output serves through
``cli/serve.py``, ``cli/restore.py`` and ``cli/eval_diffusion.py``
(``--resume``, or ``--hfrm-ckpt`` for a stage-1 checkpoint) and resumes
training (``utils/orbax_convert.py`` says what carries over).
"""

from __future__ import annotations

import argparse

__all__ = ["main"]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True,
                   help="YAML config, or a built-in profile (reference, "
                   "production, pixel, global, lap)")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="SECTION.KEY=VALUE",
                   help="config override, repeatable (YAML-parsed value)")
    p.add_argument("src", help="Orbax checkpoint directory")
    p.add_argument("dst", help="output file (.pth.tar appended if missing)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from wavedm_tpu_torch.config import load_config
    from wavedm_tpu_torch.utils.orbax_convert import convert_orbax_checkpoint

    cfg = load_config(args.config, args.overrides).validate()
    out = convert_orbax_checkpoint(args.src, args.dst, cfg)
    print(f"{out['kind']} checkpoint at step {out['step']} (epoch "
          f"{out['epoch']}, {out['optimizer']}) -> {out['path']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
