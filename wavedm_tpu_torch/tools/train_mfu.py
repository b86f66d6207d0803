"""Training-step MFU for the flagship diffusion run.

Counts the work of the exact ``rehearsal_flagship.yaml`` train step (the
156M UNet forward and backward, the frozen HFRM's conditioning, Adam, EMA;
patch_n x batch_size crops of 256x256 -> 64x64 wavelet patches) with
``utils/work.count_work``: dense FLOPs by torch's formulas, the same under
every kernel route; divided by a step time measured on the card this gives
the training MFU.  XLA's convention (``train_xla_flops_per_step``) is
printed beside it, the figure the JAX package's tool reports.

The port's counterpart of the JAX package's ``tools/train_mfu.py``, with
its flags and keys.  ``--device`` replaces JAX's ``--cpu``: the step runs
(once, from random weights on a zero batch) where it says, the card when
not given.  ``--peak`` defaults to the card's dense peak for the compute
dtype (``tools/roofline.PEAKS``); with none known the MFU is null.
``--set`` overrides apply to the config as the CLIs' do (a kernel route:
``--set parallel.fused_resblock=true``).

  python -m wavedm_tpu_torch.tools.train_mfu --step-time 0.155 \\
      [--dtype float32] [--batch-size 2] [--peak 989e12] [--device cpu]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json

__all__ = ["CONFIG", "count_step", "main"]

CONFIG = "rehearsal_flagship"


def count_step(cfg, device):
    """(``utils/work.Work`` of one train step of ``cfg`` on ``device``, the
    batch shape)."""
    import numpy as np

    from wavedm_tpu_torch.inference.loader import build_hfrm, build_unet
    from wavedm_tpu_torch.training.state import create_train_state
    from wavedm_tpu_torch.training.train_step import make_train_step
    from wavedm_tpu_torch.utils.work import count_work

    unet = build_unet(cfg, None, device, train=True)
    hfrm = (None if cfg.model.use_gt_in_train
            else build_hfrm(cfg, None, device))
    state = create_train_state(unet, cfg.optim, cfg.training.seed)
    step = make_train_step(cfg, unet, hfrm)
    p = cfg.data.patch_size
    shape = (cfg.training.patch_n * cfg.training.batch_size, p, p, 6)
    return count_work(step, state, np.zeros(shape, np.float32)), shape


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--step-time", type=float, required=True,
                    help="measured seconds/step on the target card")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--batch-size", type=int, default=None,
                    help="override training.batch_size (images/step; "
                         "crops/step = batch_size * patch_n)")
    ap.add_argument("--peak", type=float, default=None,
                    help="peak FLOP/s for the MFU denominator (default: the "
                         "card's for the dtype)")
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    metavar="SECTION.KEY=VALUE")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch

    from wavedm_tpu_torch.config import load_config
    from wavedm_tpu_torch.tools.roofline import card_line, peaks
    from wavedm_tpu_torch.utils.device import resolve_device
    from wavedm_tpu_torch.utils.gpu_lock import acquire_gpu_lock

    acquire_gpu_lock("train_mfu", args.device)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(CONFIG, args.overrides)
    cfg.parallel.compute_dtype = args.dtype
    if args.batch_size is not None:
        cfg.training.batch_size = args.batch_size
    cfg.validate()
    w, shape = count_step(cfg, dev)
    peak = args.peak
    if peak is None and dev.type == "cuda":
        known = peaks(torch.cuda.get_device_name(dev))
        peak = known[args.dtype] if known else None
    achieved = w.flops / args.step_time
    print(json.dumps({
        "train_flops_per_step": w.flops,
        "batch": [int(s) for s in shape],
        "compute_dtype": args.dtype,
        "step_time_s": args.step_time,
        "achieved_flops_per_s": achieved,
        "peak_flops_per_s": peak,
        "train_mfu": round(achieved / peak, 4) if peak else None,
        "train_xla_flops_per_step": w.xla_flops,
        "bytes_per_step": w.bytes,
        "device_used_for_flop_count": str(dev),
        "card": card_line(dev),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
