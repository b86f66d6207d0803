"""Serve restoration over HTTP with device microbatching.

The port's counterpart of ``scripts/serve.py``: one device-owner thread
keeps the card's batch full; concurrent POSTs of same-geometry images share
one restoration (``inference/server.py``).

  python -m wavedm_tpu_torch.cli.serve --config production \\
      --resume <ckpt> --hfrm-ckpt <ckpt> --port 8000 [--batch 8] \\
      [--window-ms 30] [--warmup]

  curl -s -X POST --data-binary @degraded.png localhost:8000/restore > restored.png
  curl -s localhost:8000/healthz

``--config`` takes a YAML file or a built-in profile (``reference``,
``production``): the wavelet, pixel and global-attention paths (the
Laplacian path needs [cond | gt] pairs and is refused; only the wavelet
path reads ``--hfrm-ckpt``).  ``--resume`` / ``--hfrm-ckpt`` take reference
``.pth``/``.pth.tar`` files, the port's own checkpoints, or a file
converted from the JAX package's Orbax checkpoints
(``cli/convert_orbax.py``); ``--resume ''`` serves random (seeded)
weights.  Requests are any image JAX's PIL opens
(``utils/images.decode_image``: PNG and BMP in numpy, JPEG through the
port's data library or PIL, everything else through PIL).  Runs on the
card unless ``--device`` names another.

Patch-parallel serving, one process per card:

  torchrun --nproc-per-node 4 -m wavedm_tpu_torch.cli.serve \
      --config production --resume <ckpt> --hfrm-ckpt <ckpt> --patch-shard

splits each chain's patch batch over the cards; rank 0 serves HTTP and
hands each batch to the other ranks (``inference/server.py``).  Outside
``torchrun`` ``--patch-shard`` is a world of one.
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
    p.add_argument("--resume", required=True,
                   help="Diffusion checkpoint ('' for random weights)")
    p.add_argument("--hfrm-ckpt", default="")
    p.add_argument("--ema", action="store_true")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--window-ms", type=float, default=30.0)
    p.add_argument("--no-resize", action="store_true")
    p.add_argument("--t-start", type=int, default=None)
    p.add_argument("--sampling-timesteps", type=int, default=None)
    p.add_argument("--init-ll", default=None,
                   choices=["hfrm", "cond", "noise"])
    p.add_argument("--solver", default=None, choices=["ddim", "dpmpp2m"],
                   help="reverse-chain update rule (sampling.solver)")
    p.add_argument("--x0-pred-index", type=int, default=None)
    p.add_argument("--grid-r", type=int, default=None)
    p.add_argument("--warmup", action="store_true",
                   help="restore one 720x480 batch before serving")
    p.add_argument("--patch-shard", action="store_true",
                   help="split each chain's patches over the processes "
                        "torchrun started, one a card (patch-parallel "
                        "serving; a world of one outside torchrun)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import time

    import numpy as np

    from wavedm_tpu_torch.config import load_config
    from wavedm_tpu_torch.inference.loader import build_restorer
    from wavedm_tpu_torch.inference.server import RestorationServer
    from wavedm_tpu_torch.parallel.distributed import (initialize_multihost,
                                                       process_count)
    from wavedm_tpu_torch.parallel.mesh import make_mesh
    from wavedm_tpu_torch.utils.gpu_lock import acquire_gpu_lock

    initialize_multihost(device=args.device)
    if process_count() > 1 and not args.patch_shard:
        raise ValueError("several processes serve one restorer only "
                         "patch-parallel: pass --patch-shard")
    acquire_gpu_lock("serve", args.device)
    cfg = load_config(args.config, args.overrides)
    for name, val in (("t_start", args.t_start),
                      ("sampling_timesteps", args.sampling_timesteps),
                      ("init_ll", args.init_ll),
                      ("x0_pred_index", args.x0_pred_index),
                      ("grid_r", args.grid_r),
                      ("solver", args.solver)):
        if val is not None:
            setattr(cfg.sampling, name, val)
    cfg.validate()

    mesh = make_mesh(device=args.device) if args.patch_shard else None
    if mesh is not None:
        print(f"patch-parallel serving over {mesh.size} process(es)")
    restorer = build_restorer(cfg, args.resume or None,
                              args.hfrm_ckpt or cfg.hfrm.ckpt_path or None,
                              device=args.device, ema=args.ema, mesh=mesh)
    server = RestorationServer(restorer, batch=args.batch,
                               window_ms=args.window_ms,
                               no_resize=args.no_resize,
                               rng_seed=cfg.training.seed)
    if mesh is not None and mesh.rank != 0:
        server.follow()
        return 0
    if args.warmup:
        t0 = time.time()
        server.run_batch(np.zeros((args.batch, 480, 720, 3), np.float32))
        print(f"warmup (batch {args.batch}, 720x480): "
              f"{time.time() - t0:.1f}s")

    httpd = server.serve(args.host, args.port)
    host, port = httpd.server_address[:2]
    print(f"serving restoration on {host}:{port} "
          f"(batch {args.batch}, window {args.window_ms} ms)", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.stop()
    if server.failed is not None:
        # a patch-parallel batch failed: exit non-zero so the launcher
        # ends the other ranks
        raise RuntimeError("patch-parallel serving stopped") from server.failed
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
