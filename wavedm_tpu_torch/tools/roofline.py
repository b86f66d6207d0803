"""Roofline of the restoration hot path: one UNet forward of the tiled chain.

For the headline configuration's UNet forward (the tiled DDIM chain is
its steps times this, plus epsilon), takes the work of one call from
``utils/work.count_work`` (dense FLOPs by torch's formulas, XLA's
convention beside them, and the bytes its ops move, unfused) and the time
of ``--iters`` calls to a ``torch.cuda.synchronize()``, and computes the
two lower bounds

    t_compute = flops / peak_flops        (the compute dtype's dense peak)
    t_memory  = bytes / memory_rate       (bandwidth-bound)

then compares max(t_compute, t_memory) with the measured time, to show
how close the program runs to its own roofline.  The bytes are each op's
inputs and outputs (a kernel's what it reads and writes), so t_memory is
an upper estimate of the traffic a fused program needs.

The port's counterpart of the JAX package's ``tools/roofline.py``: the
UNet of ``raindrop_wavelet.yaml`` (random weights from the config's seed,
stored in the compute dtype as serving stores them) on K = 45 x batch
patches of 64x64x96, t = 0; ``--set`` overrides apply to it as the CLIs'
do.  ``--fused`` runs ``parallel.fused_resblock`` (as JAX's flag does),
``--fused-groupnorm`` ``parallel.fused_groupnorm``.
Float32 runs with TF32 off, as the port's float32 does.  On a card that
``PEAKS`` does not know (or the CPU) it prints no MFU lines.

  python -m wavedm_tpu_torch.tools.roofline [--batch 8] [--dtype bfloat16] \\
      [--iters 8] [--fused | --fused-groupnorm] [--set SECTION.KEY=VALUE] \
      [--device cpu]
"""

from __future__ import annotations

import argparse
import subprocess
import time
from typing import Optional

__all__ = ["PEAKS", "ROUTES", "peaks", "card_line", "measure", "main"]

# dense peaks and memory rate by torch.cuda.get_device_name(): H100 SXM,
# bfloat16 on the tensor cores, float32 on the CUDA cores (TF32 off)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989e12, "float32": 67e12,
                              "bytes_per_s": 3.35e12},
}
ROUTES = ("plain", "fused_groupnorm", "fused_resblock")


def peaks(kind: str) -> Optional[dict]:
    """``PEAKS``' entry of a device name, or None."""
    return PEAKS.get(kind)


def card_line(device) -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (None off the card)."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return None
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    res = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def measure(batch: int = 8, dtype: str = "bfloat16", iters: int = 8,
            route: str = "plain", device=None, cfg=None) -> dict:
    """One roofline: the work of one UNet forward over ``45 * batch``
    patches through ``route`` (one of ``ROUTES``), and its mean time over
    ``iters`` calls after a warm one.  ``cfg``: the config (default
    ``raindrop_wavelet.yaml``'s); float32 callers keep TF32 off."""
    import torch

    from wavedm_tpu_torch.config import reference_profile
    from wavedm_tpu_torch.inference.loader import build_unet
    from wavedm_tpu_torch.models.unet import conv_in_channels
    from wavedm_tpu_torch.utils.device import resolve_device
    from wavedm_tpu_torch.utils.work import count_work

    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    dev = resolve_device(device)
    cfg = cfg or reference_profile()
    cfg.parallel.compute_dtype = dtype
    cfg.parallel.fused_groupnorm = route == "fused_groupnorm"
    cfg.parallel.fused_resblock = route == "fused_resblock"
    cfg.validate()
    unet = build_unet(cfg, None, dev)
    k = 45 * batch
    side = cfg.data.image_size
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(k, conv_in_channels(cfg), side, side, generator=gen,
                    device=dev)
    t = torch.zeros(k, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with torch.no_grad():
        unet(x, t)
        sync()
        w = count_work(unet, x, t)
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            unet(x, t)
        sync()
        dt = (time.perf_counter() - t0) / iters
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    out = dict(device=str(dev), kind=kind, card=card_line(dev), batch=batch,
               patches=k, dtype=dtype, route=route, flops=w.flops,
               xla_flops=w.xla_flops, bytes=w.bytes,
               intensity=w.flops / max(w.bytes, 1.0), ms=dt * 1e3,
               tflops=w.flops / dt / 1e12,
               kernels={n: v["calls"] for n, v in w.by_op.items()
                        if n.startswith("kernel:")})
    peak = peaks(kind)
    if peak:
        t_c = w.flops / peak[dtype]
        t_m = w.bytes / peak["bytes_per_s"]
        bound = max(t_c, t_m)
        out.update(peak_flops=peak[dtype], t_compute_ms=t_c * 1e3,
                   t_memory_ms=t_m * 1e3, bound_ms=bound * 1e3,
                   bound_by="memory" if t_m > t_c else "compute",
                   mfu=w.flops / dt / peak[dtype],
                   attainable_mfu=w.flops / bound / peak[dtype],
                   roofline_fraction=bound / dt)
    return out


def report(r: dict) -> str:
    """JAX's lines, with ``xla_flops`` beside ``flops``."""
    lines = [f"device: {r['kind']}   batch: {r['batch']} images "
             f"({r['patches']} patches)   dtype: {r['dtype']}   "
             f"route: {r['route']}",
             f"flops/call: {r['flops']:.3e} (XLA convention: "
             f"{r['xla_flops']:.3e})   bytes/call: {r['bytes']:.3e}   "
             f"arithmetic intensity: {r['intensity']:.1f} flop/byte",
             f"measured: {r['ms']:.1f} ms/call  "
             f"({r['tflops']:.1f} TFLOP/s achieved)"]
    if "bound_ms" in r:
        lines += [f"t_compute: {r['t_compute_ms']:.1f} ms   t_memory: "
                  f"{r['t_memory_ms']:.1f} ms -> roofline bound "
                  f"{r['bound_ms']:.1f} ms ({r['bound_by']}-bound)",
                  f"MFU vs peak: {r['mfu']:.3f}   roofline-attainable MFU: "
                  f"{r['attainable_mfu']:.3f}   fraction of own roofline "
                  f"achieved: {r['roofline_fraction']:.3f}"]
    if r["card"]:
        lines.append(f"card: {r['card']}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8, help="images per program")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--fused", action="store_true",
                    help="the fused ResnetBlock prefix kernel "
                         "(parallel.fused_resblock)")
    ap.add_argument("--fused-groupnorm", action="store_true",
                    help="the GroupNorm kernel (parallel.fused_groupnorm)")
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    metavar="SECTION.KEY=VALUE")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.fused and args.fused_groupnorm:
        ap.error("--fused and --fused-groupnorm are alternative routes")

    import torch

    from wavedm_tpu_torch.config import load_config
    from wavedm_tpu_torch.utils.gpu_lock import acquire_gpu_lock

    acquire_gpu_lock("roofline", args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    route = ("fused_resblock" if args.fused else
             "fused_groupnorm" if args.fused_groupnorm else "plain")
    cfg = load_config("reference", args.overrides)
    print(report(measure(args.batch, args.dtype, args.iters, route,
                         args.device, cfg)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
