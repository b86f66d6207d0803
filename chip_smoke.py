#!/usr/bin/env python3
"""Drive the PyTorch port's restoration path on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line with its elapsed seconds:

  card              the card's name and power limit; TF32 off for float32
  build             nvcc builds wavedm_tpu_torch/csrc/*.cu into one library
  kernels           every CUDA kernel of the path against its plain PyTorch
                    version at the main path's shapes, timed beside the plain
                    version, one PyTorch library call and its memory bound
  small_parity      a small restoration on the card (kernels) against the
                    same restoration on the CPU (plain versions)
  restore           the flagship UNet (156,492,675 params) and HFRM
                    (15,941,667) with random weights restore two synthetic
                    720x480 images under the reference profile (25 steps,
                    float32) and the production profile (10 steps from the
                    HFRM LL, bfloat16); launch counts are checked per run
  fused_vs_unfused  the production profile again with
                    ``fused_groupnorm: false``, on the same inputs and noise

then the kernel table as one JSON line, the nvidia-smi line, and the final
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero.
It needs one CUDA card and the repository around it.
"""

import json
import subprocess
import sys
import time

MEM_BW = 3.35e12           # H100 SXM device memory, bytes/s
N_IMAGES, HEIGHT, WIDTH = 2, 480, 720
SEED = 61
T0 = time.perf_counter()


def emit(phase, **fields):
    print(json.dumps({"phase": phase,
                      "s": round(time.perf_counter() - T0, 3), **fields}),
          flush=True)


def nvidia_smi():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(*tensors):
    """Least time to read the inputs once and write the outputs once."""
    return sum(t.numel() * t.element_size() for t in tensors) / MEM_BW * 1e3


def gn_sites(cfg, n_patches):
    """(C, H, W, swish) -> count over one UNet forward, from a forward on
    the meta device with hooks on every Normalize."""
    import torch
    from collections import Counter

    from wavedm_tpu_torch.models.layers import Normalize
    from wavedm_tpu_torch.models.unet import DiffusionUNet

    with torch.device("meta"):
        unet = DiffusionUNet.from_config(cfg, fused_gn=False)
        sites = Counter()
        for m in unet.modules():
            if isinstance(m, Normalize):
                m.register_forward_hook(lambda mod, inp, out: sites.update(
                    [tuple(inp[0].shape[1:]) + (mod.swish,)]))
        unet(torch.empty(n_patches, cfg.model.unet_in_channels,
                         cfg.data.image_size, cfg.data.image_size),
             torch.empty(n_patches))
    return sites


def check_kernels(cfg, n_patches):
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    import torch.nn.functional as F

    from wavedm_tpu_torch.ops import groupnorm_cuda as gn
    from wavedm_tpu_torch.ops import wavelet_cuda as wv
    from wavedm_tpu_torch.ops.wavelet import conv_weights

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = {}

    # DWT on the pixel batch in [-1, 1]; IWT on its output
    x = torch.rand(N_IMAGES, 3, HEIGHT, WIDTH, device=dev, generator=gen) * 2 - 1
    z = wv.wavelet_dec_cuda(x)
    z_plain = wv.wavelet_dec_plain(x)
    back = wv.wavelet_rec_cuda(z)
    back_plain = wv.wavelet_rec_plain(z)
    torch.cuda.synchronize()
    bank = torch.as_tensor(conv_weights(2, 3), device=dev)
    z_lib = F.conv2d(x, bank, stride=4, groups=3)   # channel order c*16+f
    dec_err = float((z - z_plain).abs().max())
    rec_err = float((back - back_plain).abs().max())
    rt_err = float((back - x).abs().max())
    tol = 2e-6
    assert dec_err <= tol and rec_err <= tol and rt_err <= tol, (
        dec_err, rec_err, rt_err)
    rows["wavelet_dec"] = dict(
        source="wavedm_tpu_torch/csrc/wavelet.cu",
        replaces="wavedm_tpu/ops/wavelet_pallas.py:44",
        max_abs_err=dec_err, tol=tol,
        ms=time_ms(lambda: wv.wavelet_dec_cuda(x)),
        plain_ms=time_ms(lambda: wv.wavelet_dec_plain(x)),
        bound_ms=bound_ms(x, z),
        library_ms=time_ms(lambda: F.conv2d(x, bank, stride=4, groups=3)))
    rows["wavelet_rec"] = dict(
        source="wavedm_tpu_torch/csrc/wavelet.cu",
        replaces="wavedm_tpu/ops/wavelet_pallas.py:60",
        max_abs_err=rec_err, tol=tol, roundtrip_err=rt_err,
        ms=time_ms(lambda: wv.wavelet_rec_cuda(z)),
        plain_ms=time_ms(lambda: wv.wavelet_rec_plain(z)),
        bound_ms=bound_ms(z, back),
        library_ms=time_ms(
            lambda: F.conv_transpose2d(z_lib, bank, stride=4, groups=3)))
    emit("kernels", kernel="wavelet", shape=list(x.shape),
         dec_err=dec_err, rec_err=rec_err, roundtrip_err=rt_err, tol=tol)

    # GroupNorm(+swish) at every distinct flagship site shape, f32 and bf16,
    # swish on and off.  A row of the table sums one UNet forward's sites of
    # that variant (shapes the forward does not use count 0 there).
    # f32: the Pallas tests' 2e-5 (summation order only); bf16: both round
    # the same f32 value once, so one bf16 ulp (<= 2**-6 relative).
    sites = gn_sites(cfg, n_patches)
    assert sum(sites.values()) == 51, sites
    shapes = sorted({key[:3] for key in sites})
    for dtype, tag, atol, rtol in ((torch.float32, "f32", 2e-5, 2e-5),
                                   (torch.bfloat16, "bf16", 1e-6, 2.0 ** -6)):
        for swish in (True, False):
            name = f"{tag}_swish" if swish else tag
            row = dict(source="wavedm_tpu_torch/csrc/groupnorm.cu",
                       replaces="wavedm_tpu/ops/groupnorm_pallas.py:27",
                       max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                       library_ms=0.0)
            for c, h, w in shapes:
                count = sites.get((c, h, w, swish), 0)
                xs = torch.randn(n_patches, c, h, w, device=dev,
                                 generator=gen).to(dtype)
                wt = torch.randn(c, device=dev, generator=gen)
                bs = torch.randn(c, device=dev, generator=gen)
                y = gn.group_norm(xs, wt, bs, 32, 1e-6, swish)
                yp = gn.group_norm_plain(xs, wt, bs, 32, 1e-6, swish)
                torch.cuda.synchronize()
                diff = (y.float() - yp.float()).abs()
                excess = float((diff - rtol * yp.float().abs()).max())
                assert excess <= atol, (name, c, h, w, excess)
                row["max_abs_err"] = max(row["max_abs_err"], float(diff.max()))
                if not count:
                    emit("kernels", kernel=f"group_norm_{name}",
                         shape=[n_patches, c, h, w], count_per_forward=0,
                         max_abs_err=float(diff.max()))
                    continue
                wl, bl = wt.to(dtype), bs.to(dtype)

                def lib():
                    out = F.group_norm(xs, 32, wl, bl, 1e-6)
                    return F.silu(out) if swish else out

                k_ms = time_ms(lambda: gn.group_norm(xs, wt, bs, 32, 1e-6,
                                                     swish))
                p_ms = time_ms(lambda: gn.group_norm_plain(xs, wt, bs, 32,
                                                           1e-6, swish))
                l_ms = time_ms(lib)
                b_ms = bound_ms(xs, y)
                emit("kernels", kernel=f"group_norm_{name}",
                     shape=[n_patches, c, h, w], count_per_forward=count,
                     max_abs_err=float(diff.max()), ms=k_ms, plain_ms=p_ms,
                     library_ms=l_ms, bound_ms=b_ms)
                for key, val in (("ms", k_ms), ("plain_ms", p_ms),
                                 ("library_ms", l_ms), ("bound_ms", b_ms)):
                    row[key] += count * val      # per UNet forward
            rows[f"group_norm_{name}"] = row
    return rows


def synthetic_images(seed):
    """Rain-degraded-looking (B, H, W, 3) images in [0, 1]: a smooth colour
    field with bright, blurred drops and sensor noise, from numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:HEIGHT, 0:WIDTH] / max(HEIGHT, WIDTH)
    imgs = []
    for _ in range(N_IMAGES):
        img = np.zeros((HEIGHT, WIDTH, 3))
        for c in range(3):
            f, p = rng.uniform(1, 6, 2), rng.uniform(0, 2 * np.pi, 2)
            img[..., c] = 0.5 + 0.25 * np.sin(f[0] * 2 * np.pi * xx + p[0]) \
                * np.cos(f[1] * 2 * np.pi * yy + p[1])
        for _ in range(60):
            cy, cx = rng.uniform(0, HEIGHT), rng.uniform(0, WIDTH)
            r = rng.uniform(4, 18)
            d2 = ((yy * max(HEIGHT, WIDTH) - cy) ** 2
                  + (xx * max(HEIGHT, WIDTH) - cx) ** 2)
            img += 0.3 * np.exp(-d2 / (2 * r * r))[..., None]
        img += rng.normal(0, 0.02, img.shape)
        imgs.append(np.clip(img, 0, 1))
    return np.stack(imgs).astype(np.float32)


def reset_counts():
    from wavedm_tpu_torch.ops import groupnorm_cuda, wavelet_cuda

    for counts in (groupnorm_cuda.launches, wavelet_cuda.launches):
        for key in counts:
            counts[key] = 0


def read_counts():
    from wavedm_tpu_torch.ops import groupnorm_cuda, wavelet_cuda

    return {**{f"group_norm_{k}": v for k, v in groupnorm_cuda.launches.items()},
            **wavelet_cuda.launches}


def restore_timed(rest, images):
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out, hfrm_out = rest.restore_image_device(images)
    torch.cuda.synchronize()
    return out, hfrm_out, (time.perf_counter() - t) * 1e3


def check_output(out):
    import torch

    assert tuple(out.shape) == (N_IMAGES, HEIGHT, WIDTH, 3), out.shape
    assert bool(torch.isfinite(out).all())
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0


def small_parity():
    """A small restoration through the kernels on the card against the same
    restoration through the plain versions on the CPU, float32."""
    import numpy as np
    import torch

    from wavedm_tpu_torch.config import (Config, DataConfig, DiffusionConfig,
                                         ModelConfig, ParallelConfig,
                                         SamplingConfig)
    from wavedm_tpu_torch.inference.loader import build_restorer

    cfg = Config()
    cfg.data = DataConfig(image_size=8, patch_size=32)
    cfg.model = ModelConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                            attn_resolutions=(4,))
    cfg.diffusion = DiffusionConfig(num_diffusion_timesteps=50)
    cfg.sampling = SamplingConfig(sampling_timesteps=10, grid_r=4)
    cfg.hfrm.dim, cfg.hfrm.middle_blk_num = 8, 1
    cfg.hfrm.enc_blk_nums = cfg.hfrm.dec_blk_nums = (1, 1)
    cfg.parallel = ParallelConfig(fused_groupnorm=True)
    cfg.validate()
    images = np.random.default_rng(SEED).random((2, 64, 96, 3),
                                                dtype=np.float32)
    noise = torch.randn(2, 3, 16, 24, generator=torch.Generator().manual_seed(0))
    cpu = build_restorer(cfg, None, None, device="cpu")
    ref, _ = cpu.restore_image(images, noise=noise)
    gpu = build_restorer(cfg, cpu.unet.state_dict(), cpu.hfrm.state_dict(),
                         device="cuda")
    out, _ = gpu.restore_image(images, noise=noise)
    err = float(np.abs(out - ref).max())
    # float32 on both sides, TF32 off: summation order only (the CPU tests
    # hold the same path against JAX to this bound)
    assert err <= 1e-4, err
    emit("small_parity", shape=list(out.shape), max_abs_err=err, tol=1e-4)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from wavedm_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2
    from wavedm_tpu_torch.config import production_profile, reference_profile
    from wavedm_tpu_torch.inference.loader import build_restorer

    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("card", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, tf32=False)

    t = time.perf_counter()
    _build.library()
    emit("build", seconds=time.perf_counter() - t,
         nvcc_seconds=_build.last_build_seconds, library=_build.LIB_PATH)

    ref_cfg = reference_profile()
    prod_cfg = production_profile()
    for cfg in (ref_cfg, prod_cfg):
        cfg.parallel.fused_groupnorm = True
    k_per_image = 45
    rows = check_kernels(ref_cfg, N_IMAGES * k_per_image)

    small_parity()

    images = synthetic_images(SEED)
    launches = dict.fromkeys(rows, 0)
    for name, cfg in (("reference", ref_cfg), ("production", prod_cfg)):
        rest = build_restorer(cfg, None, None, device="cuda")
        n_unet = sum(p.numel() for p in rest.unet.parameters())
        n_hfrm = sum(p.numel() for p in rest.hfrm.parameters())
        assert (n_unet, n_hfrm) == (156_492_675, 15_941_667), (n_unet, n_hfrm)
        steps = len(rest.seq)
        # the counted run: counts start at 0 just before it
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        out, _, first_ms = restore_timed(rest, images)
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        check_output(out)
        tag = "f32" if cfg.parallel.compute_dtype == "float32" else "bf16"
        want = {f"group_norm_{tag}_swish": 45 * steps,
                f"group_norm_{tag}": 6 * steps,
                "wavelet_dec": 2, "wavelet_rec": 1}
        got = {k: v for k, v in counts.items() if v}
        assert got == want, (name, got, want)
        for key, val in counts.items():
            launches[key] += val
        _, _, steady_ms = restore_timed(rest, images)
        emit("restore", profile=name, steps=steps,
             dtype=cfg.parallel.compute_dtype, images=N_IMAGES,
             patches=N_IMAGES * k_per_image, params_unet=n_unet,
             params_hfrm=n_hfrm, launches=got,
             first_ms_per_image=first_ms / N_IMAGES,
             ms_per_image=steady_ms / N_IMAGES, peak_bytes=peak,
             out_min=float(out.min()), out_max=float(out.max()),
             out_mean=float(out.mean()))
    fused_out = out
    unet_sd, hfrm_sd = rest.unet.state_dict(), rest.hfrm.state_dict()
    del rest

    # production profile with the plain GroupNorm: same weights, inputs and
    # noise.  Switching the GN implementation changes rounding at 51 sites
    # per forward; switching the whole network from float32 to bfloat16
    # changes it at every op.  So the first must move the output less than
    # the second: held to the bfloat16-vs-float32 gap of this very run.
    unfused_cfg = production_profile()
    unfused = build_restorer(unfused_cfg, unet_sd, hfrm_sd, device="cuda")
    unfused_out, _, unfused_ms = restore_timed(unfused, images)
    del unfused
    f32_cfg = production_profile()
    f32_cfg.parallel.fused_groupnorm = True
    f32_cfg.parallel.compute_dtype = "float32"
    f32 = build_restorer(f32_cfg, None, None, device="cuda")
    f32_out, _, _ = restore_timed(f32, images)
    del f32
    check_output(unfused_out)
    diff = float((fused_out - unfused_out).abs().max())
    bf16_gap = float((fused_out - f32_out).abs().max())
    assert diff <= bf16_gap, (diff, bf16_gap)
    emit("fused_vs_unfused", profile="production", max_abs_diff=diff,
         mean_abs_diff=float((fused_out - unfused_out).abs().mean()),
         tol_bf16_vs_f32_gap=bf16_gap, unfused_ms_per_image=unfused_ms / N_IMAGES)

    for key, val in launches.items():
        assert val > 0, f"kernel {key} never ran on the main path"
    kernels = [dict(name=key, route="cuda", source=row["source"],
                    replaces=row["replaces"], launches=launches[key],
                    max_abs_err=row["max_abs_err"], ms=row["ms"],
                    plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                    bound_by="bytes", library_ms=row["library_ms"])
               for key, row in rows.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
