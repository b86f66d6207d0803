"""The pixel configuration's parts: its plain reference against the port's
pixel restore on seeded weights, its work count, the
``discarded_step_pct.restore`` reader, and tiny whole runs of the two
cells this configuration and the native crop stream brought
(``restore_pixel_b1``, ``train_prod_stream``), on the CPU."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from portbench import registry
from portbench.calibrate_pixel import pixel_control
from portbench.harness import make_ctx, run_cell
from portbench.lib import flops, pixel
from portbench.lib.compare import judge
from portbench.lib.trace import Families
from portbench.reference.pixel import chain, chain_times, kept_step, restore
from portbench.reference.precision import Prec
from portbench_tiny import SEED, TINY
from wavedm_tpu_torch.config import apply_overrides, config_from_dict
from wavedm_tpu_torch.inference.loader import build_unet
from wavedm_tpu_torch.inference.restoration import DiffusiveRestoration
from wavedm_tpu_torch.models.unet import DiffusionUNet
from wavedm_tpu_torch.utils.images import write_png
from wavedm_tpu_torch.utils.work import count_work

# the pixel UNet's six levels kept, at ch 32 on 32x32 patches (down to
# 1x1), grid_r 8, five steps from noise keeping step 4's x0
PIXEL_TINY = ["model.ch=32", "data.image_size=32", "data.patch_size=32",
              "sampling.sampling_timesteps=5", "sampling.x0_pred_index=-2",
              "sampling.grid_r=8"]
F32 = ["parallel.compute_dtype=float32"]
RESTORE = dict(size=[64, 96], pool=2, check_within=2, check_calls=1,
               trace_calls=2, reference_chunk=16)


def _raw(extra=()):
    raw = json.loads(json.dumps(registry.config("wavedm_pixel")["config"]))
    return apply_overrides(raw, list(extra))


def test_the_port_restores_as_the_reference():
    """The port's float32 pixel restore of two 64x96 images (24 patches
    each) against the reference on the same seeded weights and noise.
    Random weights do not predict the noise, so x0 reads ~1/sqrt(abar)
    times it (|x0| up to ~120) and most of the image clamps to 0 or 1; the
    kept x0 is therefore compared before the clamp too.  Tolerance: 1e-6
    of the largest |x0| (the port sums in other orders, float32's 2**-23
    a rounding over the chain's ~100 dependent operations; measured
    1.9e-7), under the 2.5e-6 by which the last step's x0 differs from
    the kept one's; the clamped images within 1e-5."""
    raw = _raw(PIXEL_TINY + F32)
    cfg = config_from_dict(json.loads(json.dumps(raw)))
    unet = pixel.reference(raw, 7, "cpu")
    port = DiffusiveRestoration(
        cfg, build_unet(cfg, pixel.seeded(raw, 7, "cpu"), "cpu"), None,
        "cpu")
    g = torch.Generator().manual_seed(3)
    img = torch.rand(2, 64, 96, 3, generator=g)
    noise = torch.randn(2, 3, 64, 96, generator=g)
    nchw = img.permute(0, 3, 1, 2)
    x0 = port._make_sampler(64, 96, use_other=False)(noise,
                                                     2 * nchw - 1)[1][0]
    x0_ref = chain(raw, unet, nchw, noise, Prec(), 16)
    atol = 1e-6 * float(x0_ref.abs().max())
    torch.testing.assert_close(x0, x0_ref, rtol=0, atol=atol)
    last = dict(raw, sampling=dict(raw["sampling"], x0_pred_index=-1))
    assert float((chain(last, unet, nchw, noise, Prec(), 16)
                  - x0_ref).abs().max()) > 2 * atol
    out = port.restore_image_device(img, noise=noise)[0]
    torch.testing.assert_close(out.permute(0, 3, 1, 2),
                               restore(raw, unet, nchw, noise, Prec(), 16),
                               rtol=0, atol=1e-5)


def test_the_chain_keeps_step_21_of_25():
    raw = _raw()
    assert chain_times(raw)[:2] == [960, 920] and len(chain_times(raw)) == 25
    assert kept_step(raw) == 20 and chain_times(raw)[20] == 160


def test_a_photo_is_874_patches_and_21_unet_calls():
    """720x480 at grid_r 16: 23 x 38 patches of 128x128; a call counts the
    21 UNet calls its output needs, each 124.54 GFLOP a patch, as the
    port's own work counter counts a forward, and the convolutions of all
    25 the chain runs."""
    raw = _raw()
    assert pixel.patches(raw, 480, 720) == 874
    one = pixel.unet_forward(raw, 1)
    assert abs(one["total"] / 1e9 - 124.544) < 1e-3
    assert one["conv"] / one["total"] > 0.99
    call = pixel.restore_call(raw, 1, 480, 720)
    assert call["total"] == pytest.approx(one["total"] * 874 * 21)
    assert call["conv"] == pytest.approx(one["conv"] * 874 * 25)
    cfg = config_from_dict(json.loads(json.dumps(raw)))
    with torch.device("meta"):
        unet = DiffusionUNet.from_config(cfg)
        x = torch.empty(2, unet.conv_in.weight.shape[1], 128, 128)
    assert unet.conv_in.weight.shape[1] == 6
    with torch.no_grad():
        port = count_work(unet, x, torch.zeros(2, device="meta")).flops
    assert pixel.unet_forward(raw, 2)["total"] == port
    # the wavelet count (``flops.unet_forward``) gives the pixel UNet's
    # conv_in the wavelet model's 9 input channels: more work
    assert flops.unet_forward(raw, 2)["total"] > port


def test_discarded_step_pct_reads_the_chain_counters():
    read = registry.metric("discarded_step_pct.restore").read
    counts = {"chain.steps_run": 50, "chain.steps_after_kept": 8}
    rec = {"kind": "restore", "trace": {"chain_counts": counts}}
    assert read(rec) == 16.0
    assert read(dict(rec, kind="train")) is None
    assert read({"kind": "restore", "trace": None}) is None
    assert read({"kind": "restore", "trace": {"calls": 2}}) is None
    assert read({"kind": "restore", "trace": {"chain_counts": None}}) is None
    none_run = {"chain.steps_run": 0, "chain.steps_after_kept": 0}
    assert read({"kind": "restore",
                 "trace": {"chain_counts": none_run}}) is None


def _tiny_pixel(trace=False, extra=F32, **wl):
    torch.manual_seed(0)
    return run_cell("restore_pixel_b1", SEED, 0.3, trace, "cpu", 0.0,
                    config_overrides=PIXEL_TINY + list(extra),
                    workload_overrides=dict(RESTORE, **wl))


def test_a_tiny_pixel_cell_runs_and_reads_every_metric():
    """A traced tiny run: correct, and every restore metric the cell is
    listed for reads, ``discarded_step_pct.restore`` 1 step of 5."""
    res = _tiny_pixel(trace=True)
    assert res["correct"]
    assert res["checked"]["img_rms_gap"]["value"] < 1e-6
    listed = {m["name"] for m in registry.benchmark()["per_layer"]
              if "restore_pixel_b1" in m["workloads"]}
    # mfu, rooflines and peak memory read the card's peak and memory only
    card = {"mfu.restore", "conv_roofline.restore", "idle_pct.restore",
            "peak_mem_gib.restore"}
    assert listed - card <= set(res["metrics"])
    assert res["metrics"]["discarded_step_pct.restore"]["value"] == 20.0
    assert "restore_img_per_s" in _tiny_pixel()["metrics"]


def test_the_fp8_control_fails_a_pixel_restore():
    ctx = make_ctx("restore_pixel_b1", SEED, 0.0, False, "cpu", 0.0,
                   config_overrides=PIXEL_TINY,
                   workload_overrides=RESTORE)
    out = pixel_control(ctx, "fp8")["control"]
    assert not judge(out, ctx.workload["limits"])[0]


@pytest.fixture(scope="module")
def tiny_split(tmp_path_factory):
    """Six 64x96 PNG pairs in ``input/`` and ``gt/``, as a path from the
    repository's root."""
    root = tmp_path_factory.mktemp("split")
    rng = np.random.default_rng(0)
    for sub in ("input", "gt"):
        os.makedirs(root / sub)
        for i in range(6):
            write_png(str(root / sub / f"{i:04d}.png"),
                      rng.integers(0, 256, (64, 96, 3), dtype=np.uint8))
    return os.path.relpath(root, registry.REPO)


train_stream = registry.runner("train_stream")


def _tiny_stream(split, trace=False, **wl):
    torch.manual_seed(0)
    return run_cell("train_prod_stream", SEED, 0.3, trace, "cpu", 0.0,
                    config_overrides=TINY + ["training.patch_n=2"],
                    workload_overrides=dict(images=split, pairs=9, batch=4,
                                            slots=4, trace_steps=10, **wl))


def test_a_tiny_stream_cell_trains_on_the_stream(tiny_split):
    """Traced: correct against the reference on the crops the stream gave,
    each crop a window of its pair, and every train metric it is listed
    for reads but those of the card; the written pairs are gone after."""
    res = _tiny_stream(tiny_split, trace=True)
    assert res["correct"]
    assert res["checked"]["crop_gap"]["value"] < 1e-7
    listed = {m["name"] for m in registry.benchmark()["per_layer"]
              if "train_prod_stream" in m["workloads"]}
    card = {"mfu.train", "conv_roofline.train", "idle_pct.train",
            "peak_mem_gib.train"}
    assert listed - card <= set(res["metrics"])
    cache = os.path.join(registry.ROOT, "_cache")
    assert not [d for d in os.listdir(cache) if d.startswith("stream-")]


def test_the_stream_needs_its_source_pairs():
    with pytest.raises(FileNotFoundError, match="no/such/split has no"):
        _tiny_stream("no/such/split")


def test_the_stream_links_its_source_pairs(tiny_split):
    """Pair i of the linked split is pair i mod 6 of the source, the source
    read as ``input/`` with ``gt/`` of the same name."""
    split = train_stream.link_pairs(dict(images=tiny_split, pairs=9))
    try:
        src = os.path.join(registry.REPO, tiny_split)
        for sub in ("input", "gt"):
            names = sorted(os.listdir(os.path.join(split, sub)))
            assert names == [f"{i:04d}.png" for i in range(9)]
            for i, name in enumerate(names):
                assert os.path.islink(os.path.join(split, sub, name))
                with open(os.path.join(split, sub, name), "rb") as a, \
                        open(os.path.join(src, sub, f"{i % 6:04d}.png"),
                             "rb") as b:
                    assert a.read() == b.read()
    finally:
        shutil.rmtree(split)


def test_crop_gap_finds_each_crop_in_its_pair():
    """0 for windows of the pairs; a crop one level off, or from no pair,
    reads at least 1/255, far above the limit."""
    rng = np.random.default_rng(3)
    pairs = rng.integers(0, 256, (3, 40, 50, 6), dtype=np.uint8)
    crops = np.stack([pairs[1][5:21, 9:25], pairs[2][24:40, 0:16]]
                     ).astype(np.float32) / 255.0
    limit = registry.workload("train_prod_stream")["limits"]["crop_gap"]
    assert train_stream.crop_gap(crops, pairs) < 1e-7 < limit
    off = crops.copy()
    off[1, 3, 4, 2] += 1.0 / 255.0
    assert train_stream.crop_gap(off, pairs) == pytest.approx(1 / 255,
                                                              rel=1e-5)
    other = rng.integers(0, 256, (1, 16, 16, 6)).astype(np.float32) / 255
    assert train_stream.crop_gap(other, pairs) > limit


# the kernels a pixel restore (720x480, bf16, torch 2.11.0+cu128, NVIDIA
# H100 80GB HBM3) ran inside its convolutions, names cut short: cuDNN's
@pytest.mark.parametrize("name", [
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
    "void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16,",
    "void cudnn::engines_precompiled::nhwcToNchwKernel<__nv_bfloat16,",
    "void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop",
    "sm80_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
    "void tensorTransformGeneric<__nv_bfloat16, __nv_bfloat16, float, "
    "true, false, false, (cudnnKernelDataType_t)0>",
    "void cask_plugin__5x_cudnn::xmma__5x_cudnn::init_device_workspace",
])
def test_every_conv_kernel_of_a_pixel_restore_is_in_a_conv_family(name):
    fams = Families(registry.families())
    assert fams.of(name) in fams.conv


# and cuBLASLt's nvjet kernels, which run its 1x1 convolutions there and
# the linear layers' and attention's matmuls in every cell: no name tells
# the two apart, so no family holds them and they read as "other"
@pytest.mark.parametrize("name", [
    "nvjet_tst_256x128_64x4_2x1_v_bz_coopA_NNT",
    "nvjet_tst_128x192_64x5_2x1_v_ssched_bz_coopB_TNN",
    "nvjet_tst_32x128_64x10_1x2_h_ssched_bz_NNN",
    "nvjet_tst_128x224_64x4_2x1_v_bz_coopA_TNT",
])
def test_cublaslt_kernels_are_in_no_family(name):
    assert Families(registry.families()).of(name) == "other"
