"""PyTorch port on the card: each CUDA kernel against its plain version,
a small restoration and a train step through the kernels against the CPU
path, the GroupNorm kernel's refusal of autograd and the wavelet kernels'
gradient.

Marked ``cuda``; every test skips where no card is present.  On the GPU
machine (which has no jax, so the JAX conftest is left out):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from wavedm_tpu_torch.ops import groupnorm_cuda, wavelet_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(1, 3, 8, 12), (2, 3, 480, 720),
                                   (3, 5, 36, 20), (2, 3, 16, 36),
                                   (1, 2, 24, 20)])
def test_wavelet_kernels_match_plain(cuda, shape):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.rand(shape, device=cuda, generator=g) * 2 - 1
    z = wavelet_cuda.wavelet_dec_cuda(x)
    torch.testing.assert_close(z, wavelet_cuda.wavelet_dec_plain(x),
                               atol=2e-6, rtol=0)
    back = wavelet_cuda.wavelet_rec_cuda(z)
    torch.testing.assert_close(back, wavelet_cuda.wavelet_rec_plain(z),
                               atol=2e-6, rtol=0)
    torch.testing.assert_close(back, x, atol=2e-6, rtol=0)


# GroupNorm shapes -> the launch plan (cluster blocks a segment, segments a
# block) in float32 and bfloat16: every branch of group_norm_plan, the
# flagship's widest site, HW not a multiple of the vector, and the stream
# kernel for segments too large to hold on chip.
GN_PLANS = {
    (4, 384, 64, 64): ((2, 1), (1, 1)),
    (90, 1536, 8, 8): ((1, 1), (1, 2)),       # 128 threads; bf16 packed
    (2, 64, 5, 7): ((1, 1), (1, 1)),          # element by element
    (1, 32, 1, 3): ((1, 1), (1, 1)),
    (90, 384, 64, 64): ((2, 1), (1, 1)),      # the widest flagship site
    (2, 128, 64, 64): ((1, 1), (1, 1)),
    (1, 512, 64, 64): ((4, 1), (2, 1)),
    (1, 1024, 64, 64): ((8, 1), (4, 1)),
    (1, 2048, 64, 64): ((8, 1), (8, 1)),
    (90, 256, 16, 16): ((1, 2), (1, 2)),      # two segments a block
    (90, 128, 32, 32): ((1, 1), (1, 2)),
    (2, 64, 16, 16): ((1, 1), (1, 1)),
    (2, 256, 1, 1): ((1, 1), (1, 1)),         # HW = 1
    (1, 64, 150, 151): ((2, 1), (1, 1)),      # a cluster, element by element
    (1, 64, 512, 512): ((0, 1), (8, 1)),      # 0: the stream kernel
    (1, 128, 512, 512): ((0, 1), (0, 1)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("swish", [False, True])
@pytest.mark.parametrize("shape", list(GN_PLANS))
def test_group_norm_kernel_matches_plain(cuda, shape, swish, dtype):
    plan = groupnorm_cuda.group_norm_plan(shape[0], shape[1],
                                          shape[2] * shape[3], 32, dtype)
    assert (plan.cluster, plan.segs_per_cta) == \
        GN_PLANS[shape][dtype == torch.bfloat16]
    g = torch.Generator(device=cuda).manual_seed(1)
    x = (torch.randn(shape, device=cuda, generator=g) * 3 + 1).to(dtype)
    w = torch.randn(shape[1], device=cuda, generator=g)
    b = torch.randn(shape[1], device=cuda, generator=g)
    y = groupnorm_cuda.group_norm(x, w, b, 32, 1e-6, swish)
    ref = groupnorm_cuda.group_norm_plain(x, w, b, 32, 1e-6, swish)
    assert y.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(y, ref, atol=2e-5, rtol=2e-5)
    else:   # one bf16 ulp where the float32 value sits on a boundary
        torch.testing.assert_close(y.float(), ref.float(), atol=1e-6,
                                   rtol=2.0 ** -6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_kernel_takes_unaligned_tensors(cuda, dtype):
    """A contiguous view that starts off a 16-byte boundary cannot take
    vector loads or bulk copies: the kernel runs it element by element."""
    g = torch.Generator(device=cuda).manual_seed(3)
    flat = torch.randn(1 + 2 * 64 * 16 * 16, device=cuda, generator=g)
    x = (flat * 3 + 1).to(dtype)[1:].view(2, 64, 16, 16)
    assert x.data_ptr() % 16
    w = torch.randn(64, device=cuda, generator=g)
    b = torch.randn(64, device=cuda, generator=g)
    y = groupnorm_cuda.group_norm(x, w, b, 32, 1e-6, True)
    ref = groupnorm_cuda.group_norm_plain(x, w, b, 32, 1e-6, True)
    if dtype == torch.float32:
        torch.testing.assert_close(y, ref, atol=2e-5, rtol=2e-5)
    else:
        torch.testing.assert_close(y.float(), ref.float(), atol=1e-6,
                                   rtol=2.0 ** -6)


def test_wrappers_count_launches(cuda):
    before = (wavelet_cuda.launches["wavelet_dec"],
              groupnorm_cuda.launches["f32_swish"])
    x = torch.zeros(1, 32, 4, 4, device=cuda)
    wavelet_cuda.wavelet_dec_cuda(x)
    groupnorm_cuda.group_norm(x, torch.ones(32, device=cuda),
                              torch.zeros(32, device=cuda), swish=True)
    assert (wavelet_cuda.launches["wavelet_dec"],
            groupnorm_cuda.launches["f32_swish"]) == (before[0] + 1,
                                                      before[1] + 1)


def test_small_restoration_matches_cpu(cuda):
    from wavedm_tpu_torch.config import Config, DataConfig, ModelConfig
    from wavedm_tpu_torch.inference.loader import build_restorer

    cfg = Config()
    cfg.data = DataConfig(image_size=8, patch_size=32)
    cfg.model = ModelConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                            attn_resolutions=(4,))
    cfg.hfrm.dim, cfg.hfrm.middle_blk_num = 8, 1
    cfg.hfrm.enc_blk_nums = cfg.hfrm.dec_blk_nums = (1, 1)
    cfg.sampling.sampling_timesteps = 5
    cfg.parallel.fused_groupnorm = True
    cfg.validate()
    images = np.random.default_rng(0).random((2, 64, 96, 3), dtype=np.float32)
    noise = torch.randn(2, 3, 16, 24, generator=torch.Generator().manual_seed(0))
    cpu = build_restorer(cfg, None, None, device="cpu")
    gpu = build_restorer(cfg, cpu.unet.state_dict(), cpu.hfrm.state_dict(),
                         device=cuda)
    ref, _ = cpu.restore_image(images, noise=noise)
    out, _ = gpu.restore_image(images, noise=noise)
    np.testing.assert_allclose(out, ref, atol=1e-4)


@pytest.mark.parametrize("variant", [
    dict(solver="dpmpp2m"), dict(pred_type="v"), dict(eta=0.5),
    dict(patch_micro_batch=3), dict(whole_image=True),
], ids=["dpmpp2m", "v", "eta0.5", "micro_batch3", "whole_image"])
def test_small_restoration_variants_match_cpu(cuda, variant):
    """The sampler's other chains through the kernels, against the CPU;
    at eta > 0 both sides take the same injected step noise."""
    from wavedm_tpu_torch.config import config_from_dict
    from wavedm_tpu_torch.inference.loader import build_restorer

    variant = dict(variant)
    pred_type = variant.pop("pred_type", "eps")
    cfg = config_from_dict({
        "data": {"image_size": 8, "patch_size": 32},
        "model": {"ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1,
                  "attn_resolutions": [4]},
        "hfrm": {"dim": 8, "enc_blk_nums": [1, 1], "middle_blk_num": 1,
                 "dec_blk_nums": [1, 1]},
        "training": {"pred_type": pred_type},
        "sampling": {"sampling_timesteps": 5, **variant},
        "parallel": {"fused_groupnorm": True}})
    images = np.random.default_rng(0).random((2, 64, 96, 3), dtype=np.float32)
    g = torch.Generator().manual_seed(0)
    noise = torch.randn(2, 3, 16, 24, generator=g)
    step_noise = torch.randn(5, 2, 3, 16, 24, generator=g)
    cpu = build_restorer(cfg, None, None, device="cpu")
    gpu = build_restorer(cfg, cpu.unet.state_dict(), cpu.hfrm.state_dict(),
                         device=cuda)
    ref, _ = cpu.restore_image(images, noise=noise, step_noise=step_noise)
    out, _ = gpu.restore_image(images, noise=noise, step_noise=step_noise)
    np.testing.assert_allclose(out, ref, atol=1e-4)


# The flagship UNet's sites on the whole-image path (sampling.whole_image):
# two 720x480 images reach it as (2, 96, 120, 184) wavelet inputs, so its
# levels run at 120x184, 60x92, 30x46 and 15x23, neither square nor powers
# of two.  GroupNorm (C, H, W, swish) and GN -> swish -> conv3x3
# (Cin, H, W, Cout), from a forward on the meta device.
WHOLE_GN_SITES = [
    (128, 60, 92, True), (128, 120, 184, True), (256, 30, 46, True),
    (256, 60, 92, True), (256, 120, 184, True), (384, 60, 92, True),
    (384, 120, 184, True), (512, 15, 23, True), (512, 30, 46, False),
    (512, 30, 46, True), (512, 60, 92, True), (768, 15, 23, False),
    (768, 15, 23, True), (768, 30, 46, True), (768, 60, 92, True),
    (1024, 30, 46, True), (1280, 15, 23, True), (1280, 30, 46, True),
    (1536, 15, 23, True)]
WHOLE_FUSED_SITES = [
    (128, 60, 92, 256), (128, 120, 184, 128), (256, 30, 46, 512),
    (256, 60, 92, 256), (256, 120, 184, 128), (384, 60, 92, 256),
    (384, 120, 184, 128), (512, 15, 23, 768), (512, 30, 46, 512),
    (512, 60, 92, 256), (768, 15, 23, 768), (768, 30, 46, 512),
    (768, 60, 92, 256), (1024, 30, 46, 512), (1280, 15, 23, 768),
    (1280, 30, 46, 512), (1536, 15, 23, 768)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("site", WHOLE_GN_SITES,
                         ids=lambda s: "{}x{}x{}{}".format(
                             *s[:3], "_swish" if s[3] else ""))
def test_group_norm_kernel_at_whole_image_sites(cuda, site, dtype):
    """Tolerances as test_group_norm_kernel_matches_plain."""
    c, h, w, swish = site
    g = torch.Generator(device=cuda).manual_seed(4)
    x = (torch.randn(2, c, h, w, device=cuda, generator=g) * 3 + 1).to(dtype)
    wt = torch.randn(c, device=cuda, generator=g)
    b = torch.randn(c, device=cuda, generator=g)
    y = groupnorm_cuda.group_norm(x, wt, b, 32, 1e-6, swish)
    ref = groupnorm_cuda.group_norm_plain(x, wt, b, 32, 1e-6, swish)
    if dtype == torch.float32:
        torch.testing.assert_close(y, ref, atol=2e-5, rtol=2e-5)
    else:
        torch.testing.assert_close(y.float(), ref.float(), atol=1e-6,
                                   rtol=2.0 ** -6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("site", WHOLE_FUSED_SITES,
                         ids=lambda s: "{}x{}x{}to{}".format(*s))
def test_fused_kernel_at_whole_image_sites(cuda, site, dtype):
    """Tolerances as test_fused_kernel_matches_plain; W = 184 is wider than
    the 130-pixel halo run, so the three runs stay apart."""
    from wavedm_tpu_torch.ops import fused_resblock as fr

    cin, h, w, cout = site
    args = _fused_inputs(cuda, 2, cin, cout, h, w, dtype)
    out = fr.fused_gn_swish_conv(*args, dtype)
    ref = fr.fused_gn_swish_conv_plain(*args, dtype)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    err = float((out.float() - ref.float()).abs().max())
    assert err <= tol * float(ref.float().abs().max()), err


# The flagship UNet's 17 GN -> swish -> conv3x3 site shapes (H = W, Cin,
# Cout) at 64x64 patches: chip_smoke.fused_sites derives them.
FUSED_SHAPES = [(64, 128, 128), (64, 256, 128), (64, 384, 128),
                (32, 128, 256), (32, 256, 256), (32, 384, 256), (32, 512, 256),
                (32, 768, 256), (16, 256, 512), (16, 512, 512), (16, 768, 512),
                (16, 1024, 512), (16, 1280, 512), (8, 512, 768), (8, 768, 768),
                (8, 1280, 768), (8, 1536, 768)]


def _fused_inputs(device, n, cin, cout, h, w, dtype, seed=2):
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(n, cin, h, w, device=device, generator=g) * 2
         + 0.5).to(dtype)
    sg = torch.randn(cin, device=device, generator=g) * 0.1 + 1
    bg = torch.randn(cin, device=device, generator=g) * 0.1
    wk = torch.randn(cout, cin, 3, 3, device=device, generator=g) \
        * (9 * cin) ** -0.5
    b = torch.randn(cout, device=device, generator=g) * 0.1
    return x, sg, bg, wk, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FUSED_SHAPES + [(5, 64, 96), (7, 32, 3)],
                         ids=lambda s: f"{s[0]}x{s[0]}_{s[1]}to{s[2]}")
def test_fused_kernel_matches_plain(cuda, shape, dtype):
    """f32: 1e-4 of the output scale (summation order only; TF32 off).
    bf16: both round the same y once; the outputs round float32 sums taken
    in another order, so they may part by a bf16 ulp (2**-7 of the scale)."""
    from wavedm_tpu_torch.ops import fused_resblock as fr

    h, cin, cout = shape
    key = "fused_gn_swish_conv_" + ("f32" if dtype == torch.float32
                                    else "bf16")
    args = _fused_inputs(cuda, 2, cin, cout, h, h + 3 * (h < 8), dtype)
    before = fr.launches[key]
    out = fr.fused_gn_swish_conv(*args, dtype)
    ref = fr.fused_gn_swish_conv_plain(*args, dtype)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == ref.shape
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    err = float((out.float() - ref.float()).abs().max())
    assert err <= tol * float(ref.float().abs().max()), err
    assert fr.launches[key] == before + 1


@pytest.mark.parametrize("dtypes", [(torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.float32)],
                         ids=["f32x_bf16compute", "bf16x_f32compute"])
@pytest.mark.parametrize("shape", [FUSED_SHAPES[0], FUSED_SHAPES[9],
                                   FUSED_SHAPES[16], (5, 64, 96)],
                         ids=lambda s: f"{s[0]}x{s[0]}_{s[1]}to{s[2]}")
def test_fused_kernel_mixed_dtypes_match_plain(cuda, shape, dtypes):
    """x in one dtype, the compute dtype the other; the output takes x's
    dtype.  Held to the compute dtype's tolerance of the output scale
    (f32 1e-4, bf16 2**-7, as above); a bfloat16 output may besides round
    a float32 sum to the other side of a bf16 boundary: one bf16 ulp, at
    most 2**-7 of the element."""
    from wavedm_tpu_torch.ops import fused_resblock as fr

    x_dtype, compute = dtypes
    h, cin, cout = shape
    key = "fused_gn_swish_conv_" + ("f32" if compute == torch.float32
                                    else "bf16")
    args = _fused_inputs(cuda, 2, cin, cout, h, h + 3 * (h < 8), x_dtype)
    before = fr.launches[key]
    out = fr.fused_gn_swish_conv(*args, compute)
    ref = fr.fused_gn_swish_conv_plain(*args, compute)
    torch.cuda.synchronize()
    assert out.dtype == x_dtype and out.shape == ref.shape
    tol = 1e-4 if compute == torch.float32 else 2.0 ** -7
    ulp = 2.0 ** -7 if x_dtype == torch.bfloat16 else 0.0
    excess = (out.float() - ref.float()).abs() - ulp * ref.float().abs()
    assert float(excess.max()) <= tol * float(ref.float().abs().max())
    assert fr.launches[key] == before + 1


def test_fused_kernel_sees_in_place_weight_updates(cuda):
    """Serving caches the kernel's weight layout per frozen weight; an
    in-place copy_ or load_state_dict must reach the next call."""
    from wavedm_tpu_torch.ops import fused_resblock as fr

    x, sg, bg, w, b = _fused_inputs(cuda, 2, 64, 96, 8, 8, torch.float32)
    conv = torch.nn.Conv2d(64, 96, 3, padding=1).to(cuda).requires_grad_(False)
    conv.weight.copy_(w)
    first = fr.fused_gn_swish_conv(x, sg, bg, conv.weight, b, torch.float32)
    assert fr.kernel_weight(conv.weight, torch.float32) is \
        fr.kernel_weight(conv.weight, torch.float32)
    for update in (lambda w2: conv.weight.copy_(w2),
                   lambda w2: conv.load_state_dict({"weight": w2,
                                                    "bias": conv.bias})):
        w2 = torch.randn_like(w) * 0.05
        update(w2)
        out = fr.fused_gn_swish_conv(x, sg, bg, conv.weight, b,
                                     torch.float32)
        ref = fr.fused_gn_swish_conv_plain(x, sg, bg, w2, b, torch.float32)
        torch.cuda.synchronize()
        assert float((out - first).abs().max()) > 0.1
        err = float((out - ref).abs().max())
        assert err <= 1e-4 * float(ref.abs().max()), err


@pytest.mark.parametrize("shape", [(16, 256, 512), (8, 64, 96)])
def test_fused_gradients_match_autograd_of_the_composition(cuda, shape):
    from wavedm_tpu_torch.ops import fused_resblock as fr

    h, cin, cout = shape
    args = [t.requires_grad_() for t in
            _fused_inputs(cuda, 2, cin, cout, h, h, torch.float32)]
    ref_args = [t.detach().clone().requires_grad_() for t in args]
    g = torch.randn(2, cout, h, h, device=cuda)
    (fr.fused_gn_swish_conv(*args, torch.float32) * g).sum().backward()
    (fr.fused_gn_swish_conv_reference(*ref_args, torch.float32)
     * g).sum().backward()
    for a, r in zip(args, ref_args):
        err = float((a.grad - r.grad).abs().max())
        assert err <= 1e-4 * float(r.grad.abs().max()), err


def test_kernel_wrappers_refuse_autograd_on_the_card(cuda):
    """The GroupNorm kernel has no gradient: under autograd it raises
    rather than hand back a tensor that cuts the graph.  The wavelet
    kernels have one (``test_wavelet_gradients_match_plain_autograd``)."""
    x = torch.randn(1, 32, 8, 8, device=cuda, requires_grad=True)
    w, b = torch.ones(32, device=cuda), torch.zeros(32, device=cuda)
    with pytest.raises(RuntimeError, match="no gradient"):
        groupnorm_cuda.group_norm(x, w, b, swish=True)
    with torch.no_grad():
        groupnorm_cuda.group_norm(x, w, b, swish=True)
    assert wavelet_cuda.wavelet_dec_cuda(x[:, :3]).requires_grad


@pytest.mark.parametrize("shape", [(3, 6, 16, 24), (2, 9, 256, 256)])
def test_wavelet_gradients_match_plain_autograd(cuda, shape):
    """The DWT of two channel slices, read in place, and the IWT of the
    result under autograd on the card: forward and backward (each Function
    launching the other kernel) against plain autograd of the plain
    versions, within 1e-6 of the gradient's scale."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = (torch.rand(shape, device=cuda, generator=g) * 2 - 1
         ).requires_grad_()
    xp = x.detach().clone().requires_grad_()
    before = dict(wavelet_cuda.launches)
    z = wavelet_cuda.wavelet_dec_cat([x[:, :3], x[:, 3:]])
    y = wavelet_cuda.wavelet_rec_cuda(z[:, :48] * 2.0)
    zp = torch.cat([wavelet_cuda.wavelet_dec_plain(xp[:, :3]),
                    wavelet_cuda.wavelet_dec_plain(xp[:, 3:])], dim=1)
    yp = wavelet_cuda.wavelet_rec_plain(zp[:, :48] * 2.0)
    w = torch.randn(y.shape, device=cuda, generator=g)
    ((y * w).sum() + z.square().sum()).backward()
    ((yp * w).sum() + zp.square().sum()).backward()
    torch.testing.assert_close(y, yp, atol=2e-6, rtol=0)
    err = float((x.grad - xp.grad).abs().max())
    assert err <= 1e-6 * float(xp.grad.abs().max()), err
    got = {k: v - before[k] for k, v in wavelet_cuda.launches.items()}
    assert got == {"wavelet_dec": 2, "wavelet_rec": 1,
                   "wavelet_dec_backward": 2, "wavelet_rec_backward": 1}


def test_train_step_matches_cpu(cuda):
    """One SGD step of a small fused-resblock UNet on the card (kernels)
    against the same step on the CPU (plain versions), float32."""
    from wavedm_tpu_torch.config import config_from_dict
    from wavedm_tpu_torch.inference.loader import build_unet
    from wavedm_tpu_torch.training.state import create_train_state
    from wavedm_tpu_torch.training.train_step import make_train_step

    cfg = config_from_dict({
        "data": {"image_size": 8, "patch_size": 32},
        "model": {"ch": 64, "ch_mult": [1, 2], "num_res_blocks": 1,
                  "attn_resolutions": [4]},
        "diffusion": {"num_diffusion_timesteps": 50},
        "optim": {"optimizer": "SGD", "lr": 1e-5},
        "parallel": {"fused_resblock": True}})
    batch = np.random.default_rng(0).random((4, 32, 32, 6), dtype=np.float32)
    t = torch.tensor([3, 46, 20, 29])
    e = torch.randn(4, 3, 8, 8, generator=torch.Generator().manual_seed(1))
    out, weights = [], None
    for dev in ("cpu", cuda):
        # the CPU model's random weights, carried to the card
        model = build_unet(cfg, weights, dev, train=True)
        weights = weights or {k: v.clone()
                              for k, v in model.state_dict().items()}
        state = create_train_state(model, cfg.optim, 0)
        m = make_train_step(cfg, model)(state, batch, t=t, e=e)
        out.append((float(m.loss), {k: v.cpu() for k, v in
                                    model.state_dict().items()}))
    (l_cpu, sd_cpu), (l_gpu, sd_gpu) = out
    assert abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu)
    for k in sd_cpu:
        err = float((sd_gpu[k] - sd_cpu[k]).abs().max())
        assert err <= 1e-4 * float(sd_cpu[k].abs().max()), k


def test_device_cache_on_the_card_equals_the_cpu(cuda):
    from wavedm_tpu_torch.data.device_cache import DeviceCropCache, to_unit

    # uint8 / 255 correctly rounded on the card too, as numpy divides
    x = torch.arange(256, dtype=torch.uint8)
    assert torch.equal(to_unit(x.to(cuda)).cpu(),
                       torch.from_numpy(x.numpy().astype(np.float32) / 255.0))

    rng = np.random.default_rng(3)
    pairs = rng.integers(0, 256, (4, 480, 720, 6), dtype=np.uint8)
    order = rng.permutation(4)
    caches = [DeviceCropCache(pairs, 256, dev) for dev in ("cpu", cuda)]
    coords = np.concatenate(list(caches[0].draw_coords(order, 61, 2, 8)))
    want = caches[0].crop_batch(coords)
    got = caches[1].crop_batch(coords)
    assert got.device.type == "cuda" and got.shape == (32, 256, 256, 6)
    assert torch.equal(got.cpu(), want)


def hfrm_step_on(device, weights=None):
    """One HFRMTrainer step of a small HFRM (float32) from random weights
    with nonzero residual scales; returns the loss, the PSNR, the
    gradients and the weights it started from."""
    from wavedm_tpu_torch.config import config_from_dict
    from wavedm_tpu_torch.inference.loader import init_random_
    from wavedm_tpu_torch.training.hfrm_trainer import HFRMTrainer

    cfg = config_from_dict({"hfrm": {"dim": 16, "enc_blk_nums": [1, 1],
                                     "middle_blk_num": 1,
                                     "dec_blk_nums": [1, 1]}})
    trainer = HFRMTrainer(cfg, device=device, log_fn=lambda s: None)
    if weights is None:
        init_random_(trainer.model, torch.Generator(device=device)
                     .manual_seed(0))
        with torch.no_grad():
            for name, p in trainer.model.named_parameters():
                if name.endswith(("beta", "gamma")):
                    p.fill_(0.5)
        weights = {k: v.cpu().clone()
                   for k, v in trainer.model.state_dict().items()}
    trainer.model.load_state_dict(weights)
    batch = np.random.default_rng(1).random((2, 64, 96, 6), dtype=np.float32)
    loss, psnr = trainer.train_step(batch)
    grads = {k: p.grad.cpu() for k, p in trainer.model.named_parameters()}
    return float(loss), float(psnr), grads, weights


def test_hfrm_train_step_matches_cpu(cuda):
    l_cpu, p_cpu, g_cpu, weights = hfrm_step_on("cpu")
    l_gpu, p_gpu, g_gpu, _ = hfrm_step_on(cuda, weights)
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    assert abs(p_gpu - p_cpu) <= 1e-5 * abs(p_cpu)
    for k, g in g_cpu.items():
        err = float((g_gpu[k] - g).abs().max())
        assert err <= 1e-4 * max(float(g.abs().max()), 1e-30), k
