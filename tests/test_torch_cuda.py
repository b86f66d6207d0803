"""PyTorch port on the card: each CUDA kernel against its plain version,
the GroupNorm kernel with the default route's rounding against that
route's eager chain (also past 2**31 elements, at the pixel model's
largest site), the kernel's launches in a pixel restore, a small
restoration and a train step through the kernels against the CPU path,
the GroupNorm kernel's refusal of autograd and the wavelet kernels'
gradient.

Marked ``cuda``; every test skips where no card is present.  On the GPU
machine (which has no jax, so the JAX conftest is left out):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from wavedm_tpu_torch.ops import groupnorm_cuda, wavelet_cuda
from wavedm_tpu_torch.ops.wavelet import haar_packet_basis

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


def _blocks(x):
    """(B, C, H, W) -> (B, C, H/4, W/4, 16): each 4x4 block, pixel 4p + q."""
    b, c, h, w = x.shape
    return x.reshape(b, c, h // 4, 4, w // 4, 4).permute(
        0, 1, 2, 4, 3, 5).reshape(b, c, h // 4, w // 4, 16)


def ordered_dwt(x):
    """The DWT as the kernel sums it: each coefficient the float32 sum of
    its 16 terms in the order k = 0..15, each term exact (the basis is
    +-1/4), so one rounding an addition as in its fmaf chain."""
    m = torch.as_tensor(haar_packet_basis(2), dtype=torch.float32,
                        device=x.device)
    blk = _blocks(x)
    out = []
    for f in range(16):
        acc = torch.zeros(blk.shape[:-1], device=x.device)
        for k in range(16):
            acc = acc + blk[..., k] * m[k, f]
        out.append(acc)
    b, c, h, w = blk.shape[:4]
    return torch.stack(out, 1).reshape(b, 16 * c, h, w)


def ordered_iwt(z):
    """The IWT as the kernel sums it: pixel k the float32 sum over f =
    0..15 of coefficient f times basis(k, f), in order."""
    m = torch.as_tensor(haar_packet_basis(2), dtype=torch.float32,
                        device=z.device)
    b, fc, h, w = z.shape
    co = z.reshape(b, 16, fc // 16, h, w)
    px = []
    for k in range(16):
        acc = torch.zeros(co[:, 0].shape, device=z.device)
        for f in range(16):
            acc = acc + co[:, f] * m[k, f]
        px.append(acc)
    x = torch.stack(px, -1).reshape(b, fc // 16, h, w, 4, 4)
    return x.permute(0, 1, 2, 4, 3, 5).reshape(b, fc // 16, 4 * h, 4 * w)


# W = 8, 24, 40, 72: w = 2, 6, 10, 18 coefficients a row, so coefficient
# rows start off 16 bytes and a row is not a whole number of 4-block
# groups; odd H/4; 1 and 8 images; the main path's shape
WAVELET_TAILS = [(1, 3, 12, 8), (8, 3, 20, 24), (1, 2, 36, 40),
                 (8, 3, 12, 72), (3, 5, 28, 40), (2, 3, 480, 720),
                 (8, 3, 480, 720), (1, 3, 480, 720)]


@pytest.mark.parametrize("shape", WAVELET_TAILS)
def test_wavelet_kernels_at_tail_shapes(cuda, shape):
    """Both kernels against their plain versions within the stated 2e-6,
    and equal to the kernel's own summation order bit for bit (0 error);
    under no_grad (the direct launch) and under autograd (the Functions,
    each kernel the other's backward) alike."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.rand(shape, device=cuda, generator=g) * 2 - 1
    with torch.no_grad():
        z = wavelet_cuda.wavelet_dec_cuda(x)
        back = wavelet_cuda.wavelet_rec_cuda(z)
    assert z.grad_fn is None and back.grad_fn is None
    torch.testing.assert_close(z, wavelet_cuda.wavelet_dec_plain(x),
                               atol=2e-6, rtol=0)
    torch.testing.assert_close(back, wavelet_cuda.wavelet_rec_plain(z),
                               atol=2e-6, rtol=0)
    assert torch.equal(z, ordered_dwt(x))
    assert torch.equal(back, ordered_iwt(z))
    torch.testing.assert_close(back, x, atol=2e-6, rtol=0)
    # each Function's backward is the other kernel on the gradient
    xg = x.clone().requires_grad_()
    zg = wavelet_cuda.wavelet_dec_cuda(xg)
    assert torch.equal(zg.detach(), z)
    gz = torch.randn(z.shape, device=cuda, generator=g)
    zg.backward(gz)
    assert torch.equal(xg.grad, ordered_iwt(gz))
    zr = z.clone().requires_grad_()
    gx = torch.randn(x.shape, device=cuda, generator=g)
    wavelet_cuda.wavelet_rec_cuda(zr).backward(gx)
    assert torch.equal(zr.grad, ordered_dwt(gx))


@pytest.mark.parametrize("shape", [(2, 3, 12, 24), (3, 2, 20, 16),
                                   (8, 3, 480, 720)])
@pytest.mark.parametrize("offset, pad", [(1, 3), (2, 1), (0, 5)])
def test_wavelet_coefficients_off_16_bytes(cuda, shape, offset, pad):
    """The coefficient side at a start and a batch stride that are not
    multiples of 4 floats: the IWT reads such a tensor in place through
    the wrapper, and the DWT entry writes one (the wrapper always hands it
    an aligned output), both equal to the aligned result and leaving the
    gaps alone.  The pixel side refuses such layouts, in the wrapper and
    in the C entry, and still must."""
    b, c, h4, w4 = shape[0], shape[1], shape[2] // 4, shape[3] // 4
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.rand(shape, device=cuda, generator=g) * 2 - 1
    want = ordered_dwt(x)
    size = 16 * c * h4 * w4
    flat = torch.full((offset + b * (size + pad),), float("nan"),
                      device=cuda)
    zs = flat.as_strided((b, 16 * c, h4, w4),
                         (size + pad, h4 * w4, w4, 1), offset)
    lib = wavelet_cuda._build.library()
    wavelet_cuda._build.launch(lib, "wavelet_dec_f32", x.get_device(),
                               x.data_ptr(), zs.data_ptr(), b, c, *shape[2:],
                               x.stride(0) if b > 1 else x[0].numel(),
                               size + pad)
    torch.cuda.synchronize()
    assert torch.equal(zs, want)
    gaps = flat[offset:].view(b, size + pad)[:, size:]
    assert torch.isnan(gaps).all() and torch.isnan(flat[:offset]).all()
    with torch.no_grad():
        back = wavelet_cuda.wavelet_rec_cuda(zs)
    assert torch.equal(back, ordered_iwt(want))
    px = torch.empty(1 + x.numel(), device=cuda)[1:].view(shape)
    with pytest.raises(ValueError):
        wavelet_cuda.wavelet_dec_cuda(px)
    with pytest.raises(RuntimeError, match="invalid argument"):
        wavelet_cuda._build.launch(lib, "wavelet_dec_f32", x.get_device(),
                                   px.data_ptr(), zs.data_ptr(), b, c,
                                   *shape[2:], x.numel() // b, size + pad)


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


# The flagship UNet's norm sites (C, H, W, swish) on a 64x64 patch, from a
# forward on the meta device: 45 GroupNorm+swish sites and 6 attention
# norms over these 19 shapes, the 384- and 256-channel skip concats among
# them.
UNET_GN_SITES = [
    (128, 32, 32, True), (128, 64, 64, True), (256, 16, 16, True),
    (256, 32, 32, True), (256, 64, 64, True), (384, 32, 32, True),
    (384, 64, 64, True), (512, 8, 8, True), (512, 16, 16, False),
    (512, 16, 16, True), (512, 32, 32, True), (768, 8, 8, False),
    (768, 8, 8, True), (768, 16, 16, True), (768, 32, 32, True),
    (1024, 16, 16, True), (1280, 8, 8, True), (1280, 16, 16, True),
    (1536, 8, 8, True)]


def eager_chain(x, weight, bias, swish):
    """The default route's eager chain (``Normalize`` off the kernel):
    (the affine GroupNorm rounded to x's dtype, the output)."""
    aff = F.group_norm(x.float(), 32, weight, bias, 1e-6).to(x.dtype)
    return aff, (F.silu(aff) if swish else aff)


def bf16_ulp(t):
    """One bfloat16 ulp at each element's magnitude (8 significant bits)."""
    mag = t.float().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def assert_rounds_as_eager_chain(out, aff, ref, swish, share=1e-3):
    """``out`` against the eager chain's ``ref`` (its rounded affine
    ``aff``).  float32: the 2e-5 of the kernel's tests.  bfloat16: an
    element differs only where the statistics' float32 rounding flips the
    affine's bfloat16 rounding (at most ``share`` of them), by at most
    one ulp of the output plus, through the swish (slope <= 1.1), one ulp
    of the affine, and 1e-5 where those ulps are finer than the
    statistics' rounding (values near 0)."""
    if out.dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)
        return
    diff = (out.float() - ref.float()).abs()
    bound = bf16_ulp(ref) + (1.1 * bf16_ulp(aff) if swish else 0) + 1e-5
    assert float((diff - bound).max()) <= 0, float(diff.max())
    assert float((diff > 0).float().mean()) <= share


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("site", UNET_GN_SITES, ids=lambda s: "{}x{}x{}{}"
                         .format(*s[:3], "_swish" if s[3] else ""))
def test_round_affine_kernel_matches_the_eager_chain(cuda, site, dtype):
    """The kernel with the default route's rounding at every norm site of
    a two-patch forward, against that route's eager chain on the card
    (``F.group_norm``'s Welford statistics, cast, ``F.silu``) and against
    group_norm_plain's mirror of it (the same statistics, summed in
    another order): float32 within 1e-5, bfloat16 as
    assert_rounds_as_eager_chain."""
    c, h, w, swish = site
    g = torch.Generator(device=cuda).manual_seed(5)
    x = (torch.randn(2, c, h, w, device=cuda, generator=g) * 3 + 1).to(dtype)
    wt = torch.randn(c, device=cuda, generator=g)
    b = torch.randn(c, device=cuda, generator=g)
    y = groupnorm_cuda.group_norm(x, wt, b, 32, 1e-6, swish,
                                  round_affine=True)
    plain = [groupnorm_cuda.group_norm_plain(x, wt, b, 32, 1e-6, sw,
                                             round_affine=True)
             for sw in (False, swish)]
    for aff, ref in (eager_chain(x, wt, b, swish), plain):
        if dtype == torch.float32:
            torch.testing.assert_close(y, ref, atol=1e-5, rtol=1e-5)
        else:
            assert_rounds_as_eager_chain(y, aff, ref, swish)


def constant_group_case(dtype, device):
    """(x, weight, bias): 32 groups of one channel each over 37 x 41, group
    5 holding 1,517 equal values, 26.75.  float32 rounds their sum of
    squares so that E[x^2] - E[x]^2 reads -6.1e-5 there, below -eps, in
    torch's and in sequential summation; the kernel clamps the variance
    at 0, as flax does, where an unclamped rsqrt gives NaN."""
    g = torch.Generator().manual_seed(8)
    x = torch.randn(2, 32, 37, 41, generator=g) * 3 + 1
    x[:, 5] = 26.75
    wt, b = torch.randn(32, generator=g), torch.randn(32, generator=g)
    return x.to(dtype).to(device), wt.to(device), b.to(device)


def assert_constant_group_holds(y, x, wt, b, swish):
    """``y`` finite, and at the constant group the eager chain's (whose
    Welford variance is 0: the bias, through the swish) within the two
    float32 roundings of x*a (|a| <= |weight| / sqrt(eps)), through the
    swish's slope (<= 1.1), and one bfloat16 ulp."""
    ref = eager_chain(x, wt, b, swish)[1]
    assert bool(torch.isfinite(y.float()).all())
    xa = 26.75 * abs(float(wt[5])) / 1e-6 ** 0.5
    torch.testing.assert_close(
        y[:, 5].float(), ref[:, 5].float(), atol=1.1 * xa * 2.0 ** -23,
        rtol=2.0 ** -7 if y.dtype == torch.bfloat16 else 0)


@pytest.mark.parametrize("round_affine", [False, True],
                         ids=["fused", "round_affine"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_group_norm_kernel_on_a_constant_group(cuda, dtype, round_affine):
    """A group of equal values, whose float32 E[x^2] - E[x]^2 may read
    below -eps: both roundings stay finite and hold the eager chain's
    output there."""
    x, wt, b = constant_group_case(dtype, cuda)
    for swish in (False, True):
        y = groupnorm_cuda.group_norm(x, wt, b, 32, 1e-6, swish,
                                      round_affine=round_affine)
        assert_constant_group_holds(y, x, wt, b, swish)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_round_affine_kernel_statistics_on_offset_input(cuda, dtype):
    """|mean| = 30 std at the widest site (384 x 64 x 64, the top level's
    skip concat): E[x^2] - E[x]^2 in float32 loses ~10 of the variance's
    24 bits there, where the eager chain's Welford loses none.  The output
    stays within the restore cells' limits of the eager chain's, read
    against the output's scale: rms gap 6e-3 of its rms, largest gap
    3.5e-2 of its largest value."""
    g = torch.Generator(device=cuda).manual_seed(6)
    x = (torch.randn(2, 384, 64, 64, device=cuda, generator=g) + 30
         ).to(dtype)
    wt = torch.randn(384, device=cuda, generator=g)
    b = torch.randn(384, device=cuda, generator=g)
    y = groupnorm_cuda.group_norm(x, wt, b, 32, 1e-6, True,
                                  round_affine=True).float()
    ref = eager_chain(x, wt, b, True)[1].float()
    gap = y - ref
    assert float(gap.square().mean().sqrt()) <= \
        6e-3 * float(ref.square().mean().sqrt())
    assert float(gap.abs().max()) <= 3.5e-2 * float(ref.abs().max())


def test_default_route_launches_the_kernel_once_a_site(cuda):
    """A no-grad forward of the flagship UNet (bfloat16, one patch) on the
    default route launches the kernel with the default route's rounding
    at its 51 norm sites (45 with swish), and nothing else of the
    GroupNorm kernel; a training step (autograd) launches it 0 times."""
    from wavedm_tpu_torch.config import config_from_dict, production_profile
    from wavedm_tpu_torch.inference.loader import build_unet
    from wavedm_tpu_torch.models.unet import conv_in_channels
    from wavedm_tpu_torch.ops import launch_counts, reset_launch_counts
    from wavedm_tpu_torch.training.state import create_train_state
    from wavedm_tpu_torch.training.train_step import make_train_step

    cfg = production_profile()
    unet = build_unet(cfg, None, cuda)
    x = torch.randn(1, conv_in_channels(cfg), 64, 64, device=cuda)
    reset_launch_counts()
    with torch.no_grad():
        unet(x.to(torch.bfloat16), torch.tensor([300.0], device=cuda))
    torch.cuda.synchronize()
    got = {k: v for k, v in launch_counts().items() if v}
    assert got == {"group_norm_bf16_plain_swish": 45,
                   "group_norm_bf16_plain": 6}, got
    del unet

    cfg = config_from_dict({
        "data": {"image_size": 8, "patch_size": 32},
        "model": {"ch": 64, "ch_mult": [1, 2], "num_res_blocks": 1,
                  "attn_resolutions": [4]},
        "diffusion": {"num_diffusion_timesteps": 50},
        "optim": {"optimizer": "SGD", "lr": 1e-5},
        "parallel": {"compute_dtype": "bfloat16"}})
    model = build_unet(cfg, None, cuda, train=True)
    step = make_train_step(cfg, model)
    batch = np.random.default_rng(0).random((4, 32, 32, 6), dtype=np.float32)
    reset_launch_counts()
    step(create_train_state(model, cfg.optim, 0), batch)
    torch.cuda.synchronize()
    assert not any(v for k, v in launch_counts().items()
                   if k.startswith("group_norm_")), launch_counts()


def test_round_affine_kernel_past_two_to_the_31_elements(cuda):
    """The pixel model's largest norm site, the top level's skip concat of
    a 720x480 restore: 874 patches x 256 x 128 x 128 bfloat16, 3.67e9
    elements, past 2**31 (the kernel's segment offsets are 64-bit).  The
    kernel with swish and the default route's rounding against the eager
    chain, 64 patches at a time (GroupNorm is per patch), as
    assert_rounds_as_eager_chain."""
    n, c, hw, chunk = 874, 256, 128, 64
    g = torch.Generator(device=cuda).manual_seed(9)
    x = torch.empty(n, c, hw, hw, dtype=torch.bfloat16, device=cuda)
    for s in range(0, n, chunk):
        x[s:s + chunk] = torch.randn(x[s:s + chunk].shape, device=cuda,
                                     generator=g) * 3 + 1
    wt = torch.randn(c, device=cuda, generator=g)
    b = torch.randn(c, device=cuda, generator=g)
    assert x.numel() > 2 ** 31
    y = groupnorm_cuda.group_norm(x, wt, b, 32, 1e-6, True,
                                  round_affine=True)
    for s in range(0, n, chunk):
        aff, ref = eager_chain(x[s:s + chunk], wt, b, True)
        assert_rounds_as_eager_chain(y[s:s + chunk], aff, ref, True)


def test_a_pixel_restore_launches_the_kernel_at_71_sites_a_step(cuda):
    """One restore of the pixel model (``pixel_profile``: ch_mult
    1,1,2,2,4,4, 128x128 patches, 25 steps from noise, x0 of step 21
    kept) in bfloat16 on the default route: 25 UNet calls x (65 swish + 6
    plain norm sites) = 1,775 launches with the default route's rounding,
    and nothing else of the kernel; the chain counts 25 steps run, 4 of
    them after the kept one.  On a 128 x 160 image (3 patches): the counts
    do not depend on the size."""
    from wavedm_tpu_torch.config import pixel_profile
    from wavedm_tpu_torch.inference.loader import build_restorer
    from wavedm_tpu_torch.ops import launch_counts, reset_launch_counts
    from wavedm_tpu_torch.utils.profiling import CHAIN

    cfg = pixel_profile()
    cfg.parallel.compute_dtype = "bfloat16"
    restorer = build_restorer(cfg.validate(), None, None, cuda)
    img = torch.rand(1, 128, 160, 3, device=cuda)
    before = dict(CHAIN)
    reset_launch_counts()
    restorer.restore_image_device(img)
    torch.cuda.synchronize()
    got = {k: v for k, v in launch_counts().items() if v}
    assert got == {"group_norm_bf16_plain_swish": 1625,
                   "group_norm_bf16_plain": 150}, got
    assert {k: CHAIN[k] - before[k] for k in CHAIN} == {
        "chain.steps_run": 25, "chain.steps_after_kept": 4}


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_kernel_on_a_constant_group(cuda, dtype):
    """The fused kernel's statistics clamp a variance that rounding takes
    below 0, as its plain version does: on constant_group_case's input
    (the constant group's GroupNorm scale 1e-3, so that x*a stays small
    beside the output) it matches the plain version at
    test_fused_kernel_matches_plain's tolerances, with no NaN."""
    from wavedm_tpu_torch.ops import fused_resblock as fr

    x, _, _ = constant_group_case(dtype, cuda)
    _, sg, bg, wk, b = _fused_inputs(cuda, 2, 32, 64, 37, 41, dtype)
    sg[5] = 1e-3
    out = fr.fused_gn_swish_conv(x, sg, bg, wk, b, dtype)
    ref = fr.fused_gn_swish_conv_plain(x, sg, bg, wk, b, dtype)
    assert bool(torch.isfinite(out.float()).all())
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    err = float((out.float() - ref.float()).abs().max())
    assert err <= tol * float(ref.float().abs().max()), err


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
