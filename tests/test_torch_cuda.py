"""PyTorch port on the card: each CUDA kernel against its plain version,
and a small restoration through the kernels against the CPU path.

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
                                   (3, 5, 36, 20)])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("swish", [False, True])
@pytest.mark.parametrize("shape", [(4, 384, 64, 64), (90, 1536, 8, 8),
                                   (2, 64, 5, 7), (1, 32, 1, 3)])
def test_group_norm_kernel_matches_plain(cuda, shape, swish, dtype):
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
