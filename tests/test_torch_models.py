"""PyTorch port: UNet and HFRM against the reference goldens and the JAX
models, with weights carried across by ``wavedm_tpu_torch.utils.convert``.

Tolerances: the goldens use tests/test_model_parity.py's own (UNet 2e-4 /
1e-3, HFRM 1e-5 / 1e-4).  Port-vs-JAX runs float32 on both sides, where
only the summation order of convolutions differs, and is held to the same
bounds.  The bfloat16 comparison rounds activations at every layer on both
sides, at slightly different points (XLA may keep an elementwise chain in
float32 where PyTorch rounds each op), so it is held to 2**-6 of the
output's scale: about two bfloat16 ulps there.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavedm_tpu.models.hfrm import HFRM as JaxHFRM
from wavedm_tpu.models.unet import DiffusionUNet as JaxUNet
from wavedm_tpu.utils.torch_compat import (convert_hfrm_state_dict,
                                           convert_unet_state_dict)

from wavedm_tpu_torch.config import reference_profile
from wavedm_tpu_torch.models.hfrm import HFRM
from wavedm_tpu_torch.models.unet import DiffusionUNet
from wavedm_tpu_torch.utils.convert import (hfrm_state_dict_from_flax,
                                            load_torch_checkpoint,
                                            unet_state_dict_from_flax)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
UNET_KW = dict(in_channels=6, out_ch=3, ch=32, ch_mult=(1, 2),
               num_res_blocks=1, attn_resolutions=(8,), resolution=16)
HFRM_KW = dict(in_channel=3, dim=8, mid_blk_num=1, enc_blk_nums=(1, 1),
               dec_blk_nums=(1, 1))


def _golden(name):
    z = np.load(os.path.join(GOLDEN, name))
    sd = {k[4:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd::")}
    return {k: z[k] for k in z.files if not k.startswith("sd::")}, sd


@pytest.mark.parametrize("fused_gn", [False, True])
def test_unet_matches_reference_golden(fused_gn):
    data, sd = _golden("unet_small.npz")
    model = DiffusionUNet(fused_gn=fused_gn, **UNET_KW).eval()
    model.load_state_dict(sd)
    with torch.no_grad():
        y = model(torch.from_numpy(data["x"]), torch.from_numpy(data["t"]))
    np.testing.assert_allclose(y.numpy(), data["y"], atol=2e-4, rtol=1e-3)


def test_hfrm_matches_reference_golden():
    data, sd = _golden("hfrm_small.npz")
    model = HFRM(**HFRM_KW).eval()
    model.load_state_dict(sd)
    with torch.no_grad():
        y = model(torch.from_numpy(data["x"]))
    np.testing.assert_allclose(y.numpy(), data["y"], atol=1e-5, rtol=1e-4)


def test_converters_invert_torch_compat():
    """flax -> state_dict is the exact inverse of torch_compat's
    state_dict -> flax, on the goldens' reference weights."""
    for name, to_flax, from_flax, kw in (
        ("unet_small.npz", convert_unet_state_dict, unet_state_dict_from_flax,
         dict(num_levels=2, num_res_blocks=1)),
        ("hfrm_small.npz", convert_hfrm_state_dict, hfrm_state_dict_from_flax,
         dict(enc_blk_nums=(1, 1), mid_blk_num=1, dec_blk_nums=(1, 1))),
    ):
        _, sd = _golden(name)
        back = from_flax(to_flax({k: v.numpy() for k, v in sd.items()}, **kw),
                         *kw.values())
        assert back.keys() == sd.keys()
        for k in sd:
            torch.testing.assert_close(back[k], sd[k], atol=0, rtol=0)


@pytest.fixture(scope="module")
def unet_params():
    # fused_gn and compute_dtype leave the parameter tree unchanged
    return jax.jit(JaxUNet(**UNET_KW).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 6)),
        jnp.zeros((1,)))["params"]


def _both_unets(params, x, t, fused_gn, jax_dtype, torch_dtype,
                fused_block=False):
    jmodel = JaxUNet(fused_gn=fused_gn, compute_dtype=jax_dtype,
                     fused_block=fused_block, **UNET_KW)
    ref = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x),
                                jnp.asarray(t))
    model = DiffusionUNet(fused_gn=fused_gn, compute_dtype=torch_dtype,
                          fused_block=fused_block, **UNET_KW).eval()
    model.load_state_dict(unet_state_dict_from_flax(params, 2, 1))
    with torch.no_grad():
        y = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                  torch.from_numpy(t))
    assert y.dtype == torch.float32
    return y.numpy(), np.asarray(ref).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("fused_gn", [False, True])
def test_unet_matches_jax_forward(unet_params, fused_gn):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 16, 16, 6)).astype(np.float32)
    t = np.array([3.0, 250.0, 900.0], np.float32)
    y, ref = _both_unets(unet_params, x, t, fused_gn, jnp.float32,
                         torch.float32)
    np.testing.assert_allclose(y, ref, atol=2e-4, rtol=1e-3)


def test_unet_bf16_matches_jax_forward(unet_params):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 16, 16, 6)).astype(np.float32)
    t = np.array([10.0, 500.0], np.float32)
    y, ref = _both_unets(unet_params, x, t, True, jnp.bfloat16,
                         torch.bfloat16)
    assert float(np.abs(y - ref).max()) <= 2.0 ** -6 * float(np.abs(ref).max())


def test_unet_fused_block_keys_match_jax():
    """fused_resblock keeps the parameter tree (JAX) and the state_dict
    keys (port) of the unfused model."""
    x, t = jnp.zeros((1, 16, 16, 6)), jnp.zeros((1,))
    trees = [jax.eval_shape(JaxUNet(fused_block=fb, **UNET_KW).init,
                            jax.random.PRNGKey(0), x, t)["params"]
             for fb in (False, True)]
    assert (jax.tree_util.tree_structure(trees[0])
            == jax.tree_util.tree_structure(trees[1]))
    sd = DiffusionUNet(fused_block=True, **UNET_KW).state_dict()
    assert sd.keys() == DiffusionUNet(**UNET_KW).state_dict().keys()
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                    trees[1])
    assert sd.keys() == unet_state_dict_from_flax(params, 2, 1).keys()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unet_fused_block_matches_jax_forward(unet_params, dtype):
    """Both ResnetBlock pairs through the fused op (its CPU path) against
    JAX's ``fused_block`` model, at the bounds of the unfused comparison."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 16, 16, 6)).astype(np.float32)
    t = np.array([7.0, 640.0], np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    y, ref = _both_unets(unet_params, x, t, False, jdt, tdt, True)
    if dtype == "float32":
        np.testing.assert_allclose(y, ref, atol=2e-4, rtol=1e-3)
    else:
        assert float(np.abs(y - ref).max()) <= 2.0 ** -6 * float(
            np.abs(ref).max())


@pytest.mark.parametrize("fused_block", [False, True])
def test_cast_at_use_equals_stored_weights(fused_block):
    """Training keeps float32 parameters and casts conv and linear weights
    to bfloat16 at each use; serving stores them in bfloat16.  The same
    rounding, so the same bits out."""
    torch.manual_seed(0)
    sd = DiffusionUNet(**UNET_KW).state_dict()
    stored, at_use = (DiffusionUNet(compute_dtype=torch.bfloat16,
                                    fused_block=fused_block,
                                    keep_f32_params=keep, **UNET_KW).eval()
                      for keep in (False, True))
    for model in (stored, at_use):
        model.load_state_dict(sd)
    assert {p.dtype for p in at_use.parameters()} == {torch.float32}
    assert torch.bfloat16 in {p.dtype for p in stored.parameters()}
    x = torch.randn(2, 6, 16, 16, generator=torch.Generator().manual_seed(1))
    t = torch.tensor([3.0, 500.0])
    with torch.no_grad():
        assert torch.equal(stored(x, t), at_use(x, t))


def test_hfrm_matches_jax_forward():
    jmodel = JaxHFRM(**HFRM_KW)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(1),
                                  jnp.zeros((1, 20, 28, 3)))["params"]
    # flax initialises beta/gamma to zero (blocks start as identities):
    # draw them so every block's residual branch is exercised
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: jnp.asarray(rng.standard_normal(v.shape), v.dtype)
        if path[-1].key in ("beta", "gamma") else v, params)
    x = rng.random((2, 20, 28, 3)).astype(np.float32)   # pads to 24x28
    ref = np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x)))

    model = HFRM(**HFRM_KW).eval()
    model.load_state_dict(hfrm_state_dict_from_flax(
        params, (1, 1), 1, (1, 1)))
    with torch.no_grad():
        y = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(y.numpy().transpose(0, 2, 3, 1), ref,
                               atol=1e-5, rtol=1e-4)


def test_flagship_param_counts():
    """The flagship widths (ch 128, ch_mult 1,2,4,6, 96 input channels;
    HFRM dim 32) counted on the meta device, which allocates nothing."""
    z = np.load(os.path.join(GOLDEN, "param_counts.npz"))
    cfg = reference_profile()
    assert cfg.model.unet_in_channels == 96
    with torch.device("meta"):
        unet = DiffusionUNet.from_config(cfg)
        hfrm = HFRM.from_config(cfg)
    assert sum(p.numel() for p in unet.parameters()) == int(z["unet"])
    assert sum(p.numel() for p in hfrm.parameters()) == int(z["hfrm"])


@pytest.mark.parametrize("ema", [False, True])
def test_load_torch_checkpoint(tmp_path, ema):
    _, sd = _golden("hfrm_small.npz")
    shadow = {k: v + 1 for k, v in sd.items()}
    path = tmp_path / "ckpt.pth.tar"
    torch.save({"state_dict": sd, "ema_helper": shadow}, path)
    loaded = load_torch_checkpoint(str(path), ema=ema)
    model = HFRM(**HFRM_KW)
    model.load_state_dict(loaded)
    want = shadow if ema else sd
    torch.testing.assert_close(model.conv_in.weight, want["conv_in.weight"])


def test_flagship_fused_sites():
    """The 44 GN -> swish -> conv3x3 pairs of a flagship forward fall on
    the 17 shapes the card tests hold the kernel to (derived on the meta
    device, as chip_smoke.py does)."""
    import chip_smoke
    from test_torch_cuda import FUSED_SHAPES

    sites = chip_smoke.fused_sites(reference_profile(), 2)
    assert sum(sites.values()) == 44
    assert sorted((h, cin, cout) for cin, h, w, cout in sites) == sorted(
        FUSED_SHAPES)
    assert all(h == w for _, h, w, _ in sites)
