"""PyTorch port: the evaluation path -- ``DiffusiveRestoration.restore``,
the whole-image restoration, RainDrop eval pairs and the two CLIs -- against
the JAX package.

``restore()`` runs on both sides over the same pairs with the same weights
(carried across by utils/convert.py) and the same x_T: JAX's own per-batch
draws, reproduced here along its key path and handed to the port's
``restore_image``.  The restored images then part by float32 summation
order (~1e-5, tests/test_torch_restoration.py), which moves a PSNR by far
less than the 1e-3 dB and an SSIM by far less than the 1e-5 they are held
to.  The whole-image restoration is held to 1e-4, as the tiled one is.
The CLIs run in-process on the CPU at a tiny size.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavedm_tpu.config import config_from_dict as jax_config_from_dict
from wavedm_tpu.inference.restoration import \
    DiffusiveRestoration as JaxRestoration
from wavedm_tpu.models.hfrm import HFRM as JaxHFRM
from wavedm_tpu.models.unet import DiffusionUNet as JaxUNet

from wavedm_tpu_torch.cli import eval_diffusion, restore as restore_cli
from wavedm_tpu_torch.config import config_from_dict
from wavedm_tpu_torch.data.raindrop import RainDrop
from wavedm_tpu_torch.inference.loader import (build_hfrm, build_restorer,
                                               build_unet)
from wavedm_tpu_torch.inference.restoration import DiffusiveRestoration
from wavedm_tpu_torch.training.state import create_train_state
from wavedm_tpu_torch.utils.checkpoint import save_checkpoint
from wavedm_tpu_torch.utils.convert import (hfrm_state_dict_from_flax,
                                            unet_state_dict_from_flax)
from wavedm_tpu_torch.utils.images import read_png, to_uint8, write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, P = 64, 96, 8
SEED = 5
TINY = ["--set", "model.ch=32", "--set", "model.ch_mult=[1,2]",
        "--set", "model.num_res_blocks=1", "--set", "model.attn_resolutions=[4]",
        "--set", "data.image_size=8", "--set", "data.patch_size=32",
        "--set", "hfrm.dim=8", "--set", "hfrm.enc_blk_nums=[1,1]",
        "--set", "hfrm.dec_blk_nums=[1,1]", "--set", "hfrm.middle_blk_num=1",
        "--set", "diffusion.num_diffusion_timesteps=50",
        "--set", "sampling.t_start=30",
        "--set", "sampling.sampling_timesteps=3", "--set", "sampling.grid_r=4"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread here: the suite runs several pytest-xdist
    workers on a few cores, where these small ops on a thread per core in
    every worker run ~100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raw(**sampling):
    return {
        "data": {"image_size": P, "patch_size": 4 * P},
        "model": {"ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1,
                  "attn_resolutions": [4]},
        "diffusion": {"num_diffusion_timesteps": 50},
        "hfrm": {"dim": 8, "enc_blk_nums": [1, 1], "middle_blk_num": 1,
                 "dec_blk_nums": [1, 1]},
        "training": {"seed": SEED},
        "sampling": {"sampling_timesteps": 5, "grid_r": 4,
                     "x0_pred_index": -2, **sampling},
    }


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_config_from_dict(_raw())
    uparams = jax.jit(JaxUNet.from_config(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, P, P, 96)),
        jnp.zeros((1,)))["params"]
    hparams = jax.jit(JaxHFRM.from_config(jcfg).init)(
        jax.random.PRNGKey(1), jnp.zeros((1, H, W, 3)))["params"]
    rng = np.random.default_rng(4)
    hparams = jax.tree_util.tree_map_with_path(
        lambda path, v: jnp.asarray(0.5 * rng.standard_normal(v.shape),
                                    v.dtype)
        if path[-1].key in ("beta", "gamma") else v, hparams)
    return uparams, hparams


def _both(weights, raw):
    """The JAX and the port restorer for one config, same weights."""
    uparams, hparams = weights
    jcfg = jax_config_from_dict(raw)
    jrest = JaxRestoration(jcfg, JaxUNet.from_config(jcfg).apply, uparams,
                           JaxHFRM.from_config(jcfg).apply, hparams)
    cfg = config_from_dict(raw)
    rest = DiffusiveRestoration(
        cfg, build_unet(cfg, unet_state_dict_from_flax(uparams, 2, 1), "cpu"),
        build_hfrm(cfg, hfrm_state_dict_from_flax(hparams, (1, 1), 1, (1, 1)),
                   "cpu"), device="cpu")
    return jrest, rest


def _pairs(n, h=H, w=W, seed=6):
    rng = np.random.default_rng(seed)
    gt = rng.random((n, h, w, 3)).astype(np.float32)
    cond = np.clip(gt + 0.1 * rng.standard_normal(gt.shape), 0, 1)
    return [(np.concatenate([c, g], -1).astype(np.float32), f"img{i}")
            for i, (c, g) in enumerate(zip(cond, gt))]


def _replay_jax_noise(rest, seed, shape):
    """Make the port's restorer take, batch by batch, the x_T that JAX's
    restore() draws: rng -> (rng, sub) per batch; sub -> (key_init, _)."""
    rng = jax.random.PRNGKey(seed)
    inner = rest.restore_image

    def restore_image(cond, generator=None, **kw):
        nonlocal rng
        rng, sub = jax.random.split(rng)
        key_init, _ = jax.random.split(sub)
        b = cond.shape[0]
        noise = np.asarray(jax.random.normal(key_init, (b,) + shape))
        return inner(cond, noise=torch.from_numpy(
            noise.transpose(0, 3, 1, 2).copy()), **kw)

    rest.restore_image = restore_image


def test_restore_matches_jax(weights, tmp_path):
    """Four pairs in batches of two: the metric dicts agree, and the dumps
    hold the port's restored images."""
    jrest, rest = _both(weights, _raw())
    pairs = _pairs(4)
    ref = jrest.restore(iter(pairs), eval_batch=2)
    _replay_jax_noise(rest, SEED, (H // 4, W // 4, 3))
    ours = rest.restore(iter(pairs), save_dir=str(tmp_path), eval_batch=2)
    assert set(ours) == set(ref) and ours["n_images"] == ref["n_images"] == 4
    for key in ("psnr_torch", "psnr_y", "psnr_np_y"):
        assert abs(ours[key] - ref[key]) <= 1e-3, (key, ours[key], ref[key])
    assert abs(ours["ssim"] - ref["ssim"]) <= 1e-5
    names = sorted(os.listdir(tmp_path))
    assert names == sorted(f"img{i}_{kind}.png" for i in range(4)
                           for kind in ("output", "cond", "gt"))
    np.testing.assert_array_equal(read_png(str(tmp_path / "img3_gt.png")),
                                  to_uint8(pairs[3][0][..., 3:]))


def test_restore_batches_by_geometry_and_keeps_the_count(weights):
    """eval_batch groups runs of one geometry; a new geometry flushes;
    every image is scored once."""
    _, rest = _both(weights, _raw())
    pairs = _pairs(3) + _pairs(1, 32, 48, seed=7) + _pairs(2, seed=8)
    sizes = []
    inner = rest.restore_image
    rest.restore_image = lambda x, **kw: (sizes.append(x.shape[:3])
                                          or inner(x, **kw))
    for eval_batch, want in ((1, [1] * 6), (2, [2, 1, 1, 2]),
                             (4, [3, 1, 2])):
        sizes.clear()
        res = rest.restore(iter(pairs), eval_batch=eval_batch)
        assert res["n_images"] == 6
        assert [s[0] for s in sizes] == want
        assert all(np.isfinite(v) for v in res.values())
    assert {s[1:] for s in sizes} == {(H, W), (32, 48)}


def test_whole_image_restoration_matches_jax(weights):
    """68x100 pixels: a 17x25 wavelet image reflect-padded to 18x26 for the
    UNet and cropped back; the output is the chain's final x.  (DDIM: the
    JAX whole-image program cannot trace dpmpp2m's float64 constants.)"""
    jrest, rest = _both(weights, _raw(whole_image=True))
    h, w = 68, 100
    cond = np.random.default_rng(9).random((2, h, w, 3)).astype(np.float32)
    key_init, _ = jax.random.split(jax.random.PRNGKey(SEED))
    noise = np.asarray(jax.random.normal(key_init, (2, h // 4, w // 4, 3)))
    ref, _ = jrest.restore_image(cond, jax.random.PRNGKey(SEED))
    out, _ = rest.restore_image(cond, noise=torch.from_numpy(
        noise.transpose(0, 3, 1, 2).copy()))
    assert out.shape == (2, h, w, 3)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-4)


def test_raindrop_eval_samples():
    """The test split reads as eight 720x480 [input | gt] pairs."""
    cfg = config_from_dict({"data": {"data_dir": os.path.join(REPO, "data")}})
    samples = list(RainDrop(cfg).eval_samples())
    assert [i for _, i in samples] == [f"{k:04d}" for k in range(8)]
    pair = samples[0][0]
    assert pair.shape == (480, 720, 6) and pair.dtype == np.float32
    gt = read_png(os.path.join(REPO, "data", "raindrop", "raindrop_test",
                               "gt", "0000.png"))
    np.testing.assert_array_equal(pair[..., 3:], gt.astype(np.float32) / 255)


def _metric_lines(text):
    got = {}
    for line in text.splitlines():
        for name in ("psnr all torch", "psnr all np", "psnr all GPU",
                     "ssim all"):
            if line.startswith(name + " "):
                got[name] = float(line[len(name) + 1:])
    return got


@pytest.mark.parametrize("source", ["smoke", "raindrop"])
def test_eval_cli_in_process(capsys, tmp_path, source):
    args = ["--config", "production", "--device", "cpu", "--n-images", "2",
            "--eval-batch", "2", "--image-folder", str(tmp_path)] + TINY
    if source == "smoke":
        args += ["--smoke"]
    else:
        args += ["--set", f"data.data_dir={os.path.join(REPO, 'data')}",
                 "--solver", "dpmpp2m"]
    assert eval_diffusion.main(args) == 0
    out = capsys.readouterr().out
    metrics = _metric_lines(out)
    assert len(metrics) == 4 and "(2 images)" in out
    assert all(np.isfinite(v) for v in metrics.values())
    assert 0 < metrics["ssim all"] <= 1
    ids = ["synthetic0", "synthetic1"] if source == "smoke" else ["0000",
                                                                  "0001"]
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"{i}_{kind}.png" for i in ids for kind in ("output", "cond", "gt"))
    assert read_png(str(tmp_path / f"{ids[0]}_output.png")).shape == (480,
                                                                      720, 3)


def test_eval_cli_refuses_an_orbax_directory(tmp_path):
    with pytest.raises(NotImplementedError, match="cli.convert_orbax"):
        eval_diffusion.main(["--config", "production", "--device", "cpu",
                             "--smoke", "--resume", str(tmp_path)] + TINY)


def test_restore_cli_in_process(tmp_path):
    """Three 48x64 images at native geometry in batches of two, a PNG, a
    JPEG and a BMP, from the port's own checkpoint (EMA) and a
    reference-style HFRM file: the outputs are the restorer's own images
    of PIL's decodes for that generator.  A WebP beside them is not
    listed."""
    from PIL import Image

    cfg_path = tmp_path / "mini.yaml"
    cfg_path.write_text(
        "data: {image_size: 8, patch_size: 32}\n"
        "model: {ch: 32, ch_mult: [1, 2], num_res_blocks: 1,"
        " attn_resolutions: [4]}\n"
        "diffusion: {num_diffusion_timesteps: 50}\n"
        "sampling: {sampling_timesteps: 3, grid_r: 4, x0_pred_index: -1}\n"
        "hfrm: {dim: 4, enc_blk_nums: [1, 1], middle_blk_num: 1,"
        " dec_blk_nums: [1, 1]}\n")
    from wavedm_tpu_torch.config import load_config
    cfg = load_config(str(cfg_path))
    unet = build_unet(cfg, None, "cpu", train=True)
    ckpt = save_checkpoint(str(tmp_path / "unet"),
                           create_train_state(unet, cfg.optim, 0), cfg)
    hfrm_path = str(tmp_path / "hfrm.pth")
    torch.save(build_hfrm(cfg, None, "cpu").state_dict(), hfrm_path)
    ind = tmp_path / "in"
    ind.mkdir()
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
            for _ in range(3)]
    write_png(str(ind / "img0.png"), imgs[0])
    Image.fromarray(imgs[1]).save(str(ind / "img1.jpg"), quality=90)
    Image.fromarray(imgs[2]).save(str(ind / "img2.bmp"))
    Image.fromarray(imgs[2]).save(str(ind / "img3.webp"))
    imgs[1] = np.asarray(Image.open(str(ind / "img1.jpg")).convert("RGB"))
    (ind / "notes.txt").write_text("not an image")

    assert restore_cli.main([
        "--config", str(cfg_path), "--resume", ckpt, "--ema",
        "--hfrm-ckpt", hfrm_path, "--input", str(ind),
        "--out", str(tmp_path / "out"), "--batch", "2", "--no-resize",
        "--device", "cpu"]) == 0
    outs = sorted(os.listdir(tmp_path / "out"))
    assert outs == ["img0_restored.png", "img1_restored.png",
                    "img2_restored.png"]

    rest = build_restorer(cfg, ckpt, hfrm_path, device="cpu", ema=True)
    gen = torch.Generator().manual_seed(cfg.training.seed)
    x = np.stack(imgs).astype(np.float32) / 255.0
    want = np.concatenate([rest.restore_image(x[:2], generator=gen)[0],
                           rest.restore_image(x[2:], generator=gen)[0]])
    for i, name in enumerate(outs):
        np.testing.assert_array_equal(read_png(str(tmp_path / "out" / name)),
                                      to_uint8(want[i]))


def test_restore_cli_refuses_other_formats(tmp_path):
    """A file of a format the port does not read, named by its path, is
    refused naming the format (a directory does not list it)."""
    from PIL import Image

    path = str(tmp_path / "photo.webp")
    Image.fromarray(np.zeros((48, 64, 3), np.uint8)).save(path)
    with pytest.raises(ValueError, match="WebP is not supported") as err:
        restore_cli.main(["--config", "production", "--input", path,
                          "--out", str(tmp_path / "out"), "--no-resize",
                          "--device", "cpu"] + TINY)
    assert "photo.webp" in str(err.value)


def test_restore_cli_restores_a_jpeg(tmp_path):
    """A JPEG named by its path, at native geometry, is restored from PIL's
    decode of it."""
    from PIL import Image

    from wavedm_tpu_torch.config import load_config

    path = str(tmp_path / "photo.jpg")
    img = np.random.default_rng(1).integers(0, 256, (32, 48, 3),
                                            dtype=np.uint8)
    Image.fromarray(img).save(path, quality=90)
    assert restore_cli.main(["--config", "production", "--input", path,
                             "--out", str(tmp_path / "out"), "--no-resize",
                             "--device", "cpu"] + TINY) == 0
    cfg = load_config("production", [o for o in TINY if o != "--set"])
    rest = build_restorer(cfg, None, None, device="cpu")
    gen = torch.Generator().manual_seed(cfg.training.seed)
    x = np.asarray(Image.open(path).convert("RGB"))[None] / np.float32(255)
    want = rest.restore_image(x.astype(np.float32), generator=gen)[0][0]
    np.testing.assert_array_equal(
        read_png(str(tmp_path / "out" / "photo_restored.png")),
        to_uint8(want))
