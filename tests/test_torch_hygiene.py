"""PyTorch port hygiene: what the GPU machine's installation allows.

The port needs only torch, numpy and the CUDA toolkit there: it runs with
jax, flax, yaml and PIL blocked, and never leans on the JAX package; its
data library needs zlib and no libjpeg or libpng.  The entry points
run on the card unless the caller names the CPU, and a kernel wrapper
handed a non-CPU tensor launches its kernel or raises -- never falls back.
"""

import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

from wavedm_tpu_torch.config import Config
from wavedm_tpu_torch.inference import loader
from wavedm_tpu_torch.native import build as native_build
from wavedm_tpu_torch.ops import (_build, fused_resblock, groupnorm_cuda,
                                  wavelet_cuda)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "wavedm_tpu", "yaml",
           "PIL")


def test_every_module_imports_without_jax_yaml_or_pil():
    script = textwrap.dedent(f"""
        import sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None          # any import of it now fails
        import importlib, pkgutil
        import numpy as np
        import wavedm_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            wavedm_tpu_torch.__path__, "wavedm_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        # stage 1's aux models and TLC run with the same packages blocked
        for name in ("ops.tlc", "models.vgg_loss", "models.wdnet",
                     "models.sam"):
            assert "wavedm_tpu_torch." + name in names, name
        # and so do the multi-process paths
        for name in ("parallel", "parallel.mesh", "parallel.distributed",
                     "parallel.launch", "parallel.dryrun"):
            assert "wavedm_tpu_torch." + name in names, name
        # and the data library's build and bindings, and the profiler
        for name in ("native", "native.build", "data.native_loader",
                     "utils.profiling"):
            assert "wavedm_tpu_torch." + name in names, name
        # and the quality-loop tools
        for name in ("make_synthetic_dataset", "diag_quality",
                     "diag_teacher_forced", "seed_study", "vpred_cpu_ab",
                     "summarize_sweep", "eval_sweep", "dress_rehearsal",
                     "vpred_rehearsal_ab"):
            assert "wavedm_tpu_torch.tools." + name in names, name
        # and the measuring tools and the work counter they stand on
        for name in ("tools.roofline", "tools.trace_summary",
                     "tools.train_mfu", "utils.work"):
            assert "wavedm_tpu_torch." + name in names, name
        import torch
        from wavedm_tpu_torch.models.sam import SAM
        from wavedm_tpu_torch.models.vgg_loss import VGG19Features
        from wavedm_tpu_torch.models.wdnet import Discriminator, WDNet
        from wavedm_tpu_torch.ops.tlc import local_avg_pool
        with torch.no_grad():
            assert WDNet()(torch.zeros(1, 48, 4, 4)).shape == (1, 48, 4, 4)
            assert SAM(8, 4)(torch.zeros(1, 8, 4, 4)).shape == (1, 1, 4, 4)
            assert len(VGG19Features()(torch.zeros(1, 3, 16, 16))) == 5
            z = torch.zeros(1, 3, 32, 32)
            assert Discriminator()(z, z).shape == (1, 1, 2, 2)
            assert local_avg_pool(z, (3, 3)).shape == z.shape
        import chip_smoke
        # a tiny restoration on the CPU touches no blocked module either
        from wavedm_tpu_torch.config import Config, DataConfig, ModelConfig
        from wavedm_tpu_torch.inference.loader import build_restorer
        cfg = Config()
        cfg.data = DataConfig(image_size=8, patch_size=32)
        cfg.model = ModelConfig(ch=32, ch_mult=(1,), num_res_blocks=1,
                                attn_resolutions=())
        cfg.hfrm.dim, cfg.hfrm.middle_blk_num = 8, 1
        cfg.hfrm.enc_blk_nums = cfg.hfrm.dec_blk_nums = (1,)
        cfg.sampling.sampling_timesteps = 2
        cfg.parallel.fused_groupnorm = True
        rest = build_restorer(cfg.validate(), None, None, device="cpu")
        out, _ = rest.restore_image(np.full((32, 32, 3), 0.5, np.float32))
        assert out.shape == (1, 32, 32, 3)
        # and so does a training step through the fused ResnetBlock op
        from wavedm_tpu_torch.cli.train_diffusion import smoke_batches
        from wavedm_tpu_torch.training.trainer import DiffusionTrainer
        cfg.parallel.fused_groupnorm = False
        cfg.parallel.fused_resblock = True
        trainer = DiffusionTrainer(cfg.validate(), device="cpu",
                                   log_fn=lambda s: None)
        trainer.fit(smoke_batches(cfg, n_crops=2, n_batches=1), max_steps=1)
        assert trainer.state.step == 1
        # the PNG codec, restore() with its dumps and both CLIs need no
        # PIL and no yaml either (the CLIs take a built-in profile by name)
        import os, tempfile
        from wavedm_tpu_torch.cli import eval_diffusion, restore
        from wavedm_tpu_torch.utils.images import read_png, write_png
        tmp = tempfile.mkdtemp()
        img = np.arange(32 * 32 * 3, dtype=np.uint8).reshape(32, 32, 3)
        # a JPEG through the data library, built here from the port's
        # sources, which need zlib alone
        from wavedm_tpu_torch.data import native_loader
        from wavedm_tpu_torch.utils.images import read_image
        assert native_loader.available(), native_loader.unavailable_reason()
        assert read_image(os.path.join("tests", "golden", "images",
                                       "raindrop_0000.jpg")).shape \
            == (480, 720, 3)
        from wavedm_tpu_torch.utils.profiling import annotate, trace
        with trace(os.path.join(tmp, "trace")), annotate("hygiene"):
            np.zeros(4)
        assert os.path.exists(os.path.join(tmp, "trace", "trace.json"))
        os.makedirs(os.path.join(tmp, "in"))
        write_png(os.path.join(tmp, "in", "a.png"), img)
        assert (read_png(os.path.join(tmp, "in", "a.png")) == img).all()
        res = rest.restore([(np.full((32, 32, 6), 0.5, np.float32), "p")],
                           save_dir=os.path.join(tmp, "dump"))
        assert res["n_images"] == 1
        assert read_png(os.path.join(tmp, "dump", "p_output.png")).shape \
            == (32, 32, 3)
        tiny = ["--config", "production", "--device", "cpu"]
        for ov in ("model.ch=32", "model.ch_mult=[1]",
                   "model.num_res_blocks=1", "model.attn_resolutions=[]",
                   "data.image_size=8", "data.patch_size=32", "hfrm.dim=8",
                   "hfrm.enc_blk_nums=[1]", "hfrm.dec_blk_nums=[1]",
                   "hfrm.middle_blk_num=1", "sampling.sampling_timesteps=2"):
            tiny += ["--set", ov]
        assert restore.main(tiny + ["--input", os.path.join(tmp, "in"),
                                    "--out", os.path.join(tmp, "out"),
                                    "--no-resize"]) == 0
        assert os.path.exists(os.path.join(tmp, "out", "a_restored.png"))
        assert eval_diffusion.main(tiny + [
            "--smoke", "--n-images", "1",
            "--set", "data.data_dir=" + os.path.join(tmp, "none")]) == 0
        # both training CLIs on a RainDrop tree: HFRM streamed, then stage
        # 2 through the device cache with validation and that HFRM file
        from wavedm_tpu_torch.cli import train_diffusion, train_hfrm
        rng = np.random.default_rng(0)
        data = os.path.join(tmp, "data")
        for split in ("train", "raindrop_test"):
            for folder in ("input", "gt"):
                for i in range(2):
                    path = os.path.join(data, "raindrop", split, folder,
                                        f"{{i}}.png")
                    os.makedirs(os.path.dirname(path), exist_ok=True)
                    write_png(path, rng.integers(0, 256, (32, 48, 3),
                                                 dtype=np.uint8))
        data_set = ["--set", "data.data_dir=" + data]
        assert train_hfrm.main(tiny + data_set + [
            "--set", "hfrm.batch_size=2", "--max-steps", "1",
            "--ckpt-dir", os.path.join(tmp, "hfrm")]) == 0
        assert train_diffusion.main(tiny + data_set + [
            "--set", "data.device_cache=true", "--set", "training.patch_n=2",
            "--set", "training.validation_freq=1", "--set",
            "sampling.grid_r=8", "--max-steps", "1",
            "--hfrm-ckpt", os.path.join(tmp, "hfrm", "lastest.pth.tar"),
            "--ckpt-dir", os.path.join(tmp, "ckpts"),
            "--val-folder", os.path.join(tmp, "val")]) == 0
        assert os.path.exists(os.path.join(tmp, "val", "step1",
                                           "0_output.png"))
        # the server answers a PNG from memory, and the card's lock is not
        # taken for the CPU; the Orbax converter needs orbax only when it
        # runs
        from wavedm_tpu_torch.inference.server import RestorationServer
        from wavedm_tpu_torch.utils.gpu_lock import acquire_gpu_lock
        from wavedm_tpu_torch.utils.images import decode_png, encode_png
        from wavedm_tpu_torch.utils.orbax_convert import \
            convert_orbax_checkpoint
        srv = RestorationServer(rest, batch=2, window_ms=5, no_resize=True)
        srv.start()
        reply = srv.restore_bytes(encode_png(img), timeout=120)
        srv.stop(timeout=60)
        assert decode_png(reply).shape == (32, 32, 3)
        assert srv.stats["served"] == 1 and srv.stats["errors"] == 0
        # a WebP body needs PIL: without it the reason is named
        try:
            srv._decode(open(os.path.join("tests", "golden", "images",
                                          "rain_q80.webp"), "rb").read())
        except ValueError as e:
            assert "PIL is not installed" in str(e), e
        else:
            raise AssertionError("a WebP decoded without PIL")
        # the tools that need no device: the synthetic dataset (the port's
        # PNG writer) and the sweep summary
        from wavedm_tpu_torch.tools import (make_synthetic_dataset,
                                            summarize_sweep)
        assert make_synthetic_dataset.main([
            "--data-dir", os.path.join(tmp, "syn"), "--n-train", "1",
            "--n-test", "1", "--severity", "light"]) == 0
        assert read_png(os.path.join(tmp, "syn", "raindrop", "train", "gt",
                                     "0000.png")).shape == (480, 720, 3)
        os.makedirs(os.path.join(tmp, "sweep"))
        with open(os.path.join(tmp, "sweep", "row.log"), "w") as f:
            f.write("psnr all torch 20.5 ssim all 0.5 (2 images)")
        assert summarize_sweep.main([
            "--dir", os.path.join(tmp, "sweep"),
            "--out", os.path.join(tmp, "summary.json")]) == 0
        assert acquire_gpu_lock("hygiene", device="cpu")
        try:
            convert_orbax_checkpoint(tmp, os.path.join(tmp, "x"), cfg)
        except ImportError:
            pass
        else:
            raise AssertionError("the converter ran without orbax")
        import shutil
        shutil.rmtree(tmp)
        loaded = [n for n in {BLOCKED!r} if sys.modules.get(n) is not None]
        assert not loaded, loaded
        print("imported", len(names))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "imported" in res.stdout


def test_entry_points_refuse_to_run_on_the_cpu_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loader.build_restorer(Config(), None, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loader.resolve_device()
    assert loader.resolve_device("cpu") == torch.device("cpu")


def test_build_without_nvcc_raises_and_writes_nothing(monkeypatch, tmp_path):
    build_dir = tmp_path / "_build"
    monkeypatch.setattr(_build, "BUILD_DIR", str(build_dir))
    monkeypatch.setattr(_build, "LIB_PATH", str(build_dir / "lib.so"))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("CUDA_PATH", str(tmp_path / "no-cuda"))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this host has a CUDA toolkit")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not build_dir.exists()


def _no_library():
    raise RuntimeError("kernel library unavailable")


@pytest.mark.parametrize("call", [
    lambda: groupnorm_cuda.group_norm(
        torch.empty(2, 64, 4, 4, device="meta"),
        torch.ones(64, device="meta"), torch.zeros(64, device="meta")),
    lambda: wavelet_cuda.wavelet_dec_cuda(torch.empty(1, 3, 8, 8, device="meta")),
    lambda: wavelet_cuda.wavelet_rec_cuda(torch.empty(1, 48, 2, 2, device="meta")),
    lambda: fused_resblock.fused_gn_swish_conv(
        torch.empty(2, 64, 4, 4, device="meta"),
        torch.ones(64, device="meta"), torch.zeros(64, device="meta"),
        torch.empty(32, 64, 3, 3, device="meta"),
        torch.zeros(32, device="meta"), torch.float32),
], ids=["group_norm", "wavelet_dec", "wavelet_rec", "fused_gn_swish_conv"])
def test_wrappers_raise_instead_of_falling_back(monkeypatch, call):
    """A non-CPU tensor goes to the kernel: with no library the wrapper
    raises, with no plain fallback and no launch counted."""
    monkeypatch.setattr(_build, "library", _no_library)
    counts = (groupnorm_cuda.launches, wavelet_cuda.launches,
              fused_resblock.launches)
    before = tuple(dict(c) for c in counts)
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        call()
    assert counts == before


def test_data_library_sources_include_no_libjpeg_or_libpng():
    """The port's decoders stand in for libjpeg and libpng on every
    machine: no source of the data library includes their headers."""
    native = os.path.join(REPO, "wavedm_tpu_torch", "native")
    sources = [f for f in os.listdir(native) if f.endswith((".cc", ".h"))]
    assert {"wavedm_data.cc", "jpeg_decode.cc", "png_decode.cc"} <= set(
        sources)
    for name in sources:
        with open(os.path.join(native, name)) as f:
            includes = re.findall(r"^\s*#\s*include\s*[<\"]([^>\"]+)",
                                  f.read(), re.M)
        assert not {"jpeglib.h", "jerror.h", "png.h"} & set(includes), name
    assert native_build.LIBS == ("-lz", "-lpthread")
    assert native_build.HEADERS == ("zlib.h",)


def test_data_library_needs_no_libjpeg_or_libpng():
    """The built library's DT_NEEDED (read from its ELF dynamic section)
    names zlib and no libjpeg or libpng; the JAX package's names both."""
    assert native_build.status()["available"]
    needed = native_build.needed()
    assert any(n.startswith("libz.") for n in needed), needed
    assert not [n for n in needed if re.match(r"lib(jpeg|png)", n)], needed
    jax_lib = os.path.join(REPO, "wavedm_tpu", "data", "libwavedm_data.so")
    jax_needed = native_build.needed(jax_lib)
    assert any(n.startswith("libjpeg") for n in jax_needed), jax_needed
    assert any(n.startswith("libpng") for n in jax_needed), jax_needed


def test_data_library_is_unavailable_only_without_zlib(monkeypatch):
    """Neither jpeglib.h nor png.h is asked for; without zlib.h the
    reason names it."""
    monkeypatch.setattr(native_build, "_lib", None)
    monkeypatch.setattr(native_build, "_is_current", lambda digest: False)
    found = {"compiler": "/usr/bin/c++",
             "headers": {"jpeglib.h": False, "png.h": False, "zlib.h": True}}
    monkeypatch.setattr(native_build, "probe", lambda: found)
    assert native_build.unavailable_reason() is None
    found["headers"]["zlib.h"] = False
    reason = native_build.unavailable_reason()
    assert "zlib.h" in reason and "jpeglib" not in reason \
        and "png.h" not in reason
