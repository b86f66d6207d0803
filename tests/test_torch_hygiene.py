"""PyTorch port hygiene: what the GPU machine's installation allows.

That machine has torch, numpy and the CUDA toolkit but no jax, flax, yaml
or PIL, and the port must not lean on the JAX package.  The entry points
run on the card unless the caller names the CPU, and a kernel wrapper
handed a non-CPU tensor launches its kernel or raises -- never falls back.
"""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from wavedm_tpu_torch.config import Config
from wavedm_tpu_torch.inference import loader
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
