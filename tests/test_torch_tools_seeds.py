"""PyTorch port: ``tools/seed_study.py`` against the JAX package's
``tools/seed_study.py`` itself, on the CPU at a tiny size: JAX's ``main()``
with its checkpoint loaders patched to this file's params, the port's
chains fed JAX's x_T (``PRNGKey(1000 + s)``, ``PRNGKey(2000 + s)``).
Tolerance: that of ``tests/test_torch_tools.py`` (one unit of the last
printed digit, here the third decimal).
"""

import functools
import json
import os

import jax
import pytest
import torch

from wavedm_tpu.config import load_config as jax_load_config

from test_torch_tools import (REPO, _init_params, _jax_normal,
                              _patch_jax_loaders, _port_restorer,
                              _run_jax_tool, assert_json_match)
from wavedm_tpu_torch.config import load_config
from wavedm_tpu_torch.data.synthetic import SyntheticPairs
from wavedm_tpu_torch.tools import seed_study


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: several pytest-xdist workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_seed_study_matches_jax(monkeypatch, capsys, tmp_path):
    """Both chains at 2 seeds (batch 1) and one batch of 8, in float32, on
    the first heavy synthetic pair cut to 64x96 (15 patches an image):
    JAX's JSON and the port's statistics agree."""
    from tools import seed_study as jax_tool
    from wavedm_tpu.data import synthetic as jax_synthetic

    monkeypatch.setattr(jax_synthetic, "SyntheticPairs", functools.partial(
        jax_synthetic.SyntheticPairs, height=64, width=96))
    sets = ["model.ch=32", "model.ch_mult=[1,2]", "model.num_res_blocks=1",
            "model.attn_resolutions=[4]", "data.image_size=8",
            "data.patch_size=32", "hfrm.dim=8", "hfrm.enc_blk_nums=[1,1]",
            "hfrm.dec_blk_nums=[1,1]", "hfrm.middle_blk_num=1",
            "sampling.sampling_timesteps=5", "sampling.grid_r=4"]
    argv = ["--seeds", "2", "--dtype", "float32",
            "--out", str(tmp_path / "jax.json")]
    for s in sets:
        argv += ["--set", s]
    jax_params = _init_params(jax_load_config(os.path.join(
        REPO, "wavedm_tpu", "configs", "raindrop_wavelet.yaml"), sets))
    _patch_jax_loaders(monkeypatch, *jax_params)
    _run_jax_tool(monkeypatch, capsys, jax_tool, argv)
    theirs = json.load(open(tmp_path / "jax.json"))

    cfg = load_config("reference", sets)
    cond, gt = SyntheticPairs(height=64, width=96, seed=61 + 10_000,
                              severity="heavy")[0]

    def draw(key, shape):
        key_init, _ = jax.random.split(jax.random.PRNGKey(key))
        return _jax_normal(key_init, shape)

    ours = {"checkpoint": theirs["checkpoint"], "dtype": "float32",
            "seeds": 2}
    for label, t_start in seed_study.CHAINS:
        rest = _port_restorer(seed_study.chain_config(cfg, "float32",
                                                      t_start), jax_params)
        ours[label] = seed_study.study(rest, cond[None], gt, 2, draw)
    assert ours["full_25step"]["b8"]["n"] == 8
    assert_json_match(ours, theirs)
