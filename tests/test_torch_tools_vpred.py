"""PyTorch port: ``tools/vpred_cpu_ab.py`` against the JAX package's
``tools/vpred_cpu_ab.py`` itself, on the CPU at a tiny size: JAX's
``main()`` at ``--hw 8`` for 2 steps, the port's arms fed JAX's initial
params, each step's t and noise (its train state's ``PRNGKey(0)`` split
three ways a step) and the probes' draws (``PRNGKey(3)``,
``PRNGKey(4)``).  Tolerance: that of ``tests/test_torch_tools.py``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavedm_tpu.config import load_config as jax_load_config
from wavedm_tpu.models.unet import DiffusionUNet as JaxUNet

from test_torch_tools import (REPO, _jax_normal, _run_jax_tool,
                              assert_json_match)
from wavedm_tpu_torch.tools import vpred_cpu_ab
from wavedm_tpu_torch.utils.convert import unet_state_dict_from_flax


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: several pytest-xdist workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_vpred_cpu_ab_matches_jax(monkeypatch, capsys, tmp_path):
    """Both arms at --hw 8 for 2 steps: the JSON agrees key by key (the
    train time aside).  The port is fed JAX's initial params, each step's
    t and noise, and the probes' eps and x_T."""
    from tools import vpred_cpu_ab as jax_tool
    from wavedm_tpu.diffusion.loss import antithetic_timesteps

    monkeypatch.chdir(REPO)
    hw, steps = 8, 2
    out = tmp_path / "jax.json"
    theirs = json.loads(_run_jax_tool(monkeypatch, capsys, jax_tool, [
        "--steps", str(steps), "--hw", str(hw), "--out", str(out)]))
    assert json.load(open(out)) == theirs

    cfg = vpred_cpu_ab.toy_config(hw)
    # the tool's own init: raindrop.yaml cut as it cuts it, PRNGKey(0)
    jcfg = jax_load_config("wavedm_tpu/configs/raindrop.yaml")
    jcfg.data.image_size = jcfg.data.patch_size = hw
    jcfg.model.ch, jcfg.model.ch_mult = 32, [1, 2]
    jcfg.model.attn_resolutions, jcfg.model.num_res_blocks = [8], 1
    jparams = JaxUNet.from_config(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, hw, hw, 6)),
        jnp.zeros((1,)))["params"]
    init_sd = unet_state_dict_from_flax(jparams, 2, 1)
    rng_np = np.random.default_rng(7)
    train = vpred_cpu_ab.make_data(256, hw, rng_np)
    test = vpred_cpu_ab.make_data(32, hw, rng_np)
    bs, T = cfg.training.batch_size, cfg.diffusion.num_diffusion_timesteps
    keys, rng = [], jax.random.PRNGKey(0)
    for _ in range(steps):
        rng, key_t, key_e = jax.random.split(rng, 3)
        keys.append((key_t, key_e))

    def draws(i):
        key_t, key_e = keys[i]
        t = torch.from_numpy(np.array(antithetic_timesteps(key_t, bs, T)))
        return t, _jax_normal(key_e, (bs, 3, hw, hw))

    shape = (len(test), 3, hw, hw)
    ours = {arm: vpred_cpu_ab.run_arm(
        vpred_cpu_ab.toy_config(hw, arm), train, test, steps, init_sd,
        torch.device("cpu"), draws,
        e_tf=_jax_normal(jax.random.PRNGKey(3), shape),
        noise=_jax_normal(jax.random.PRNGKey(4), shape))
        for arm in ("eps", "v")}
    ours["degraded_input_psnr_db"] = round(float(-10 * np.log10(np.mean(
        (test[..., :3] - test[..., 3:]) ** 2))), 2)
    ours["steps"] = steps
    assert_json_match(json.loads(json.dumps(ours)), theirs)
