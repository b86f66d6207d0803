"""PyTorch port: the quality-loop tools (``wavedm_tpu_torch/tools/``)
against the JAX tools themselves, on the CPU at a tiny size
(``seed_study``: ``tests/test_torch_tools_seeds.py``; the toy A/B:
``tests/test_torch_tools_vpred.py``; the sweep and rehearsal drivers:
``tests/test_torch_tools_drivers.py``).

Each JAX tool's own ``main()`` runs in this process with ``sys.argv`` set;
its checkpoint loaders (``wavedm_tpu.utils.checkpoint.load_checkpoint`` /
``find_latest_checkpoint``, ``scripts.train_diffusion.load_hfrm_params``)
are patched to hand over this file's JAX params, which
``utils/convert.py`` carries to the port.  The port's tool then runs on
the same inputs with JAX's own draws, made with the JAX tool's keys:
``diag_quality`` one ``split(PRNGKey(training.seed))`` for every image,
``diag_teacher_forced`` ``PRNGKey(0)`` split once a rung,
``seed_study`` ``PRNGKey(1000 + s)`` and ``PRNGKey(2000 + s)``, the
toy A/B its train state's ``PRNGKey(0)`` split three ways a step and
``PRNGKey(3)`` / ``PRNGKey(4)``.

Tolerance: every number the JAX tool prints, to within one unit of its
last printed digit.  Where a value is too large for float32 to hold that
digit (a random UNet's x0 estimate at t = 990 reads ~2e4 and is printed
to 1e-4, below float32's resolution there), the tolerance widens to
3e-5 of the value: float32 summation order alone moves the last bits of
such a mean over 1e4-1e5 elements.  ``train_s`` (seconds) is not
compared.
"""

import functools
import json
import os
import re
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from wavedm_tpu.config import load_config as jax_load_config
from wavedm_tpu.models.hfrm import HFRM as JaxHFRM
from wavedm_tpu.models.unet import DiffusionUNet as JaxUNet

from wavedm_tpu_torch.config import load_config
from wavedm_tpu_torch.data.synthetic import SyntheticPairs
from wavedm_tpu_torch.inference.loader import build_restorer
from wavedm_tpu_torch.tools import (diag_quality, diag_teacher_forced,
                                    make_synthetic_dataset, summarize_sweep)
from wavedm_tpu_torch.utils.convert import (hfrm_state_dict_from_flax,
                                            unet_state_dict_from_flax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUMBER = re.compile(r"-?\d+(?:\.\d+)?")
TINY_YAML = """
data: {{image_size: 32, patch_size: 128, data_dir: "{data}"}}
model: {{ch: 32, ch_mult: [1, 2], num_res_blocks: 1, attn_resolutions: [4]}}
sampling: {{sampling_timesteps: 2, grid_r: 32, x0_pred_index: -1,
           t_start: {t_start}}}
hfrm: {{dim: 8, enc_blk_nums: [1, 1], middle_blk_num: 1,
       dec_blk_nums: [1, 1]}}
"""


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: several pytest-xdist workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_prints_match(ours: str, theirs: str) -> None:
    """Line by line: the same text, and each number within one unit of the
    last digit JAX printed (3e-5 of the value where float32 cannot carry
    that digit; see the module doc)."""
    a, b = ours.strip().splitlines(), theirs.strip().splitlines()
    assert len(a) == len(b), (ours, theirs)
    for la, lb in zip(a, b):
        assert NUMBER.sub("#", la).split() == NUMBER.sub("#", lb).split(), \
            (la, lb)
        for x, y in zip(NUMBER.findall(la), NUMBER.findall(lb)):
            unit = 10.0 ** -(len(y.split(".")[1]) if "." in y else 0)
            tol = max(unit, 3e-5 * abs(float(y))) * (1 + 1e-9)
            assert abs(float(x) - float(y)) <= tol, (la, lb)


def assert_json_match(ours, theirs, path="") -> None:
    """The same keys; numbers as :func:`assert_prints_match` holds them,
    the decimals being those of JAX's rounded value."""
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs), (path, sorted(ours), sorted(theirs))
        for k in theirs:
            if k != "train_s":
                assert_json_match(ours[k], theirs[k], f"{path}.{k}")
    elif isinstance(theirs, (int, float)) and not isinstance(theirs, bool):
        assert_prints_match(repr(ours), repr(theirs))
    else:
        assert ours == theirs, path


def _run_jax_tool(monkeypatch, capsys, module, argv):
    """``module.main()`` of the JAX tool with ``sys.argv`` set; its
    standard output."""
    monkeypatch.setattr(sys, "argv", [module.__file__] + argv)
    capsys.readouterr()
    module.main()
    return capsys.readouterr().out


def _port_out(capsys, fn, *args):
    capsys.readouterr()
    fn(*args)
    return capsys.readouterr().out


# ----------------------------------------------------------- the weights

@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """One 144x192 PNG pair in each split (large enough for 128-pixel
    crops; evaluation resizes it to 720x480)."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:144, 0:192] / 192.0
    for split in ("train", "raindrop_test"):
        for i in range(1):
            base = 0.5 + 0.4 * np.sin(2 * np.pi * (xx * (i + 2) + yy))
            gt = np.clip(np.stack([base, base[::-1], base[:, ::-1]], -1)
                         + 0.05 * rng.standard_normal((144, 192, 3)), 0, 1)
            cond = np.clip(0.7 * gt + 0.15 + 0.05
                           * rng.standard_normal(gt.shape), 0, 1)
            for folder, name, arr in (("input", f"{i}_rain.png", cond),
                                      ("gt", f"{i}_clean.png", gt)):
                path = root / "raindrop" / split / folder / name
                path.parent.mkdir(parents=True, exist_ok=True)
                Image.fromarray((arr * 255 + 0.5).astype(np.uint8)).save(
                    path)
    return str(root)


def _tiny_yaml(tmp_path, data_dir, t_start=0, extra=""):
    path = tmp_path / "tiny.yaml"
    path.write_text(TINY_YAML.format(data=data_dir, t_start=t_start) + extra)
    return str(path)


def _init_params(jcfg):
    """JAX UNet params (init) and HFRM params (init, with its zero-started
    scales drawn so the network is not the identity) for ``jcfg``."""
    p = jcfg.data.image_size
    uparams = jax.jit(JaxUNet.from_config(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, p, p, 96)),
        jnp.zeros((1,)))["params"]
    hparams = jax.jit(JaxHFRM.from_config(jcfg).init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)))["params"]
    rng = np.random.default_rng(4)
    hparams = jax.tree_util.tree_map_with_path(
        lambda path, v: jnp.asarray(0.3 * rng.standard_normal(v.shape),
                                    v.dtype)
        if path[-1].key in ("beta", "gamma") else v, hparams)
    return uparams, hparams


@pytest.fixture(scope="module")
def jax_params(data_dir, tmp_path_factory):
    return _init_params(jax_load_config(_tiny_yaml(
        tmp_path_factory.mktemp("cfg"), data_dir)))


def _patch_jax_loaders(monkeypatch, uparams, hparams):
    """The JAX tools' checkpoint reads hand over these params."""
    import scripts.train_diffusion
    from wavedm_tpu.utils import checkpoint

    state = types.SimpleNamespace(params=uparams, ema=uparams)
    hstate = types.SimpleNamespace(params=hparams, ema=hparams)
    monkeypatch.setattr(checkpoint, "load_checkpoint",
                        lambda path, *a, **k: ((hstate if "hfrm" in path
                                                else state), {}))
    monkeypatch.setattr(checkpoint, "find_latest_checkpoint",
                        lambda d: os.path.join(d, "latest"))
    monkeypatch.setattr(scripts.train_diffusion, "load_hfrm_params",
                        lambda path, cfg: hparams)


def _port_restorer(cfg, jax_params):
    uparams, hparams = jax_params
    m, h = cfg.model, cfg.hfrm
    return build_restorer(
        cfg, unet_state_dict_from_flax(uparams, len(m.ch_mult),
                                       m.num_res_blocks),
        hfrm_state_dict_from_flax(hparams, h.enc_blk_nums, h.middle_blk_num,
                                  h.dec_blk_nums), device="cpu")


def _jax_normal(key, shape_nchw):
    """JAX's normal draw of NHWC ``shape`` from ``key``, as NCHW."""
    b, c, hh, ww = shape_nchw
    x = np.asarray(jax.random.normal(key, (b, hh, ww, c), jnp.float32))
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


# ---------------------------------------------------------------- tools

def test_make_synthetic_dataset_matches_jax(monkeypatch, capsys, tmp_path):
    """JAX's PIL-written PNGs and the port's decode to equal arrays (the
    port's equal to the same pairs rounded alike)."""
    from tools import make_synthetic_dataset as jax_tool

    args = ["--n-train", "2", "--n-test", "1"]
    theirs = _run_jax_tool(monkeypatch, capsys, jax_tool,
                           ["--data-dir", str(tmp_path / "jax")] + args)
    ours = _port_out(capsys, make_synthetic_dataset.main,
                     ["--data-dir", str(tmp_path / "port")] + args)
    assert ours.replace("port", "jax") == theirs
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert len(files) == 6
    for rel in files:
        a = np.asarray(Image.open(tmp_path / "port" / rel))
        b = np.asarray(Image.open(tmp_path / "jax" / rel))
        assert a.shape == (480, 720, 3) and np.array_equal(a, b), rel
    cond, _ = SyntheticPairs(n_images=1, seed=10_000, severity="heavy")[0]
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "port" / "raindrop" /
                              "raindrop_test" / "input" / "0000.png")),
        np.clip(cond * 255.0 + 0.5, 0, 255).astype(np.uint8))


def _sweep_logs(root):
    rows = {"full_chain": "=> loaded checkpoint 'x'\npsnr all torch 20.5\n"
            "psnr all np 21.25\npsnr all GPU 21.5\nssim all 0.61\n"
            "(8 images)\n",
            "t300_s10": "psnr all torch 22.125\nssim all 0.7\n(8 images)\n",
            "t300_s10.full": "psnr all torch 1.0\n", "diag": "psnr 3\n",
            "empty": "nothing here\n"}
    os.makedirs(root, exist_ok=True)
    for name, text in rows.items():
        with open(os.path.join(root, name + ".log"), "w") as f:
            f.write(text)


@pytest.mark.parametrize("source", ["committed_r5_sweep", "rows"])
def test_summarize_sweep_matches_jax(monkeypatch, capsys, tmp_path, source):
    """Both copies on the committed ``results/r5_sweep`` (its row logs hold
    no metric lines: both exit 1 and write nothing) and on a directory of
    row logs (equal JSON and table), ``--out`` in ``tmp_path``."""
    from tools import summarize_sweep as jax_tool

    if source == "rows":
        directory = str(tmp_path / "sweep")
        _sweep_logs(directory)
    else:
        directory = os.path.join(REPO, "results", "r5_sweep")
    before = {f: os.path.getmtime(os.path.join(directory, f))
              for f in os.listdir(directory)}
    outs = {}
    for who in ("jax", "port"):
        out = str(tmp_path / f"{who}.json")
        argv = ["--dir", directory, "--out", out]
        capsys.readouterr()
        if who == "jax":
            monkeypatch.setattr(sys, "argv", ["summarize_sweep.py"] + argv)
            try:
                jax_tool.main()
                rc = 0
            except SystemExit as e:      # its exit on no rows
                rc = e.code
        else:
            rc = summarize_sweep.main(argv)
        captured = capsys.readouterr()
        outs[who] = (rc, captured.out.replace(out, "OUT"), captured.err,
                     json.load(open(out)) if os.path.exists(out) else None)
    assert outs["port"] == outs["jax"]
    if source == "rows":
        assert outs["port"][3] == {
            "full_chain": {"n_images": 8, "psnr_np_y": 21.25,
                           "psnr_torch": 20.5, "psnr_y": 21.5, "ssim": 0.61},
            "t300_s10": {"n_images": 8, "psnr_torch": 22.125, "ssim": 0.7}}
    else:
        assert outs["port"][0] == 1 and outs["port"][3] is None
    assert {f: os.path.getmtime(os.path.join(directory, f))
            for f in os.listdir(directory)} == before


def test_summarize_sweep_default_out_is_under_results_torch():
    ns = summarize_sweep.out_path("r5_sweep.summary.json")
    assert ns == os.path.join("results", "torch", "r5_sweep.summary.json")


def test_diag_quality_matches_jax(monkeypatch, capsys, tmp_path, data_dir,
                                  jax_params):
    """Both splits, one image each, 2 DDIM steps over 24 patches of the
    120x180 wavelet grid; the printed PSNR-Y rows and LL MSEs agree."""
    from tools import diag_quality as jax_tool

    _patch_jax_loaders(monkeypatch, *jax_params)
    cfg_path = _tiny_yaml(tmp_path, data_dir)
    argv = ["--config", cfg_path, "--resume", "ck", "--hfrm-ckpt", "hfrm",
            "--split", "both", "--n", "1"]
    theirs = _run_jax_tool(monkeypatch, capsys, jax_tool, argv)

    args = diag_quality.parse_args(argv + ["--device", "cpu"])
    cfg = load_config(args.config)
    restorer = _port_restorer(cfg, jax_params)
    key_init, _ = jax.random.split(jax.random.PRNGKey(cfg.training.seed))
    ours = _port_out(capsys, diag_quality.run, restorer, args.split, args.n,
                     functools.partial(_jax_normal, key_init))
    assert ours.count("LL MSE") == 2 and "== split test (1 images) ==" in ours
    assert_prints_match(ours, theirs)


@pytest.mark.parametrize("pred_type", ["eps", "v"])
def test_diag_teacher_forced_matches_jax(monkeypatch, capsys, tmp_path,
                                         data_dir, jax_params, pred_type):
    """Four 128x128 crops of the test image through the t ladder; with
    ``pred_type: v`` the output is read as v and turned into eps."""
    from tools import diag_teacher_forced as jax_tool

    _patch_jax_loaders(monkeypatch, *jax_params)
    cfg_path = _tiny_yaml(tmp_path, data_dir, extra=(
        f"training: {{pred_type: {pred_type}}}\n"))
    argv = ["--config", cfg_path, "--resume", "ck", "--hfrm-ckpt", "hfrm",
            "--n-crops", "4"]
    theirs = _run_jax_tool(monkeypatch, capsys, jax_tool, argv)

    cfg = load_config(cfg_path)
    restorer = _port_restorer(cfg, jax_params)
    crops = diag_teacher_forced.crops_of(cfg, "test", 4)
    key, subs = jax.random.PRNGKey(0), []
    for _ in diag_teacher_forced.T_LADDER:
        key, sub = jax.random.split(key)
        subs.append(sub)
    ours = _port_out(capsys, diag_teacher_forced.report, restorer, crops,
                     lambda k, shape: _jax_normal(subs[k], shape))
    assert len(ours.strip().splitlines()) == 11
    assert_prints_match(ours, theirs)
