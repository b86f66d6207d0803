"""PyTorch port: the sweep and rehearsal drivers of ``wavedm_tpu_torch/tools/``
on the CPU at a tiny size, against the JAX package's shell scripts they
stand for.

- What they run is the scripts' own: ``eval_sweep.ROWS`` are the rows of
  ``scripts/r3_eval_sweep.sh``, ``vpred_rehearsal_ab``'s arms and
  protocols those of ``scripts/r5_vpred_ab.sh``, and the step defaults
  those of the scripts (read from the files).
- The dress rehearsal runs end to end (2 synthetic pairs, 1 + 1 steps);
  its checkpoints feed the sweep (two rows and the diagnostic, then a
  rerun that skips them), the A/B (two arms, then a rerun that skips
  them) and one run of each tool's ``main`` on the CPU.
- ``summarize_sweep`` reads the sweep's logs.
"""

import json
import os
import re
import shlex

import numpy as np
import pytest
import torch

from wavedm_tpu_torch.tools import (diag_quality, diag_teacher_forced,
                                    dress_rehearsal, eval_sweep, seed_study,
                                    summarize_sweep, vpred_cpu_ab,
                                    vpred_rehearsal_ab)
from wavedm_tpu_torch.utils.images import read_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
TINY = ["--set", "model.ch=32", "--set", "model.ch_mult=[1,2]",
        "--set", "model.num_res_blocks=1",
        "--set", "model.attn_resolutions=[4]",
        "--set", "data.image_size=16", "--set", "data.patch_size=64",
        "--set", "hfrm.dim=8", "--set", "hfrm.enc_blk_nums=[1,1]",
        "--set", "hfrm.dec_blk_nums=[1,1]", "--set", "hfrm.middle_blk_num=1",
        "--set", "sampling.sampling_timesteps=2",
        "--set", "sampling.x0_pred_index=-1", "--set", "sampling.grid_r=16",
        "--set", "training.patch_n=2"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: several pytest-xdist workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(name):
    with open(os.path.join(SCRIPTS, name)) as f:
        return f.read()


def _default(text, var):
    return int(re.search(rf"{var}=\${{{var}:-(\d+)}}", text).group(1))


# ------------------------------------------------- the scripts' contents

def test_sweep_rows_are_the_r3_scripts():
    rows = [(m.group(1), shlex.split(m.group(2)))
            for m in re.finditer(r"^run (\S+)[ \t]*(.*)$",
                                 _script("r3_eval_sweep.sh"), re.M)]
    assert [(n, list(a)) for n, a in eval_sweep.ROWS] == rows
    assert len(rows) == 8
    # the resume script runs the same rows (and two dpmpp2m rows after)
    resume = [m.group(1) for m in re.finditer(
        r"^run (\S+)", _script("r5_sweep_resume.sh"), re.M)]
    assert {n for n, _ in eval_sweep.ROWS} <= set(resume)
    args, extra = eval_sweep.parse_args([])
    assert (args.eval_batch, args.diag_n, extra) == (8, 8, [])
    assert "CFG=wavedm_tpu/configs/rehearsal_flagship.yaml" in _script(
        "r3_eval_sweep.sh") and eval_sweep.CONFIG == "rehearsal_flagship"
    assert args.out == os.path.join("results", "torch", "r3_sweep")


def test_ab_arms_and_protocols_are_the_r5_scripts():
    text = _script("r5_vpred_ab.sh")
    arms = [(m.group(1), shlex.split(m.group(2)))
            for m in re.finditer(r"^arm (\w+)[ \t]*(.*)$", text, re.M)]
    assert [(n, list(a)) for n, a in vpred_rehearsal_ab.ARMS] == arms
    t300 = shlex.split(re.search(r'extra="([^"]+)"', text).group(1))
    assert [(n, list(a)) for n, a in vpred_rehearsal_ab.PROTOCOLS] == [
        ("full_chain", []), ("t300", t300)]
    args, _ = vpred_rehearsal_ab.parse_args([])
    assert args.steps == _default(text, "STEPS") == 12000
    assert "CFG=wavedm_tpu/configs/rehearsal_wavelet.yaml" in text
    assert vpred_rehearsal_ab.CONFIG == "rehearsal"


def test_rehearsal_defaults_are_the_scripts():
    text = _script("dress_rehearsal.sh")
    args, _ = dress_rehearsal.parse_args([])
    assert (args.steps1, args.steps2) == (_default(text, "STEPS1"),
                                          _default(text, "STEPS2"))
    assert "CFG=wavedm_tpu/configs/rehearsal_wavelet.yaml" in text
    assert dress_rehearsal.CONFIG == "rehearsal"
    assert (args.n_train, args.n_test) == (32, 8)   # the dataset's defaults
    assert args.work.startswith(os.path.join("results", "torch"))


# --------------------------------------------------------- end to end

@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    """The dress rehearsal at 2 + 2 synthetic pairs, 1 + 1 steps: its work
    directory."""
    work = str(tmp_path_factory.mktemp("rehearsal"))
    assert dress_rehearsal.main([
        "--steps1", "1", "--steps2", "1", "--n-train", "2", "--n-test", "2",
        "--work", work, "--device", "cpu", "--"] + TINY) == 0
    return work


def test_dress_rehearsal_runs_every_stage(rehearsal):
    w = rehearsal
    for split in ("train", "raindrop_test"):
        for sub in ("input", "gt"):
            assert sorted(os.listdir(os.path.join(
                w, "data", "raindrop", split, sub))) == ["0000.png",
                                                         "0001.png"]
    assert os.path.exists(os.path.join(w, "hfrm", "lastest.pth.tar"))
    assert os.listdir(os.path.join(w, "ddpm"))
    with open(os.path.join(w, "eval_diffusion.log")) as f:
        text = f.read()
    assert "(2 images)" in text and "psnr all torch" in text
    assert read_png(os.path.join(w, "images", "0000_output.png")).shape \
        == (480, 720, 3)
    with open(os.path.join(w, "train_diffusion.log")) as f:
        assert "training done at step 1" in f.read()


def _checkpoints(w):
    from wavedm_tpu_torch.utils.checkpoint import find_latest_checkpoint

    hfrm = os.path.join(w, "hfrm", "best.pth.tar")
    if not os.path.exists(hfrm):
        hfrm = os.path.join(w, "hfrm", "lastest.pth.tar")
    return find_latest_checkpoint(os.path.join(w, "ddpm")), hfrm


def test_eval_sweep_logs_resume_and_summary(rehearsal, tmp_path, capsys):
    ckpt, hfrm = _checkpoints(rehearsal)
    out = str(tmp_path / "sweep")
    argv = ["--ckpt", ckpt, "--hfrm-ckpt", hfrm,
            "--out", out, "--rows", "full_chain,t300_s5", "--diag-n", "1",
            "--eval-batch", "2", "--device", "cpu", "--"] + TINY + [
            "--set", f"data.data_dir={rehearsal}/data", "--n-images", "2"]
    assert eval_sweep.main(argv) == 0
    assert sorted(os.listdir(out)) == [
        "diag.full.log", "diag.log", "full_chain.full.log", "full_chain.log",
        "t300_s5.full.log", "t300_s5.log"]
    for row in ("full_chain", "t300_s5"):
        with open(os.path.join(out, f"{row}.log")) as f:
            lines = f.read().splitlines()
        assert lines[0].startswith("=> loading checkpoint")
        assert [ln.split()[:3] for ln in lines[1:4]] == [
            ["psnr", "all", "torch"], ["psnr", "all", "np"],
            ["psnr", "all", "GPU"]]
        assert lines[4].startswith("ssim all") and lines[5] == "(2 images)"
    with open(os.path.join(out, "diag.log")) as f:
        assert f.read().count("LL MSE") == 2
    stamps = {f: os.path.getmtime(os.path.join(out, f))
              for f in os.listdir(out)}
    capsys.readouterr()
    assert eval_sweep.main(argv) == 0           # finished rows are skipped
    said = capsys.readouterr().out
    assert "=== full_chain : done (skipping)" in said
    assert "=== t300_s5 : done (skipping)" in said
    assert {f: os.path.getmtime(os.path.join(out, f))
            for f in os.listdir(out)} == stamps
    assert eval_sweep.main(argv[:argv.index("--rows") + 1] + ["bogus"]
                           + argv[argv.index("--rows") + 2:]) == 2

    summary = str(tmp_path / "summary.json")
    assert summarize_sweep.main(["--dir", out, "--out", summary]) == 0
    rows = json.load(open(summary))
    assert sorted(rows) == ["full_chain", "t300_s5"]
    for row in rows.values():
        assert set(row) == {"psnr_torch", "psnr_np_y", "psnr_y", "ssim",
                            "n_images"} and row["n_images"] == 2
        assert all(np.isfinite(v) for v in row.values())


def test_vpred_rehearsal_ab_arms_and_resume(rehearsal, tmp_path, capsys):
    _, hfrm = _checkpoints(rehearsal)
    out = str(tmp_path / "ab")
    argv = ["--steps", "1", "--hfrm-ckpt", hfrm, "--data-dir",
            os.path.join(rehearsal, "data"), "--out", out,
            "--n-images", "1", "--device", "cpu", "--"] + TINY
    assert vpred_rehearsal_ab.main(argv) == 0
    files = set(os.listdir(out))
    for arm in ("eps", "v", "eps_snr5"):
        assert {f".done_{arm}", f"train_{arm}.log", f"ckpt_{arm}"} <= files
        for proto in ("full_chain", "t300"):
            with open(os.path.join(out, f"eval_{arm}_{proto}.log")) as f:
                text = f.read()
            assert "psnr all torch" in text and "(1 images)" in text
    # the v arm trained and was evaluated as v
    ckpt = os.listdir(os.path.join(out, "ckpt_v"))[0]
    assert torch.load(os.path.join(out, "ckpt_v", ckpt), map_location="cpu",
                      weights_only=True)["pred_type"] == "v"
    capsys.readouterr()
    assert vpred_rehearsal_ab.main(argv) == 0
    assert capsys.readouterr().out.count("already done") == 3


def test_each_tool_main_runs_on_the_cpu(rehearsal, tmp_path, capsys):
    """``main`` of each device tool exits 0 and prints finite numbers
    (the parity with JAX is held in the ``test_torch_tools*`` files)."""
    ckpt, hfrm = _checkpoints(rehearsal)
    data = ["--set", f"data.data_dir={rehearsal}/data"]
    common = ["--config", "rehearsal", "--resume", ckpt, "--hfrm-ckpt",
              hfrm, "--device", "cpu"] + TINY + data
    runs = {
        "diag_quality": (diag_quality.main, common + [
            "--split", "test", "--n", "1", "--no-begin-from-noise"]),
        "diag_teacher_forced": (diag_teacher_forced.main, common + [
            "--n-crops", "2"]),
        "seed_study": (seed_study.main, [
            "--seeds", "2", "--dtype", "float32",
            "--ckpt-dir", os.path.dirname(ckpt), "--hfrm-ckpt", hfrm,
            "--tstart-steps", "2", "--out", str(tmp_path / "seeds.json"),
            "--device", "cpu"] + TINY),
        "vpred_cpu_ab": (vpred_cpu_ab.main, [
            "--steps", "2", "--hw", "8", "--out", str(tmp_path / "ab.json"),
            "--device", "cpu"]),
    }
    for name, (main, argv) in runs.items():
        capsys.readouterr()
        assert main(argv) == 0, name
        text = capsys.readouterr().out
        numbers = [float(x) for x in re.findall(r"-?\d+\.\d+", text)]
        assert numbers and all(np.isfinite(numbers)), (name, text)
    seeds = json.load(open(tmp_path / "seeds.json"))
    assert seeds["full_25step"]["b8"]["n"] == 8
    assert seeds["tstart300_10step"]["b1"]["n"] == 2
    ab = json.load(open(tmp_path / "ab.json"))
    assert ab["steps"] == 2 and set(ab) == {"eps", "v", "steps",
                                            "degraded_input_psnr_db"}
