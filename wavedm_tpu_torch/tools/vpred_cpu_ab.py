"""Toy-scale eps-vs-v A/B: does v-prediction fix the high-t conditioning
hole?

A mechanism study at toy scale (16x16 conditional restoration, a tiny
UNet) that runs in minutes: an eps-parameterized conditional model
converges teacher-forced at low and mid t but never learns to use the
conditioning at t >= 800 (the eps target degenerates to x_t), so a full-T
DDIM chain from noise starts with ~15 wasted steps; v-prediction's target
degenerates to -x0 there instead.

Protocol, identical data, seeds and steps for both arms:
  * the teacher-forced implied-x0 MSE at a t ladder (the conditioning
    probe),
  * the 25-step DDIM chain from pure noise (the reference protocol's
    shape), 10-step DDIM and dpmpp2m chains, and the t_start = 300,
    10-step chain from the noised condition,
  * the degraded input's PSNR for scale.

The port's counterpart of the JAX package's ``tools/vpred_cpu_ab.py``,
with its data (numpy seeds 7 and 1), config (``raindrop.yaml``, the pixel
profile, cut to ch 32, ch_mult 1,2, one res block, attention at 8, batch
16) and output.  JAX forces the CPU; the port runs where ``--device``
says (the card when not given).

  python -m wavedm_tpu_torch.tools.vpred_cpu_ab [--steps 1500] [--hw 16] \\
      [--out results/torch/vpred_cpu_ab.json] [--device cpu]

Writes one JSON file and prints it as one line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Callable, Optional

import numpy as np

from wavedm_tpu_torch.tools.common import out_path

__all__ = ["make_data", "toy_config", "run_arm", "main"]

TF_LADDER = (200, 500, 800, 900, 960, 990)


def make_data(n: int, hw: int, rng: np.random.Generator) -> np.ndarray:
    """Synthetic conditional restoration pairs: a smooth ground truth and a
    hazed, noisy condition, (n, hw, hw, 6) [cond | gt] in [0, 1]."""
    base = rng.standard_normal((n, hw * 2, hw * 2, 3)).astype(np.float32)
    gt = base.reshape(n, hw, 2, hw, 2, 3).mean((2, 4))
    gt = (gt - gt.min((1, 2, 3), keepdims=True)) / np.ptp(
        gt, axis=(1, 2, 3)).reshape(-1, 1, 1, 1)
    haze = rng.uniform(0.2, 0.5, (n, 1, 1, 1)).astype(np.float32)
    noise = 0.05 * rng.standard_normal(gt.shape).astype(np.float32)
    cond = np.clip(gt * (1 - haze) + haze * 0.8 + noise, 0, 1)
    return np.concatenate([cond, gt], axis=-1)


def toy_config(hw: int, arm: str = "eps"):
    from wavedm_tpu_torch.config import pixel_profile

    cfg = pixel_profile()
    cfg.data.image_size = hw
    cfg.data.patch_size = hw          # identity crop: the data is the patch
    cfg.model.ch = 32
    cfg.model.ch_mult = (1, 2)
    cfg.model.attn_resolutions = (8,)
    cfg.model.num_res_blocks = 1
    cfg.training.batch_size = 16
    cfg.training.pred_type = arm
    return cfg.validate()


def run_arm(cfg, train: np.ndarray, test: np.ndarray, steps: int,
            init_sd, device, draws: Optional[Callable[[int], tuple]] = None,
            e_tf=None, noise=None) -> dict:
    """Train one arm (``cfg.training.pred_type``) from ``init_sd`` for
    ``steps`` steps on batches of ``train`` drawn by ``default_rng(1)``,
    then probe its EMA weights on ``test``.  ``draws(i)`` gives step i's
    (t, e) (None: the train state's generator draws them); ``e_tf`` and
    ``noise`` are the teacher-forced eps and the chains' x_T, NCHW like
    the test images."""
    import torch

    from wavedm_tpu_torch.diffusion.sampling import ddim_sample
    from wavedm_tpu_torch.diffusion.schedules import (alpha_bars,
                                                      ddim_timesteps,
                                                      get_beta_schedule)
    from wavedm_tpu_torch.inference.loader import build_unet
    from wavedm_tpu_torch.inference.restoration import (
        data_transform, inverse_data_transform)
    from wavedm_tpu_torch.training.state import create_train_state
    from wavedm_tpu_torch.training.train_step import make_train_step

    arm = cfg.training.pred_type
    model = build_unet(cfg, init_sd, device, train=True)
    state = create_train_state(model, cfg.optim, 0)
    step = make_train_step(cfg, model)
    t0 = time.time()
    order = np.random.default_rng(1)
    bs = cfg.training.batch_size
    for i in range(steps):
        idx = order.integers(0, len(train), bs)
        t, e = draws(i) if draws is not None else (None, None)
        m = step(state, train[idx], t=t, e=e)
    loss = float(m.loss)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_s = time.time() - t0

    ema = build_unet(cfg, state.ema, device)
    betas = torch.as_tensor(get_beta_schedule(
        cfg.diffusion.beta_schedule, beta_start=cfg.diffusion.beta_start,
        beta_end=cfg.diffusion.beta_end,
        num_diffusion_timesteps=cfg.diffusion.num_diffusion_timesteps),
        dtype=torch.float32, device=device)
    abar = alpha_bars(betas)[1:].cpu().numpy()      # abar[t], t = 0..T-1
    T = cfg.diffusion.num_diffusion_timesteps
    x = data_transform(torch.as_tensor(test, device=device).permute(
        0, 3, 1, 2))
    cond_t, gt_t = x[:, :3], x[:, 3:]
    gt01 = torch.as_tensor(test[..., 3:], device=device).permute(0, 3, 1, 2)
    e_tf = torch.as_tensor(e_tf, dtype=torch.float32, device=device)
    noise = torch.as_tensor(noise, dtype=torch.float32, device=device)

    def model_fn(xx, tt):
        return ema(xx, tt)

    def chain_psnr(x_init, seq, solver="ddim"):
        x_final, _ = ddim_sample(model_fn, x_init, cond_t, seq, betas,
                                 pred_type=arm, solver=solver)
        mse = float(torch.mean(torch.square(
            inverse_data_transform(x_final) - gt01)))
        return round(-10 * np.log10(mse), 2), round(mse, 5)

    with torch.no_grad():
        tf = {}
        for t in TF_LADDER:
            a = float(abar[t])
            sa, s1a = math.sqrt(a), math.sqrt(1 - a)
            xt = gt_t * sa + e_tf * s1a
            out = ema(torch.cat([cond_t, xt], 1),
                      torch.full((xt.shape[0],), float(t), device=device))
            if arm == "v":
                x0 = sa * xt - s1a * out
            else:
                x0 = (xt - out * s1a) / sa
            tf[t] = round(float(torch.mean(torch.square(x0 - gt_t))), 4)
        full_psnr, full_mse = chain_psnr(noise, ddim_timesteps(T, 25))
        # the solver dial: can 10-step dpmpp2m match the 25-step chain?
        seq10 = ddim_timesteps(T, 10)
        dpm10_psnr, _ = chain_psnr(noise, seq10, solver="dpmpp2m")
        ddim10_psnr, _ = chain_psnr(noise, seq10)
        # truncated refinement from the degraded condition (t_start 300,
        # 10 steps: the production profile's shape; the toy task has no
        # stage-1 restorer, so the condition is the start)
        seq_t = np.arange(0, 300, 300 // 10, dtype=np.int32)
        a_s = float(abar[int(seq_t[-1])])
        x_t300 = cond_t * math.sqrt(a_s) + noise * math.sqrt(1 - a_s)
        t300_psnr, t300_mse = chain_psnr(x_t300, seq_t)
    return {"final_train_loss": round(loss, 2),
            "train_s": round(train_s, 1),
            "teacher_forced_x0_mse": tf,
            "chain25_mse": full_mse,
            "chain25_psnr_db": full_psnr,
            "chain10_ddim_psnr_db": ddim10_psnr,
            "chain10_dpmpp2m_psnr_db": dpm10_psnr,
            "t300_s10_mse": t300_mse,
            "t300_s10_psnr_db": t300_psnr}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--hw", type=int, default=16)
    ap.add_argument("--out", default=out_path("vpred_cpu_ab.json"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch

    from wavedm_tpu_torch.inference.loader import build_unet, resolve_device
    from wavedm_tpu_torch.utils.gpu_lock import acquire_gpu_lock

    device = resolve_device(args.device)
    acquire_gpu_lock("vpred_cpu_ab", device)
    hw = args.hw
    rng_np = np.random.default_rng(7)
    train = make_data(256, hw, rng_np)
    test = make_data(32, hw, rng_np)
    # both arms start from one network, as in JAX (one key for both)
    init_sd = build_unet(toy_config(hw), None, device,
                         train=True).state_dict()
    shape = (len(test), 3, hw, hw)
    e_tf = torch.randn(shape, generator=torch.Generator(
        device=device).manual_seed(3), device=device)
    noise = torch.randn(shape, generator=torch.Generator(
        device=device).manual_seed(4), device=device)

    results = {arm: run_arm(toy_config(hw, arm), train, test, args.steps,
                            init_sd, device, e_tf=e_tf, noise=noise)
               for arm in ("eps", "v")}
    cond01 = test[..., :3]
    results["degraded_input_psnr_db"] = round(float(
        -10 * np.log10(np.mean((cond01 - test[..., 3:]) ** 2))), 2)
    results["steps"] = args.steps
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
