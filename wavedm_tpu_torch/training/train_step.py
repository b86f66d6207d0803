"""The stage-2 diffusion train step.

One call: batch prep (pixels -> Haar wavelet domain) -> antithetic t and
noise draws -> eps/v loss -> backward -> optimizer -> EMA, updating the
``TrainState`` in place.  The port of ``wavedm_tpu/training/train_step.py``
for the wavelet domain; batches arrive as (B, P, P, 6) [cond | gt] pixels in
[0, 1] (the JAX layout) and run as NCHW inside.  The pixel, whole-image
(``global_attn``) and Laplacian domains are not ported (ROADMAP item 15).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn as nn

from wavedm_tpu_torch.config import Config
from wavedm_tpu_torch.diffusion.ema import ema_update
from wavedm_tpu_torch.diffusion.loss import (antithetic_timesteps,
                                             noise_estimation_loss)
from wavedm_tpu_torch.diffusion.schedules import get_beta_schedule
from wavedm_tpu_torch.inference.restoration import (data_transform,
                                                    inverse_data_transform)
from wavedm_tpu_torch.ops.wavelet import wavelet_dec
from wavedm_tpu_torch.training.state import TrainState

__all__ = ["data_transform", "inverse_data_transform", "prepare_wavelet_batch",
           "StepMetrics", "check_domain", "make_train_step"]


def check_domain(cfg: Config) -> None:
    """Raise for the training domains the port does not have yet."""
    d = cfg.data
    if not d.wavelet or d.wavelet_in_unet or d.lap or d.global_attn:
        raise NotImplementedError(
            "only the wavelet-domain diffusion training is ported; the pixel, "
            "global and lap domains are ROADMAP item 15")


def prepare_wavelet_batch(x: torch.Tensor, cfg: Config,
                          hfrm: Optional[nn.Module] = None) -> torch.Tensor:
    """(B, P, P, 6) [cond | gt] pixels in [0,1] -> (B, 96, P/4, P/4) NCHW
    training tensor [cond(48) | gt LL(pred) | HF(45)].

    With ``use_gt_in_train`` the HF conditioning is the ground truth's
    wavelet bands; otherwise the frozen ``hfrm``'s restoration of the cond
    pixels, decomposed (it runs without autograd)."""
    m = cfg.model
    x = x.permute(0, 3, 1, 2)
    x_all = data_transform(x)
    cond_w = wavelet_dec(x_all[:, :3])
    gt_w = wavelet_dec(x_all[:, 3:6])
    if not m.use_other_channels:
        return torch.cat([cond_w, gt_w[:, :m.pred_channels]], dim=1)
    if m.use_gt_in_train:
        hf = gt_w[:, m.other_channels_begin:]
    else:
        if hfrm is None:
            raise ValueError("use_gt_in_train=False requires an hfrm")
        with torch.no_grad():
            restored = hfrm(x[:, :3].contiguous())   # HFRM takes [0,1]
        hf = wavelet_dec(data_transform(restored))[:, m.other_channels_begin:]
    return torch.cat([cond_w, gt_w[:, :m.pred_channels], hf], dim=1)


class StepMetrics(NamedTuple):
    loss: torch.Tensor            # eps loss (sum over pixels, batch mean)
    mse_loss: torch.Tensor        # x0 MSE
    loss_per_pixel: torch.Tensor
    grad_norm: torch.Tensor


def make_train_step(cfg: Config, model: nn.Module,
                    hfrm: Optional[nn.Module] = None
                    ) -> Callable[..., StepMetrics]:
    """``step(state, batch, t=None, e=None) -> StepMetrics``.

    batch: (B, P, P, 6) float32 pixels in [0,1], array or tensor.  t: (B,)
    integer timesteps and e: (B, pred_channels, P/4, P/4) noise; each is
    drawn from ``state.generator`` when not given.  ``training.grad_accum``
    > 1 splits the batch into that many micro-batches and averages their
    gradients into one update."""
    check_domain(cfg)
    m = cfg.model
    device = next(model.parameters()).device
    betas = torch.as_tensor(get_beta_schedule(
        cfg.diffusion.beta_schedule,
        beta_start=cfg.diffusion.beta_start,
        beta_end=cfg.diffusion.beta_end,
        num_diffusion_timesteps=cfg.diffusion.num_diffusion_timesteps,
    ), dtype=torch.float32, device=device)
    num_timesteps = cfg.diffusion.num_diffusion_timesteps
    num_of_pixel = m.pred_channels * cfg.data.image_size ** 2
    accum = cfg.training.grad_accum
    mu = m.ema_rate

    def loss_fn(x, t, e):
        return noise_estimation_loss(
            model, x, t, e, betas, inp_channels=m.in_channels,
            pred_channels=m.pred_channels,
            use_other_channels=m.use_other_channels,
            pred_type=cfg.training.pred_type,
            snr_gamma=cfg.training.snr_gamma)

    def step(state: TrainState, batch, t: Optional[torch.Tensor] = None,
             e: Optional[torch.Tensor] = None) -> StepMetrics:
        x = prepare_wavelet_batch(
            torch.as_tensor(batch, dtype=torch.float32, device=device),
            cfg, hfrm)
        n = x.shape[0]
        if n % accum:
            raise ValueError(
                f"batch of {n} crops not divisible by grad_accum={accum}")
        if t is None:
            t = antithetic_timesteps(state.generator, n, num_timesteps)
        if e is None:
            e = torch.randn((n, m.pred_channels) + tuple(x.shape[2:]),
                            generator=state.generator, device=device)
        t, e = t.to(device), e.to(device=device, dtype=torch.float32)

        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        simple = mse = 0.0
        mb = n // accum
        for i in range(accum):
            sl = slice(i * mb, (i + 1) * mb)
            out = loss_fn(x[sl], t[sl], e[sl])
            main = out.mse_loss if cfg.training.use_mse else out.simple_loss
            (main / accum).backward()
            # micro losses are means over equal micro-batches
            simple = simple + out.simple_loss.detach() / accum
            mse = mse + out.mse_loss.detach() / accum

        grads = [p.grad for p in model.parameters() if p.grad is not None]
        grad_norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        state.optimizer.step()
        ema_update(state.ema, [(k, p) for k, p in model.named_parameters()
                               if k in state.ema], mu)
        state.step += 1
        return StepMetrics(loss=simple, mse_loss=mse,
                           loss_per_pixel=simple / num_of_pixel,
                           grad_norm=grad_norm)

    return step
