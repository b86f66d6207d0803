"""Noise-estimation loss and antithetic timestep sampling, NCHW.

The port of ``wavedm_tpu/diffusion/loss.py``: the UNet input is
[cond | x_t | other-HF-channels] along channels, the epsilon (or v) loss is
the sum over pixels then the mean over the batch, and the x0 MSE is
returned beside it.  Randomness comes from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["LossOutput", "antithetic_timesteps", "noise_estimation_loss"]


class LossOutput(NamedTuple):
    simple_loss: torch.Tensor   # E_b[ w_t * sum_pix (target - output)^2 ]
    mse_loss: torch.Tensor      # E_b[ sum_pix (x_tar - x0_pred)^2 ]
    e_pred: torch.Tensor        # (B, pred_c, H, W) implied epsilon
    x0_pred: torch.Tensor       # (B, pred_c, H, W)


def antithetic_timesteps(generator: torch.Generator, n: int,
                         num_timesteps: int) -> torch.Tensor:
    """Draw n//2 + 1 uniform ints in [0, T), mirror them as T-1-t, keep the
    first n: (n,) int64 on the generator's device."""
    half = n // 2 + 1
    t = torch.randint(0, num_timesteps, (half,), generator=generator,
                      device=generator.device)
    return torch.cat([t, num_timesteps - t - 1])[:n]


def noise_estimation_loss(
    model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    t: torch.Tensor,
    e: torch.Tensor,
    betas: torch.Tensor,
    *,
    inp_channels: int,
    pred_channels: int,
    use_other_channels: bool,
    pred_type: str = "eps",
    snr_gamma: float = 0.0,
) -> LossOutput:
    """Eps- or v-prediction loss in the (wavelet) diffusion domain.

    x0: (B, C, H, W), channels [cond(inp) | target(pred) | other(HF)];
    t: (B,) integer timesteps; e: (B, pred_channels, H, W) noise;
    betas: (T,) float32.  ``snr_gamma`` > 0 applies min-SNR-gamma weights
    min(SNR, gamma)/SNR (eps) or min(SNR, gamma)/(SNR + 1) (v) per sample."""
    a = torch.cumprod(1.0 - betas, dim=0)[t][:, None, None, None].to(x0.dtype)
    x_inp = x0[:, :inp_channels]
    x_tar = x0[:, inp_channels:inp_channels + pred_channels]
    xt = x_tar * a.sqrt() + e * (1.0 - a).sqrt()
    x = (torch.cat([xt, x0[:, inp_channels + pred_channels:]], dim=1)
         if use_other_channels else xt)
    output = model_fn(torch.cat([x_inp, x], dim=1), t.float())

    if pred_type == "v":
        target = a.sqrt() * e - (1.0 - a).sqrt() * x_tar
        e_pred = (1.0 - a).sqrt() * xt + a.sqrt() * output
        x0_pred = a.sqrt() * xt - (1.0 - a).sqrt() * output
    elif pred_type == "eps":
        target = e
        e_pred = output
        x0_pred = (xt - output * (1.0 - a).sqrt()) / a.sqrt()
    else:
        raise ValueError(f"pred_type must be eps or v, got {pred_type!r}")

    per_image = (target - output).square().sum(dim=(1, 2, 3))
    if snr_gamma > 0.0:
        snr = (a / (1.0 - a))[:, 0, 0, 0]
        w = torch.clamp(snr, max=snr_gamma) / (
            snr + 1.0 if pred_type == "v" else snr)
        per_image = per_image * w
    simple = per_image.mean()
    mse = (x_tar - x0_pred).square().sum(dim=(1, 2, 3)).mean()
    return LossOutput(simple, mse, e_pred, x0_pred)
