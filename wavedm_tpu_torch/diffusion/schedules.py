"""Diffusion beta schedules and alpha-bars.

Betas are built in float64 with numpy (as the reference does); alpha-bars
are the cumulative product of (1 - beta) with an alpha_bar(-1) = 1 boundary
in front, in the dtype of the betas given.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["get_beta_schedule", "alpha_bars", "compute_alpha",
           "ddim_timesteps"]


def get_beta_schedule(beta_schedule: str, *, beta_start: float,
                      beta_end: float,
                      num_diffusion_timesteps: int) -> np.ndarray:
    """(T,) float64 betas: linear, quad, const, jsd or sigmoid."""
    T = num_diffusion_timesteps
    if beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, T, dtype=np.float64)
    elif beta_schedule == "quad":
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, T,
                            dtype=np.float64) ** 2
    elif beta_schedule == "const":
        betas = np.full(T, beta_end, dtype=np.float64)
    elif beta_schedule == "jsd":
        betas = 1.0 / np.linspace(T, 1, T, dtype=np.float64)
    elif beta_schedule == "sigmoid":
        xs = np.linspace(-6, 6, T)
        betas = 1.0 / (1.0 + np.exp(-xs)) * (beta_end - beta_start) + beta_start
    else:
        raise NotImplementedError(f"beta schedule {beta_schedule!r}")
    return betas


def alpha_bars(betas: torch.Tensor) -> torch.Tensor:
    """(T+1,) cumprod of (1 - beta) with alpha_bar[0] = 1 (the t = -1
    boundary), so alpha_bar(t) = alpha_bars(betas)[t + 1]."""
    a = torch.cumprod(1.0 - betas, dim=0)
    return torch.cat([torch.ones(1, dtype=a.dtype, device=a.device), a])


def compute_alpha(betas: torch.Tensor, t) -> torch.Tensor:
    """alpha_bar(t) for integer timesteps ``t`` (t = -1 maps to 1.0), shape
    (len(t),)."""
    t = torch.as_tensor(t, dtype=torch.long, device=betas.device)
    return alpha_bars(betas)[t + 1]


def ddim_timesteps(num_diffusion_timesteps: int,
                   sampling_timesteps: int) -> np.ndarray:
    """Ascending uniform-skip DDIM sequence, ``range(0, T, T // steps)``:
    T=1000, 25 steps -> [0, 40, ..., 960]."""
    skip = num_diffusion_timesteps // sampling_timesteps
    return np.arange(0, num_diffusion_timesteps, skip, dtype=np.int32)
