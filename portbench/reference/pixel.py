"""The pixel-space patch DDPM of WeatherDiffusion (Ozdenizci and
Legenstein, arXiv 2207.14626; ``configs/raindrop.yml`` of WaveDM's code),
in float32: the UNet of ``unet.py`` on p x p pixel patches of [cond | x_t],
the tiled DDIM chain from noise and the x0 it keeps.

For (B, 3, H, W) images in [0, 1] and the x_T noise (B, 3, H, W):

  cond = 2 x - 1
  x    = noise
  for t in 960, 920, ..., 0 (range(0, T, T // steps), reversed), up to
  and with the kept step ``x0_pred_index``:
      eps  = the UNet on the p x p patches of [cond | x] at stride
             ``grid_r`` (plus flush last rows and columns), summed back and
             divided by how many patches cover each pixel
      x0   = (x - sqrt(1 - abar(t)) eps) / sqrt(abar(t))
      x    = sqrt(abar(t')) x0 + sqrt(1 - abar(t')) eps   (DDIM, eta 0)
  out  = clamp((x0 of the kept step + 1) / 2, 0, 1)

Departures from the published description, each leaving the output as the
published chain gives it:

- the chain stops after the kept step: the steps after it cannot change
  its x0 (the published sampler runs all ``steps`` and keeps
  ``x0_preds[x0_pred_index]``);
- the grid adds a flush last row and column of patches where the stride
  does not reach the edge; WeatherDiffusion's test images are resized to
  multiples of 16, where at ``grid_r`` 16 there are none (720x480: 23 x 38
  = 874 patches);
- the UNet runs ``chunk`` patches a call (WeatherDiffusion: 64), on a
  card channels-last, with cuDNN timing its convolution choices.
"""

from __future__ import annotations

from typing import List

import torch

from portbench.reference.precision import Prec
from portbench.reference.sampler import _eps, alpha_bars, grid_corners
from portbench.reference.unet import UNet

__all__ = ["unet_from_config", "chain_times", "kept_step", "chain",
           "restore"]


def unet_from_config(cfg: dict) -> UNet:
    """The pixel UNet: [cond | x_t], ``in_channels + pred_channels`` wide
    (6), into ``conv_in``."""
    m, d = cfg["model"], cfg["data"]
    return UNet(m["in_channels"] + m["pred_channels"], m["out_ch"], m["ch"],
                m["ch_mult"], m["num_res_blocks"], m["attn_resolutions"],
                d["image_size"])


def chain_times(cfg: dict) -> List[int]:
    """The chain's timesteps, first to last: all ``sampling_timesteps``."""
    t, s = (cfg["diffusion"]["num_diffusion_timesteps"],
            cfg["sampling"]["sampling_timesteps"])
    return list(range(0, t, t // s))[::-1]


def kept_step(cfg: dict) -> int:
    """The index, in chain order, of the step whose x0 is the output."""
    return cfg["sampling"]["x0_pred_index"] % len(chain_times(cfg))


def _check_chain(cfg: dict) -> None:
    d, s = cfg["data"], cfg["sampling"]
    got = (d["wavelet"], d["wavelet_in_unet"], d["lap"], d["global_attn"],
           d["use_fft"], d["begin_from_noise"], s["t_start"], s["eta"],
           s["solver"], s["whole_image"], cfg["training"]["pred_type"],
           cfg["diffusion"]["beta_schedule"])
    if got != (False, False, False, False, False, True, 0, 0.0, "ddim",
               False, "eps", "linear"):
        raise ValueError(f"the pixel reference runs the plain pixel chain "
                         f"from noise only, not {got}")


@torch.no_grad()
def chain(cfg: dict, unet: UNet, images: torch.Tensor, noise: torch.Tensor,
          prec: Prec = Prec(), chunk: int = 64) -> torch.Tensor:
    """(B, 3, H, W) images and (B, 3, H, W) noise -> the kept step's x0
    (B, 3, H, W), all float32; the UNet runs ``chunk`` patches a call."""
    _check_chain(cfg)
    on_card = images.is_cuda
    if on_card:
        # NHWC, cuDNN timing its choices: in float32 at 128x128 its NCHW
        # pick is an FFT convolution at half the speed (H100 80GB HBM3:
        # 14.2 against 26.9 TFLOP/s, 128 patches a call), the result
        # within 2e-6 relative
        unet = unet.to(memory_format=torch.channels_last)
    p = cfg["data"]["image_size"]
    abar = alpha_bars(cfg).to(images.device)
    times = chain_times(cfg)
    keep = kept_step(cfg)
    cond = 2.0 * images - 1.0
    corners = grid_corners(images.shape[2], images.shape[3], p,
                           cfg["sampling"]["grid_r"])
    x = noise
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=True, benchmark=on_card,
                     deterministic=cudnn.deterministic,
                     allow_tf32=cudnn.allow_tf32):
        for k, t in enumerate(times[:keep + 1]):
            t_next = times[k + 1] if k + 1 < len(times) else -1
            a, a_next = abar[t + 1], abar[t_next + 1]
            eps = _eps(unet, prec, torch.cat([cond, x], 1), t, corners, p,
                       chunk)
            x0 = (x - eps * (1.0 - a).sqrt()) / a.sqrt()
            x = a_next.sqrt() * x0 + (1.0 - a_next).sqrt() * eps
    return x0


def restore(cfg: dict, unet: UNet, images: torch.Tensor,
            noise: torch.Tensor, prec: Prec = Prec(),
            chunk: int = 64) -> torch.Tensor:
    """(B, 3, H, W) images in [0, 1] and noise -> the restored (B, 3, H, W)
    in [0, 1]: :func:`chain`'s x0, mapped back and clamped."""
    x0 = chain(cfg, unet, images, noise, prec, chunk)
    return torch.clamp((x0 + 1.0) / 2.0, 0.0, 1.0)
