"""WaveDM's restoration of whole images, in float32: the wavelet entry,
the HFRM's high-frequency bands, the tiled DDIM chain and the exit.

For (B, 3, H, W) images in [0, 1] and the x_T noise (B, 3, H/4, W/4):

  cond = DWT(2 x - 1)                         48 channels at H/4 x W/4
  hf   = DWT(2 HFRM(x) - 1)                   its LL band seeds the chain
  x    = sqrt(abar(t_s)) hf[:, :3] + sqrt(1 - abar(t_s)) noise
  for t in t_s, ..., 0 (``steps`` of ``t_start // steps``):
      eps  = the UNet on the 64x64 patches of [cond | x | hf[:, 3:]] at
             stride ``grid_r`` (plus flush last rows and columns),
             summed back and divided by how many patches cover each pixel
      x0   = (x - sqrt(1 - abar(t)) eps) / sqrt(abar(t))
      x    = sqrt(abar(t')) x0 + sqrt(1 - abar(t')) eps   (DDIM, eta 0)
  out  = clamp((IWT([x0 of the last step | hf[:, 3:]]) + 1) / 2, 0, 1)

abar(t) is the float32 cumulative product of 1 - beta over beta =
linspace(beta_start, beta_end, T) (float64, cast), abar(-1) = 1.  This is
the production profile's chain (``t_start`` > 0, ``init_ll: hfrm``,
``x0_pred_index: -1``, ``eta: 0``), the only one the benchmark runs.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from portbench.reference.hfrm import HFRM
from portbench.reference.precision import Prec
from portbench.reference.unet import UNet
from portbench.reference.wavelet import dwt, iwt

__all__ = ["alpha_bars", "chain_times", "grid_corners", "restore"]


def alpha_bars(cfg: dict) -> torch.Tensor:
    """(T + 1,) float32: abar(t) at index t + 1, abar(-1) = 1."""
    d = cfg["diffusion"]
    betas = torch.as_tensor(np.linspace(d["beta_start"], d["beta_end"],
                                        d["num_diffusion_timesteps"]),
                            dtype=torch.float32)
    return torch.cat([torch.ones(1), torch.cumprod(1.0 - betas, dim=0)])


def chain_times(cfg: dict) -> List[int]:
    """The chain's timesteps, first to last."""
    s = cfg["sampling"]
    skip = max(1, s["t_start"] // s["sampling_timesteps"])
    return list(range(0, s["t_start"], skip))[::-1]


def grid_corners(h: int, w: int, p: int, r: int) -> List[Tuple[int, int]]:
    rows = list(range(0, h - p + 1, r))
    cols = list(range(0, w - p + 1, r))
    if rows[-1] + p < h:
        rows.append(h - p)
    if cols[-1] + p < w:
        cols.append(w - p)
    return [(i, j) for i in rows for j in cols]


def _eps(unet: UNet, prec: Prec, x: torch.Tensor, t: int,
         corners, p: int, chunk: int) -> torch.Tensor:
    """The overlap-averaged UNet output over the image batch ``x``."""
    b, _, h, w = x.shape
    patches = torch.stack([x[:, :, i:i + p, j:j + p] for i, j in corners], 1)
    patches = patches.reshape((-1,) + patches.shape[2:])
    tt = torch.full((patches.shape[0],), float(t), device=x.device)
    out = torch.cat([unet.run(prec, patches[k:k + chunk], tt[k:k + chunk])
                     for k in range(0, patches.shape[0], chunk)])
    out = out.reshape((b, len(corners)) + out.shape[1:])
    acc = x.new_zeros((b, out.shape[2], h, w))
    cnt = x.new_zeros((1, 1, h, w))
    for k, (i, j) in enumerate(corners):
        acc[:, :, i:i + p, j:j + p] += out[:, k]
        cnt[:, :, i:i + p, j:j + p] += 1.0
    return acc / cnt


def _check_chain(cfg: dict) -> None:
    s = cfg["sampling"]
    chain = (s["t_start"] > 0, s["init_ll"], s["eta"], s["solver"],
             s["x0_pred_index"], s["whole_image"],
             cfg["training"]["pred_type"], cfg["diffusion"]["beta_schedule"])
    if chain != (True, "hfrm", 0.0, "ddim", -1, False, "eps", "linear"):
        raise ValueError(f"the reference runs the production chain only, "
                         f"not {chain}")


@torch.no_grad()
def restore(cfg: dict, unet: UNet, hfrm: HFRM, images: torch.Tensor,
            noise: torch.Tensor, prec: Prec = Prec(),
            chunk: int = 90) -> torch.Tensor:
    """(B, 3, H, W) images and (B, 3, H/4, W/4) noise -> the restored
    (B, 3, H, W), all float32; the UNet runs ``chunk`` patches a call."""
    _check_chain(cfg)
    m = cfg["model"]
    pc, p = m["pred_channels"], cfg["data"]["image_size"]
    abar = alpha_bars(cfg).to(images.device)
    times = chain_times(cfg)
    cond = dwt(2.0 * images - 1.0)
    hf = dwt(2.0 * hfrm.run(prec, images) - 1.0)
    a0 = abar[times[0] + 1]
    x = hf[:, :pc] * a0.sqrt() + noise * (1.0 - a0).sqrt()
    other = hf[:, m["other_channels_begin"]:]
    corners = grid_corners(x.shape[2], x.shape[3], p,
                           cfg["sampling"]["grid_r"])
    x0 = x
    for k, t in enumerate(times):
        t_next = times[k + 1] if k + 1 < len(times) else -1
        a, a_next = abar[t + 1], abar[t_next + 1]
        eps = _eps(unet, prec, torch.cat([cond, x, other], 1), t, corners,
                   p, chunk)
        x0 = (x - eps * (1.0 - a).sqrt()) / a.sqrt()
        x = a_next.sqrt() * x0 + (1.0 - a_next).sqrt() * eps
    full = torch.cat([x0, hf[:, pc:]], dim=1)
    return torch.clamp((iwt(full) + 1.0) / 2.0, 0.0, 1.0)
