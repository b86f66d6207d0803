"""The pixel configuration's weights and work, on its reference UNet
(``reference/pixel.py``, 6 input channels where ``UNet.from_config``
counts the wavelet model's).

- :func:`seeded` and :func:`reference`: as ``lib/weights.py``'s, for the
  pixel UNet alone (the pixel path has no HFRM), drawn by
  ``make_weights`` under the same tag, so the names are the port's;
- :func:`restore_call`: the FLOPs of one restore, counted as
  ``lib/flops.py`` counts them: the UNet on every patch of every image,
  in all times the steps the output needs (up to and with the kept step;
  the steps after it are waste, which ``discarded_step_pct.restore``
  reads), in convolutions times the steps the chain runs.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.lib.flops import META, Work, count
from portbench.lib.weights import make_weights
from portbench.reference.pixel import kept_step, unet_from_config
from portbench.reference.precision import Prec
from portbench.reference.sampler import grid_corners
from portbench.reference.unet import UNet

__all__ = ["seeded", "reference", "unet_forward", "patches",
           "restore_call"]


def _meta(raw: dict) -> UNet:
    with torch.device(META):
        return unet_from_config(raw)


def seeded(raw: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The pixel UNet's float32 state_dict for the run's seed."""
    return make_weights(_meta(raw), seed, "unet", device)


def reference(raw: dict, seed: int, device) -> UNet:
    """The reference pixel UNet on ``device`` with the seeded weights."""
    unet = _meta(raw).to_empty(device=device)
    unet.load_state_dict(seeded(raw, seed, device))
    return unet


def unet_forward(raw: dict, n: int) -> Work:
    """One UNet call on ``n`` patches of [cond | x_t]."""
    unet = _meta(raw)
    p = raw["data"]["image_size"]
    x = torch.empty(n, unet.conv_in.weight.shape[1], p, p, device=META)
    t = torch.zeros(n, device=META)
    with torch.no_grad():
        return count(lambda: unet.run(Prec(), x, t))


def patches(raw: dict, height: int, width: int) -> int:
    """The patches of one image of ``height`` x ``width``."""
    return len(grid_corners(height, width, raw["data"]["image_size"],
                            raw["sampling"]["grid_r"]))


def restore_call(raw: dict, batch: int, height: int, width: int) -> Work:
    """One restore of ``batch`` images, each step's UNet call on all the
    patches: ``total`` over the steps up to and with the kept one (the
    work the output needs), ``conv`` over every step the chain runs (the
    convolutions the conv kernels run)."""
    one = unet_forward(raw, batch * patches(raw, height, width))
    return Work(total=one["total"] * (kept_step(raw) + 1),
                conv=one["conv"] * raw["sampling"]["sampling_timesteps"])
