"""Weights -> models -> restorer, for the port's entry points.

``build_restorer(cfg, unet_sd, hfrm_sd, device=None)`` assembles a
:class:`DiffusiveRestoration` from two state_dicts (or reference
``.pth``/``.pth.tar`` paths).  ``None`` for either builds that model with
random weights drawn from ``cfg.training.seed`` by a ``torch.Generator``
(smoke runs and tests).  Models are built on the meta device first, so no
memory is touched before the weights land on the target device.
``build_unet(..., train=True)`` gives the trainable UNet: float32
parameters cast at use, train mode, gradients on.
"""

from __future__ import annotations

import math
from typing import Mapping, Union

import torch
import torch.nn as nn

from wavedm_tpu_torch.config import Config
from wavedm_tpu_torch.models.hfrm import HFRM
from wavedm_tpu_torch.models.unet import DiffusionUNet
from wavedm_tpu_torch.utils.convert import load_torch_checkpoint

__all__ = ["resolve_device", "init_random_", "build_unet", "build_hfrm",
           "build_restorer"]

Weights = Union[None, str, Mapping[str, torch.Tensor]]


def resolve_device(device=None) -> torch.device:
    """The CUDA card unless the caller names a device; raises when no card
    is present and none was named (the port never drops to the CPU by
    itself)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the port on the CPU")
    return torch.device("cuda")


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """PyTorch's default initialisation, drawn from ``generator``: conv and
    linear weights and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)); norm
    scales 1, norm shifts and residual scales (HFRM beta/gamma) 0.  Draws
    are made in float32 and rounded to each parameter's dtype, so one seed
    gives the same network whatever the compute dtype."""
    for m in module.modules():
        params = dict(m.named_parameters(recurse=False))
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            for p in params.values():
                draw = torch.empty(p.shape, dtype=torch.float32,
                                   device=p.device)
                p.copy_(draw.uniform_(-bound, bound, generator=generator))
        else:
            for name, p in params.items():
                p.fill_(1.0 if name == "weight" else 0.0)
    return module


def _materialize(model: nn.Module, weights: Weights, device: torch.device,
                 seed: int, ema: bool = False,
                 train: bool = False) -> nn.Module:
    model = model.to_empty(device=device)
    if weights is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        init_random_(model, gen)
    else:
        if isinstance(weights, str):
            weights = load_torch_checkpoint(weights, ema=ema)
        model.load_state_dict(weights)
    return model.train(train).requires_grad_(train)


def build_unet(cfg: Config, weights: Weights = None, device=None,
               ema: bool = False, train: bool = False) -> DiffusionUNet:
    device = resolve_device(device)
    with torch.device("meta"):
        unet = DiffusionUNet.from_config(cfg, keep_f32_params=train)
    return _materialize(unet, weights, device, cfg.training.seed, ema, train)


def build_hfrm(cfg: Config, weights: Weights = None, device=None) -> HFRM:
    device = resolve_device(device)
    with torch.device("meta"):
        hfrm = HFRM.from_config(cfg)
    return _materialize(hfrm, weights, device, cfg.training.seed + 1)


def build_restorer(cfg: Config, unet_sd: Weights, hfrm_sd: Weights,
                   device=None, ema: bool = False):
    """The restoration runner for a validated config on ``device`` (the
    card when None).  ``ema`` picks the EMA shadow of a UNet checkpoint."""
    from wavedm_tpu_torch.inference.restoration import DiffusiveRestoration

    device = resolve_device(device)
    unet = build_unet(cfg, unet_sd, device, ema=ema)
    hfrm = build_hfrm(cfg, hfrm_sd, device)
    return DiffusiveRestoration(cfg, unet, hfrm, device=device)
