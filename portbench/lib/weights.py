"""Weights and random draws made from the run's seed.

:func:`make_weights` draws every parameter of a reference module in one
``torch.rand`` call on the target device, with a ``torch.Generator``
there, and maps each parameter's slice to its range:

- a conv or linear weight (2-D or more) and its bias: U(-b, b) with
  b = 1 / sqrt(fan_in), PyTorch's default;
- a norm's scale (a 1-D ``weight``): 1 + U(-0.1, 0.1); its shift: U(-0.1,
  0.1);
- any other parameter (the HFRM blocks' residual scales ``beta`` and
  ``gamma``): U(-0.5, 0.5), so every block adds to its output.

The result is a float32 ``state_dict`` with the reference's (and the
port's) names.  The same seed and tag give the same weights on any device
of one kind.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from portbench.reference.hfrm import HFRM
from portbench.reference.unet import UNet

__all__ = ["sub_seed", "generator", "make_weights", "seeded", "reference"]


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's seed."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    words += [ord(c) for c in tag]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def _ranges(module: nn.Module):
    """(name, numel, scale, offset) of each parameter: value = offset +
    scale * (2 u - 1) for u ~ U(0, 1)."""
    params = dict(module.named_parameters())
    for name, p in params.items():
        owner, _, leaf = name.rpartition(".")
        w = params.get(f"{owner}.weight" if owner else "weight")
        if w is not None and w.dim() >= 2 and leaf in ("weight", "bias"):
            yield name, p.numel(), 1.0 / math.sqrt(w[0].numel()), 0.0
        elif w is not None and leaf == "weight":
            yield name, p.numel(), 0.1, 1.0
        elif w is not None and leaf == "bias":
            yield name, p.numel(), 0.1, 0.0
        else:
            yield name, p.numel(), 0.5, 0.0


def make_weights(module: nn.Module, seed: int, tag: str,
                 device) -> Dict[str, torch.Tensor]:
    """A float32 state_dict for ``module`` (whose own values are ignored),
    drawn on ``device``."""
    rows = list(_ranges(module))
    counts = torch.tensor([r[1] for r in rows], device=device)
    scale = torch.tensor([r[2] for r in rows], device=device)
    offset = torch.tensor([r[3] for r in rows], device=device)
    u = torch.rand(int(counts.sum()), generator=generator(seed, tag, device),
                   device=device)
    flat = (torch.repeat_interleave(offset, counts)
            + torch.repeat_interleave(scale, counts) * (2.0 * u - 1.0))
    del u
    shapes = dict((n, p.shape) for n, p in module.named_parameters())
    return {name: piece.view(shapes[name]) for (name, *_), piece in
            zip(rows, torch.split(flat, [r[1] for r in rows]))}


def _meta(raw: dict, with_hfrm: bool):
    with torch.device("meta"):
        return (UNet.from_config(raw),
                HFRM.from_config(raw) if with_hfrm else None)


def seeded(raw: dict, seed: int, device, with_hfrm: bool):
    """(UNet state_dict, HFRM state_dict or None) for the configuration
    ``raw`` and the run's seed."""
    unet, hfrm = _meta(raw, with_hfrm)
    return (make_weights(unet, seed, "unet", device),
            None if hfrm is None else make_weights(hfrm, seed, "hfrm",
                                                   device))


def reference(raw: dict, seed: int, device, with_hfrm: bool):
    """The reference (UNet, HFRM or None) on ``device`` with the seeded
    weights; the UNet's parameters take gradients, the HFRM's do not."""
    unet, hfrm = _meta(raw, with_hfrm)
    sd_u, sd_h = seeded(raw, seed, device, with_hfrm)
    unet = unet.to_empty(device=device)
    unet.load_state_dict(sd_u)
    if hfrm is not None:
        hfrm = hfrm.to_empty(device=device).requires_grad_(False)
        hfrm.load_state_dict(sd_h)
    return unet, hfrm
