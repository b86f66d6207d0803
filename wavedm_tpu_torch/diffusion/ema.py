"""Exponential moving average of parameters (the reference's EMAHelper).

The shadow is a dict of tensors keyed like ``named_parameters``.  The
update runs in place under ``no_grad``, as one multi-tensor op per term,
and rounds where the JAX expression ``mu * s + (1 - mu) * p`` does.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

__all__ = ["REFERENCE_MU", "ema_init", "ema_update"]

# The reference hardcodes mu = 0.9999 whatever its config says.
REFERENCE_MU = 0.9999

Named = Iterable[Tuple[str, torch.Tensor]]


@torch.no_grad()
def ema_init(named_params: Named) -> Dict[str, torch.Tensor]:
    """A real copy of the parameters (never an alias of them)."""
    return {name: p.detach().clone() for name, p in named_params}


@torch.no_grad()
def ema_update(shadow: Dict[str, torch.Tensor], named_params: Named,
               mu: float = REFERENCE_MU) -> None:
    """shadow <- mu * shadow + (1 - mu) * params, in place."""
    names, params = zip(*named_params)
    shadows = [shadow[name] for name in names]
    torch._foreach_mul_(shadows, mu)
    torch._foreach_add_(shadows, torch._foreach_mul(
        [p.detach() for p in params], 1.0 - mu))
