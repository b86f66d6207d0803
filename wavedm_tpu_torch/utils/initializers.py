"""Weight initialisation of the reference's ``weights_init`` factory.

The port of ``wavedm_tpu/utils/initializers.py``, for the one flavour the
port uses: ``kaiming`` (``kaiming_normal_(a=0, mode="fan_in")``, std
sqrt(2 / fan_in)) on the weights of convs and linears, their biases zeroed,
every other parameter left as it is (the translator of
``training/lap.py``).  It draws from an explicit ``torch.Generator``, so its
values differ from the JAX package's draws from a PRNG key; tests carry
weights across instead (``utils/convert.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

__all__ = ["apply_weights_init"]


@torch.no_grad()
def apply_weights_init(module: nn.Module, init_type: str,
                       generator: torch.Generator) -> nn.Module:
    """Re-initialise ``module``'s convs and linears in place, as
    ``module.apply(weights_init(init_type))`` does in the reference."""
    if init_type != "kaiming":
        raise NotImplementedError(
            f"weights_init {init_type!r}: only 'kaiming' is ported")
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            std = math.sqrt(2.0 / m.weight[0].numel())
            draw = torch.empty(m.weight.shape, dtype=torch.float32,
                               device=m.weight.device)
            m.weight.copy_(draw.normal_(0.0, std, generator=generator))
            if m.bias is not None:
                m.bias.zero_()
    return module
