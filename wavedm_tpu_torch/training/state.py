"""Train state and the optimizer factory.

``make_optimizer`` gives the reference's optimizers (its
``utils/optimize.py``): Adam(beta1, beta2, eps, weight_decay, amsgrad),
RMSprop(alpha 0.99, eps 1e-8, weight_decay) and SGD(momentum 0.9, no weight
decay), with torch's coupled L2 weight decay.  The JAX package rebuilds the
same semantics in optax (``wavedm_tpu/training/state.py``); its RMSProp puts
eps inside the square root (optax's default), which differs from torch's
for gradients below ~1e-4.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable

import torch
import torch.nn as nn

from wavedm_tpu_torch.config import OptimConfig
from wavedm_tpu_torch.diffusion.ema import ema_init

__all__ = ["TrainState", "make_optimizer", "create_train_state"]


@dataclass
class TrainState:
    """What a train step updates in place: the model's parameters, the
    optimizer's moments, the EMA shadow, the step count and the generator
    that draws t and the noise."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema: Dict[str, torch.Tensor]
    step: int
    generator: torch.Generator


def make_optimizer(optim: OptimConfig,
                   params: Iterable[torch.Tensor]) -> torch.optim.Optimizer:
    if optim.optimizer == "Adam":
        return torch.optim.Adam(params, lr=optim.lr,
                                betas=(optim.beta1, optim.beta2),
                                eps=optim.eps,
                                weight_decay=optim.weight_decay,
                                amsgrad=optim.amsgrad)
    if optim.optimizer == "RMSProp":
        return torch.optim.RMSprop(params, lr=optim.lr, alpha=0.99, eps=1e-8,
                                   weight_decay=optim.weight_decay)
    if optim.optimizer == "SGD":
        return torch.optim.SGD(params, lr=optim.lr, momentum=0.9)
    raise ValueError(f"unknown optimizer {optim.optimizer!r}")


def create_train_state(model: nn.Module, optim: OptimConfig,
                       seed: int) -> TrainState:
    """Optimizer over the model's trainable parameters, EMA shadow as a
    copy of them, step 0, and a generator on the model's device seeded with
    ``seed``."""
    device = next(model.parameters()).device
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    return TrainState(
        model=model,
        optimizer=make_optimizer(optim, [p for _, p in named]),
        ema=ema_init(named),
        step=0,
        generator=torch.Generator(device=device).manual_seed(seed))
