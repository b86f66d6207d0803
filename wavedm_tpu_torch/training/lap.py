"""Laplacian-path training state: the learned high-frequency translator.

The port of ``wavedm_tpu/training/lap.py``.  With ``data.lap`` the
diffusion UNet trains on the coarsest level of a 2-level Gauss pyramid
while :class:`~wavedm_tpu_torch.models.laplacian.LapHighTrans` co-trains
on the sum of the per-level MSEs between its translated cond high bands
and the ground truth's, with its own Adam(2e-4, betas (0.9, 0.999), eps
1e-8, weight decay 1e-8) and a cosine LR set once per epoch.  The decay is
torch's coupled L2 (added to the gradient ahead of Adam's scaling), the
placement of the JAX package's optax ``add_decayed_weights`` ->
``scale_by_adam`` chain.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from wavedm_tpu_torch.models.laplacian import LapHighTrans
from wavedm_tpu_torch.utils.initializers import apply_weights_init

__all__ = ["LAP_NUM_HIGH", "LAP_RES_NUM", "LAP_RES_DIM", "LAP_LR", "LAP_WD",
           "LapState", "make_lap_model", "make_lap_optimizer",
           "lap_lr_for_epoch", "create_lap_state"]

# the reference's hyperparameters, hard-coded there too
LAP_NUM_HIGH = 2
LAP_RES_NUM = 3
LAP_RES_DIM = 32
LAP_LR = 2e-4
LAP_WD = 1e-8


@dataclass
class LapState:
    """The translator and its optimizer, both updated in place."""
    model: LapHighTrans
    optimizer: torch.optim.Optimizer


def make_lap_model() -> LapHighTrans:
    return LapHighTrans(res_num=LAP_RES_NUM, res_dim=LAP_RES_DIM,
                        num_high=LAP_NUM_HIGH)


def make_lap_optimizer(params) -> torch.optim.Optimizer:
    """Adam with coupled L2 decay; the caller sets the per-epoch LR."""
    return torch.optim.Adam(params, lr=LAP_LR, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=LAP_WD)


def lap_lr_for_epoch(epoch: int, n_epochs: int) -> float:
    """torch ``CosineAnnealingLR(T_max=n_epochs, eta_min=0)`` stepped once
    per epoch: ``2e-4 * (1 + cos(pi * epoch / n_epochs)) / 2``."""
    return LAP_LR * 0.5 * (1.0 + math.cos(math.pi * epoch / max(n_epochs, 1)))


def create_lap_state(generator: torch.Generator) -> LapState:
    """The translator on the generator's device, its convs kaiming-drawn
    from ``generator`` and biases zeroed, and its optimizer."""
    model = make_lap_model().to(generator.device)
    apply_weights_init(model, "kaiming", generator)
    return LapState(model=model,
                    optimizer=make_lap_optimizer(list(model.parameters())))
