"""The numbers that decide ``correct``, and the judgement against limits.

Restored images (the program's against the reference's, in [0, 1]):

- ``img_rms_gap``: the root mean square of their difference over every
  pixel and channel of the sampled images;
- ``img_max_gap``: the largest absolute difference of one value.

Training (three steps from the same weights, crops, t and noise):

- ``loss_gap``: the largest |loss_p - loss_r| / |loss_r| over the steps;
- ``grad_gap``: over the parameters (leaves), the largest
  |g_p - g_r| / max(g_r, median g_r), g the norm of a leaf's first
  gradient;
- ``change_gap``: the same over the norms of each leaf's change after the
  steps, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (moved by round-off alone, as the
  attention keys' bias under the softmax);
- ``ema_gap``: the same over the norms of each leaf's EMA change after the
  steps (the shadow less the starting weights), over the leaves that
  ``change_gap`` keeps, leaving out as well those whose reference EMA
  change is under ``EMA_SPACINGS`` float32 spacings of the leaf itself
  (2**-23 of its norm): a float32 shadow rounds each update by about one
  spacing, so such a leaf's EMA moves by rounding more than by its change
  (a norm's scale near 1 does not move at all over three steps at
  mu = 0.9999).

A number is within its limit when it is finite and not above it.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import torch

__all__ = ["image_gaps", "train_gaps", "judge"]

SILENT_GRAD = 1e-3
EMA_SPACINGS = 4.0
FLOAT32_SPACING = 2.0 ** -23


def image_gaps(prog: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    d = (prog.double() - ref.double())
    return dict(img_rms_gap=float(d.square().mean().sqrt()),
                img_max_gap=float(d.abs().max()))


def _worst(p: Dict[str, float], r: Dict[str, float],
           keep) -> Tuple[float, str]:
    floor = statistics.median(r[k] for k in keep)
    return max((abs(p[k] - r[k]) / max(r[k], floor), k) for k in keep)


def train_gaps(prog: Dict, ref: Dict) -> Tuple[Dict[str, float],
                                               Dict[str, str]]:
    """``prog`` and ``ref``: {"loss": [..], "grad": {leaf: norm},
    "change": {leaf: norm}} and, where both kept an EMA, "ema": {leaf:
    norm}; ``ref`` also "norm": {leaf: norm at the start}.  Returns the
    numbers and, for those taken over leaves, the leaf that gives each."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                   ref["loss"]))
    g = ref["grad"]
    floor = statistics.median(g.values()) * SILENT_GRAD
    moving = [k for k in g if g[k] >= floor]
    grad, grad_at = _worst(prog["grad"], g, list(g))
    change, change_at = _worst(prog["change"], ref["change"], moving)
    numbers = dict(loss_gap=loss, grad_gap=grad, change_gap=change)
    where = dict(grad_gap=grad_at, change_gap=change_at)
    if "ema" in prog and "ema" in ref:
        e = ref["ema"]
        held = [k for k in moving
                if e[k] >= EMA_SPACINGS * FLOAT32_SPACING * ref["norm"][k]]
        numbers["ema_gap"], where["ema_gap"] = (
            _worst(prog["ema"], e, held) if held
            else (math.nan, "no leaf moves by EMA_SPACINGS"))
    return numbers, where


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, List[Tuple[str, float, float]]]:
    rows = [(k, numbers.get(k, math.nan), limits[k]) for k in limits]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
