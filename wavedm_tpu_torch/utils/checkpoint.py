"""Train-state checkpoints as one ``torch.save`` file each.

A file holds the reference's keys where it has them (``state_dict``,
``optimizer``, ``ema_helper``, ``step``, ``epoch``, ``config``), so
``utils/convert.py:load_torch_checkpoint`` and ``build_unet`` read the model
or its EMA shadow from it, plus the generator's state and the
``training.pred_type`` the weights were trained with; :func:`load_checkpoint`
refuses a file whose ``pred_type`` differs from the config's.  Orbax
checkpoints of the JAX package are not read here (ROADMAP item 9).
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, Optional

import torch

from wavedm_tpu_torch.config import Config
from wavedm_tpu_torch.training.state import TrainState

__all__ = ["SUFFIX", "save_checkpoint", "load_checkpoint",
           "find_latest_checkpoint", "prune_checkpoints"]

SUFFIX = ".pth.tar"


def save_checkpoint(path: str, state: TrainState, cfg: Config,
                    epoch: int = 0) -> str:
    """Write ``state`` to ``path`` (``SUFFIX`` appended if missing) through
    a temporary file, so a cut write leaves no partial checkpoint."""
    if not path.endswith(SUFFIX):
        path += SUFFIX
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {
        "state_dict": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "ema_helper": state.ema,
        "step": int(state.step),
        "epoch": int(epoch),
        "generator": state.generator.get_state(),
        "pred_type": cfg.training.pred_type,
        "config": dataclasses.asdict(cfg),
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, state: TrainState, cfg: Config) -> Dict:
    """Restore ``state`` in place from ``path``; returns the file's
    metadata (``step``, ``epoch``, ``pred_type``, ``config``)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    saved = obj.get("pred_type")
    if saved != cfg.training.pred_type:
        raise ValueError(
            f"checkpoint {path} was trained with pred_type={saved!r}, the "
            f"config says {cfg.training.pred_type!r}")
    state.model.load_state_dict(obj["state_dict"])
    state.optimizer.load_state_dict(obj["optimizer"])
    with torch.no_grad():
        for name, value in obj["ema_helper"].items():
            state.ema[name].copy_(value)
    state.step = int(obj["step"])
    state.generator.set_state(obj["generator"])
    return {k: obj[k] for k in ("step", "epoch", "pred_type", "config")}


def _snapshots(ckpt_dir: str):
    return sorted(glob.glob(os.path.join(ckpt_dir, "*" + SUFFIX)),
                  key=os.path.getmtime)


def find_latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The most recently written checkpoint under ``ckpt_dir`` (for
    ``--resume auto``); None if there is none."""
    snaps = _snapshots(ckpt_dir) if os.path.isdir(ckpt_dir) else []
    return snaps[-1] if snaps else None


def prune_checkpoints(ckpt_dir: str, keep: int) -> int:
    """Delete all but the ``keep`` newest checkpoints under ``ckpt_dir``;
    no-op for keep <= 0.  Returns the number removed."""
    if keep <= 0 or not os.path.isdir(ckpt_dir):
        return 0
    snaps = _snapshots(ckpt_dir)
    old = snaps[:-keep] if keep < len(snaps) else []
    for path in old:
        os.remove(path)
    return len(old)
