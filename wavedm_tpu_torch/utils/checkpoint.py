"""Train-state checkpoints as one ``torch.save`` file each.

A file holds the reference's keys where it has them (``state_dict``,
``optimizer``, ``ema_helper``, ``step``, ``epoch``, ``config``), so
``utils/convert.py:load_torch_checkpoint`` and ``build_unet`` read the model
or its EMA shadow from it, plus the generator's state and the
``training.pred_type`` the weights were trained with; :func:`load_checkpoint`
refuses a file whose ``pred_type`` differs from the config's.  A trainer
adds scalars of its own through ``extra`` (the stage-1 trainer: its
``best_psnr``; it keeps no EMA, so its ``ema_helper`` is empty), and
``build_hfrm`` loads a stage-1 file's ``state_dict`` as it is.  A
Laplacian-path run also stores its translator under ``lap``: its
``state_dict`` and its Adam's ``optimizer`` state; a stage-1 run with
``hfrm.use_gan`` stores its discriminator under ``disc``: its
``state_dict``, ``optimizer`` state and ``step``.  The JAX
package's Orbax checkpoints become such files through
``utils/orbax_convert.py``, which writes a seed (``training.seed``) in
place of the generator's state; :func:`load_checkpoint` seeds the
generator with it.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, Optional, Union

import torch

from wavedm_tpu_torch.config import Config
from wavedm_tpu_torch.training.state import TrainState

__all__ = ["SUFFIX", "save_checkpoint", "write_checkpoint", "load_checkpoint",
           "find_latest_checkpoint", "prune_checkpoints"]

SUFFIX = ".pth.tar"


_TENSORS = ("state_dict", "optimizer", "ema_helper", "generator", "lap",
            "disc")


def save_checkpoint(path: str, state: TrainState, cfg: Config,
                    epoch: int = 0, extra: Optional[Dict] = None,
                    lap_state=None, disc_state: Optional[TrainState] = None
                    ) -> str:
    """Write ``state``, the ``extra`` scalars, the Laplacian path's
    translator ``lap_state`` (a ``training.lap.LapState``) and stage 1's
    discriminator ``disc_state`` to ``path`` (``SUFFIX`` appended if
    missing) through a temporary file, so a cut write leaves no partial
    checkpoint."""
    extra = dict(extra or {})
    if lap_state is not None:
        extra["lap"] = {"state_dict": lap_state.model.state_dict(),
                        "optimizer": lap_state.optimizer.state_dict()}
    if disc_state is not None:
        extra["disc"] = {"state_dict": disc_state.model.state_dict(),
                         "optimizer": disc_state.optimizer.state_dict(),
                         "step": int(disc_state.step)}
    return write_checkpoint(
        path, cfg, state_dict=state.model.state_dict(),
        optimizer=state.optimizer.state_dict(), ema_helper=state.ema,
        step=state.step, generator=state.generator.get_state(), epoch=epoch,
        extra=extra)


def write_checkpoint(path: str, cfg: Config, *, state_dict: Dict,
                     optimizer: Dict, ema_helper: Dict, step: int,
                     generator: Union[torch.Tensor, int], epoch: int = 0,
                     extra: Optional[Dict] = None) -> str:
    """:func:`save_checkpoint` from the parts of a train state:
    ``generator`` is a generator's state, or an int seed for it."""
    if not path.endswith(SUFFIX):
        path += SUFFIX
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {
        "state_dict": state_dict,
        "optimizer": optimizer,
        "ema_helper": ema_helper,
        "step": int(step),
        "epoch": int(epoch),
        "generator": generator,
        "pred_type": cfg.training.pred_type,
        "config": dataclasses.asdict(cfg),
        **(extra or {}),
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, state: TrainState, cfg: Config,
                    lap_state=None, disc_state: Optional[TrainState] = None
                    ) -> Dict:
    """Restore ``state`` in place from ``path``, and ``lap_state`` and
    ``disc_state`` where the file holds a translator or a discriminator (a
    file without one leaves them as they are, as the JAX loader starts a
    missing one fresh); returns the
    file's metadata (``step``, ``epoch``, ``pred_type``, ``config`` and the
    ``extra`` scalars it was saved with)."""
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
    if lap_state is not None and "lap" in obj:
        lap_state.model.load_state_dict(obj["lap"]["state_dict"])
        lap_state.optimizer.load_state_dict(obj["lap"]["optimizer"])
    if disc_state is not None and "disc" in obj:
        disc_state.model.load_state_dict(obj["disc"]["state_dict"])
        disc_state.optimizer.load_state_dict(obj["disc"]["optimizer"])
        disc_state.step = int(obj["disc"]["step"])
    state.step = int(obj["step"])
    if isinstance(obj["generator"], int):      # a converted Orbax checkpoint
        state.generator.manual_seed(obj["generator"])
    else:
        state.generator.set_state(obj["generator"])
    return {k: v for k, v in obj.items() if k not in _TENSORS}


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
