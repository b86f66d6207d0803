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

In a process group rank 0 alone writes and prunes (JAX's process-0
gating).  The file is always a world-one run's: the module's own names,
never DDP's ``module.`` prefix, and under FSDP every shard gathered whole,
which every rank joins.  So a checkpoint written at one world size loads
at any other; :func:`load_checkpoint` runs on every rank and shards what
it loads as the train state's tensors are sharded.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, Optional, Union

import torch

from wavedm_tpu_torch.config import Config
from wavedm_tpu_torch.parallel.distributed import is_coordinator
from wavedm_tpu_torch.parallel.mesh import full_state_dict, full_tensor
from wavedm_tpu_torch.training.state import TrainState

__all__ = ["SUFFIX", "save_checkpoint", "write_checkpoint", "load_checkpoint",
           "find_latest_checkpoint", "prune_checkpoints"]

SUFFIX = ".pth.tar"


_TENSORS = ("state_dict", "optimizer", "ema_helper", "generator", "lap",
            "disc")


def _full_optimizer_state(optimizer: torch.optim.Optimizer) -> Dict:
    """``optimizer.state_dict()`` with every FSDP shard gathered whole."""
    sd = optimizer.state_dict()
    sd["state"] = {i: {k: full_tensor(v) for k, v in s.items()}
                   for i, s in sd["state"].items()}
    return sd


def _shard_like(like: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """``value`` (a whole tensor from a file) placed as ``like`` is: an
    FSDP shard of it when ``like`` is a DTensor."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(like, DTensor):
        return distribute_tensor(value.to(like.device, like.dtype),
                                 like.device_mesh, like.placements)
    return value


def _shard_state_dict(module: torch.nn.Module, sd: Dict) -> Dict:
    current = module.state_dict()
    return {k: _shard_like(current[k], v) if k in current else v
            for k, v in sd.items()}


def _shard_optimizer_state(optimizer: torch.optim.Optimizer,
                           sd: Dict) -> Dict:
    params = [p for g in optimizer.param_groups for p in g["params"]]
    sd = dict(sd)
    sd["state"] = {i: {k: v if k == "step" else _shard_like(params[i], v)
                       for k, v in s.items()}
                   for i, s in sd["state"].items()}
    return sd


def save_checkpoint(path: str, state: TrainState, cfg: Config,
                    epoch: int = 0, extra: Optional[Dict] = None,
                    lap_state=None, disc_state: Optional[TrainState] = None
                    ) -> str:
    """Write ``state``, the ``extra`` scalars, the Laplacian path's
    translator ``lap_state`` (a ``training.lap.LapState``) and stage 1's
    discriminator ``disc_state`` to ``path`` (``SUFFIX`` appended if
    missing) through a temporary file, so a cut write leaves no partial
    checkpoint.  Every rank of a process group calls it; rank 0 writes."""
    extra = dict(extra or {})
    if lap_state is not None:
        extra["lap"] = {"state_dict": lap_state.model.state_dict(),
                        "optimizer": lap_state.optimizer.state_dict()}
    if disc_state is not None:
        extra["disc"] = {"state_dict": full_state_dict(disc_state.model),
                         "optimizer": _full_optimizer_state(
                             disc_state.optimizer),
                         "step": int(disc_state.step)}
    return write_checkpoint(
        path, cfg, state_dict=full_state_dict(state.model),
        optimizer=_full_optimizer_state(state.optimizer),
        ema_helper={k: full_tensor(v) for k, v in state.ema.items()},
        step=state.step, generator=state.generator.get_state(), epoch=epoch,
        extra=extra)


def write_checkpoint(path: str, cfg: Config, *, state_dict: Dict,
                     optimizer: Dict, ema_helper: Dict, step: int,
                     generator: Union[torch.Tensor, int], epoch: int = 0,
                     extra: Optional[Dict] = None) -> str:
    """:func:`save_checkpoint` from the parts of a train state:
    ``generator`` is a generator's state, or an int seed for it.  Returns
    the path; only rank 0 of a process group writes it."""
    if not path.endswith(SUFFIX):
        path += SUFFIX
    if not is_coordinator():
        return path
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
    state.model.load_state_dict(_shard_state_dict(state.model,
                                                  obj["state_dict"]))
    state.optimizer.load_state_dict(_shard_optimizer_state(
        state.optimizer, obj["optimizer"]))
    with torch.no_grad():
        for name, value in obj["ema_helper"].items():
            state.ema[name].copy_(_shard_like(state.ema[name], value))
    if lap_state is not None and "lap" in obj:
        lap_state.model.load_state_dict(obj["lap"]["state_dict"])
        lap_state.optimizer.load_state_dict(obj["lap"]["optimizer"])
    if disc_state is not None and "disc" in obj:
        disc_state.model.load_state_dict(_shard_state_dict(
            disc_state.model, obj["disc"]["state_dict"]))
        disc_state.optimizer.load_state_dict(_shard_optimizer_state(
            disc_state.optimizer, obj["disc"]["optimizer"]))
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
    no-op for keep <= 0 and on ranks other than 0.  Returns the number
    removed."""
    if keep <= 0 or not is_coordinator() or not os.path.isdir(ckpt_dir):
        return 0
    snaps = _snapshots(ckpt_dir)
    old = snaps[:-keep] if keep < len(snaps) else []
    for path in old:
        os.remove(path)
    return len(old)
