"""Diffusion trainer: the epoch/step loop around the train step.

The port of ``wavedm_tpu/training/trainer.py``: the loop feeds batches,
logs every 10 steps, calls the in-train validation hook every
``training.validation_freq`` steps, and checkpoints every
``training.snapshot_freq`` steps (and after step 1).  It trains every
domain of ``training/train_step.py``: with ``data.global_attn`` the UNet is
``DiffusionUNetGlobal`` and batches are (crops, totals); with ``data.lap``
the high-frequency translator co-trains (``training/lap.py``), its LR set
once per epoch, and its parameters and Adam moments are checkpointed beside
the UNet's, as JAX checkpoints them (the original reference does not).

Under ``torchrun`` (``parallel/distributed.py``) the trainer builds the
data mesh from ``parallel.data_axis`` as JAX does, wraps the UNet in DDP
and steps each rank on the batches its own loader yields: the global batch
is the per-process batch times the number of processes, JAX's
multi-process rule and the reference's DistributedSampler's.  Rank 0 alone
validates, writes checkpoints and the metrics log.  ``parallel.fsdp`` is
not read, as JAX's trainer does not read it (FSDP is
``parallel/mesh.py:fsdp_shard``).  The Laplacian domain trains on one
process.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional

import numpy as np
import torch

from wavedm_tpu_torch.config import Config
from wavedm_tpu_torch.inference.loader import (Weights, build_hfrm,
                                               build_unet, resolve_device)
from wavedm_tpu_torch.parallel.distributed import is_coordinator
from wavedm_tpu_torch.parallel.mesh import make_mesh, replicate
from wavedm_tpu_torch.training.lap import create_lap_state, lap_lr_for_epoch
from wavedm_tpu_torch.training.state import TrainState, create_train_state
from wavedm_tpu_torch.training.train_step import make_train_step
from wavedm_tpu_torch.utils.checkpoint import (load_checkpoint,
                                               prune_checkpoints,
                                               save_checkpoint)
from wavedm_tpu_torch.utils.profiling import (MetricsLogger, StepTimer,
                                              annotate, trace)

__all__ = ["TrainLogEntry", "DiffusionTrainer"]

_END = object()        # an epoch's batches are done


@dataclass
class TrainLogEntry:
    """A logged step.  ``step_time``: the wall time since the previous
    loss read (or since ``fit`` began) over the steps taken in it, the
    pace ``train_crops_per_s`` counts; ``data_time``: the seconds spent
    waiting for batches (the ``train.data`` regions) in that stretch."""
    step: int
    loss: float
    loss_per_pixel: float
    mse_per_pixel: float
    data_time: float
    step_time: float


class DiffusionTrainer:
    """Owns the UNet, its train state and the step; the caller supplies
    host batches.

    Runs on the card unless ``device`` names another (raises with no card
    and no device named).  The UNet starts from random weights drawn from
    ``training.seed``.  ``hfrm_state_dict`` (a state_dict or a reference
    ``.pth`` path) is the frozen stage-1 restorer, required when the HF
    conditioning comes from it (``use_gt_in_train: false``)."""

    def __init__(self, cfg: Config, hfrm_state_dict: Weights = None,
                 device=None, log_fn: Callable[[str], None] = print):
        self.cfg = cfg
        self.log = log_fn
        self.device = resolve_device(device)
        self.mesh = make_mesh(cfg.parallel.data_axis, self.device)
        self.model = build_unet(cfg, None, self.device, train=True)
        n_params = sum(p.numel() for p in self.model.parameters())
        self.log(f"Total_params_model_real: {n_params / 1e6}M")
        # the step runs the DDP wrapper; the state keeps the module itself
        self.ddp = replicate(self.model, self.mesh)
        self.state = create_train_state(self.model, cfg.optim,
                                        cfg.training.seed)
        self.epoch = 0
        self.lap_state = None
        if cfg.data.lap:
            self.lap_state = create_lap_state(torch.Generator(
                device=self.device).manual_seed(cfg.training.seed + 2))
        self.hfrm = None
        if (cfg.data.wavelet_domain and cfg.model.use_other_channels
                and not cfg.model.use_gt_in_train):
            if hfrm_state_dict is None:
                raise ValueError(
                    "use_gt_in_train=False requires frozen HFRM weights "
                    "(cfg.hfrm.ckpt_path or hfrm_state_dict=)")
            self.hfrm = build_hfrm(cfg, hfrm_state_dict, self.device)
        self.train_step = make_train_step(cfg, self.ddp, self.hfrm,
                                          self.mesh)

    # ------------------------------------------------------------------ ckpt

    def save(self, path: str) -> str:
        """Write the train state to ``path``; returns the file written."""
        return save_checkpoint(path, self.state, self.cfg, epoch=self.epoch,
                               lap_state=self.lap_state)

    def resume(self, path: str) -> None:
        meta = load_checkpoint(path, self.state, self.cfg,
                               lap_state=self.lap_state)
        self.epoch = int(meta["epoch"])
        self.log(f"=> loaded checkpoint '{path}' "
                 f"(epoch {self.epoch}, step {self.state.step})")

    # ------------------------------------------------------------------ train

    def fit(self, batch_iter_fn: Callable[[int], Iterable[np.ndarray]],
            max_steps: Optional[int] = None,
            ckpt_dir: Optional[str] = None,
            metrics_path: Optional[str] = None,
            validate_fn: Optional[Callable[[TrainState, int], None]] = None,
            trace_dir: Optional[str] = None) -> List[TrainLogEntry]:
        """Run epochs until ``training.n_epochs``, ``training.n_iters``
        global steps, or ``max_steps``.

        A resumed run whose step already reaches that stop takes no step
        and returns an empty history.  (The JAX trainer takes one more
        step first and so overshoots ``n_iters`` by one; the port does
        not.)

        batch_iter_fn(epoch) -> iterable of (B, P, P, 6) float32 batches in
        [0, 1] ((crops, totals) pairs with ``data.global_attn``).
        metrics_path: optional JSONL file that receives each
        logged step's metrics (rank 0 writes it).  validate_fn(state,
        step): the in-train validation hook, called on rank 0 after each
        step that is a multiple of ``training.validation_freq``, before that
        step's snapshot.  trace_dir: ``utils/profiling.trace`` records
        there the warm stretch from the first loss read to the second: the
        ten steps after the first read (steps 11-20 of a fresh run) and
        the second read itself.  A run that stops before its second read
        records up to its last step; one that stops at its first, nothing.
        """
        cfg = self.cfg
        stop_at = (min(max_steps, cfg.training.n_iters)
                   if max_steps is not None else cfg.training.n_iters)
        if self.state.step >= stop_at:
            return []
        history: List[TrainLogEntry] = []
        timer = StepTimer()              # the logged step times
        mlog = MetricsLogger(metrics_path) if metrics_path else None
        last_read, last_step = time.perf_counter(), self.state.step
        data_s = 0.0
        with contextlib.ExitStack() as traced:
            for epoch in range(self.epoch, cfg.training.n_epochs):
                self.epoch = epoch
                batches = iter(batch_iter_fn(epoch))
                while True:
                    t0 = time.perf_counter()
                    with annotate("train.data"):
                        batch = next(batches, _END)
                    data_s += time.perf_counter() - t0
                    if batch is _END:
                        break
                    if self.lap_state is not None:
                        m = self.train_step(
                            self.state, self.lap_state, batch,
                            lap_lr_for_epoch(epoch, cfg.training.n_epochs))
                    else:
                        m = self.train_step(self.state, batch)
                    step = self.state.step
                    if step % 10 == 0:
                        with annotate("sync.log_read"):
                            loss = float(m.loss)
                        now = time.perf_counter()
                        timer.times.append((now - last_read)
                                           / (step - last_step))
                        entry = TrainLogEntry(
                            step=step, loss=loss,
                            loss_per_pixel=float(m.loss_per_pixel),
                            mse_per_pixel=float(m.mse_loss) /
                            (cfg.model.pred_channels
                             * cfg.data.image_size ** 2),
                            data_time=data_s, step_time=timer.times[-1])
                        last_read, last_step, data_s = now, step, 0.0
                        history.append(entry)
                        lap_note = (f", loss_trans: {float(m.loss_trans):.5f}"
                                    if self.lap_state is not None else "")
                        self.log(
                            f"step: {entry.step}, loss: {entry.loss:.2f}, "
                            f"loss/px: {entry.loss_per_pixel:.5f}, "
                            f"mse/px: {entry.mse_per_pixel:.5f}, "
                            f"step time: {entry.step_time:.3f}s "
                            f"(avg {timer.mean:.3f}s), "
                            f"data time: {entry.data_time:.3f}s" + lap_note)
                        if mlog is not None:
                            mlog.log(step, loss=entry.loss,
                                     loss_per_pixel=entry.loss_per_pixel,
                                     mse_per_pixel=entry.mse_per_pixel,
                                     grad_norm=float(m.grad_norm),
                                     step_time=entry.step_time,
                                     data_time=entry.data_time)
                        if len(history) == 1 and trace_dir and step < stop_at:
                            traced.enter_context(trace(trace_dir))
                        elif len(history) == 2:
                            traced.close()      # the traced stretch ends
                    if (validate_fn is not None and is_coordinator()
                            and step % cfg.training.validation_freq == 0):
                        validate_fn(self.state, step)
                    if ckpt_dir and (step % cfg.training.snapshot_freq == 0
                                     or step == 1):
                        self.save(os.path.join(
                            ckpt_dir,
                            f"{cfg.data.dataset}_epoch{epoch + 1}_ddpm"))
                        if cfg.training.keep_snapshots:
                            prune_checkpoints(ckpt_dir,
                                              cfg.training.keep_snapshots)
                    if step >= stop_at:
                        return history
        return history
