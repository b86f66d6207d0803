"""Diffusion trainer: the epoch/step loop around the train step.

The port of ``wavedm_tpu/training/trainer.py`` for the wavelet domain: the
loop feeds batches, logs every 10 steps, and checkpoints every
``training.snapshot_freq`` steps (and after step 1).  In-train validation
(``validate_fn``) is not ported yet.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional

import numpy as np

from wavedm_tpu_torch.config import Config
from wavedm_tpu_torch.inference.loader import (Weights, build_hfrm,
                                               build_unet, resolve_device)
from wavedm_tpu_torch.training.state import create_train_state
from wavedm_tpu_torch.training.train_step import check_domain, make_train_step
from wavedm_tpu_torch.utils.checkpoint import (load_checkpoint,
                                               prune_checkpoints,
                                               save_checkpoint)
from wavedm_tpu_torch.utils.profiling import MetricsLogger, StepTimer

__all__ = ["TrainLogEntry", "DiffusionTrainer"]


@dataclass
class TrainLogEntry:
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
        check_domain(cfg)
        self.cfg = cfg
        self.log = log_fn
        self.device = resolve_device(device)
        self.model = build_unet(cfg, None, self.device, train=True)
        n_params = sum(p.numel() for p in self.model.parameters())
        self.log(f"Total_params_model_real: {n_params / 1e6}M")
        self.state = create_train_state(self.model, cfg.optim,
                                        cfg.training.seed)
        self.epoch = 0
        self.hfrm = None
        if cfg.model.use_other_channels and not cfg.model.use_gt_in_train:
            if hfrm_state_dict is None:
                raise ValueError(
                    "use_gt_in_train=False requires frozen HFRM weights "
                    "(cfg.hfrm.ckpt_path or hfrm_state_dict=)")
            self.hfrm = build_hfrm(cfg, hfrm_state_dict, self.device)
        self.train_step = make_train_step(cfg, self.model, self.hfrm)

    # ------------------------------------------------------------------ ckpt

    def save(self, path: str) -> str:
        """Write the train state to ``path``; returns the file written."""
        return save_checkpoint(path, self.state, self.cfg, epoch=self.epoch)

    def resume(self, path: str) -> None:
        meta = load_checkpoint(path, self.state, self.cfg)
        self.epoch = int(meta["epoch"])
        self.log(f"=> loaded checkpoint '{path}' "
                 f"(epoch {self.epoch}, step {self.state.step})")

    # ------------------------------------------------------------------ train

    def fit(self, batch_iter_fn: Callable[[int], Iterable[np.ndarray]],
            max_steps: Optional[int] = None,
            ckpt_dir: Optional[str] = None,
            metrics_path: Optional[str] = None) -> List[TrainLogEntry]:
        """Run epochs until ``training.n_epochs``, ``training.n_iters``
        global steps, or ``max_steps``.

        batch_iter_fn(epoch) -> iterable of (B, P, P, 6) float32 batches in
        [0, 1].  metrics_path: optional JSONL file that receives each
        logged step's metrics."""
        cfg = self.cfg
        history: List[TrainLogEntry] = []
        stop_at = (min(max_steps, cfg.training.n_iters)
                   if max_steps is not None else cfg.training.n_iters)
        if self.state.step >= stop_at:
            return history
        timer = StepTimer()
        mlog = MetricsLogger(metrics_path) if metrics_path else None
        for epoch in range(self.epoch, cfg.training.n_epochs):
            self.epoch = epoch
            data_start = time.time()
            for batch in batch_iter_fn(epoch):
                data_time = time.time() - data_start
                timer.start()
                m = self.train_step(self.state, batch)
                step = self.state.step
                if step % 10 == 0:
                    timer.stop(sync_on=m.loss)
                    entry = TrainLogEntry(
                        step=step, loss=float(m.loss),
                        loss_per_pixel=float(m.loss_per_pixel),
                        mse_per_pixel=float(m.mse_loss) /
                        (cfg.model.pred_channels * cfg.data.image_size ** 2),
                        data_time=data_time, step_time=timer.times[-1])
                    history.append(entry)
                    self.log(
                        f"step: {entry.step}, loss: {entry.loss:.2f}, "
                        f"loss/px: {entry.loss_per_pixel:.5f}, "
                        f"mse/px: {entry.mse_per_pixel:.5f}, "
                        f"step time: {entry.step_time:.3f}s "
                        f"(avg {timer.mean:.3f}s), "
                        f"data time: {entry.data_time:.3f}s")
                    if mlog is not None:
                        mlog.log(step, loss=entry.loss,
                                 loss_per_pixel=entry.loss_per_pixel,
                                 mse_per_pixel=entry.mse_per_pixel,
                                 grad_norm=float(m.grad_norm),
                                 step_time=entry.step_time,
                                 data_time=entry.data_time)
                if ckpt_dir and (step % cfg.training.snapshot_freq == 0
                                 or step == 1):
                    self.save(os.path.join(
                        ckpt_dir, f"{cfg.data.dataset}_epoch{epoch + 1}_ddpm"))
                    if cfg.training.keep_snapshots:
                        prune_checkpoints(ckpt_dir,
                                          cfg.training.keep_snapshots)
                if step >= stop_at:
                    return history
                data_start = time.time()
        return history
