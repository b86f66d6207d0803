"""Stage-1 HFRM trainer.

The port of ``wavedm_tpu/training/hfrm_trainer.py``: HFRM from the config
with float32 parameters run in ``parallel.compute_dtype``, started from
the identity-centre init; Adam(betas (0.5, 0.999), eps 1e-8) at
lr * 0.5**(step / 1e5), the first update at the base rate; the loss
2 * mean|fake * 255 - gt * 255| (+ ``tv_loss`` when ``hfrm.tv_weight`` >
0); per-image PSNR on clipped outputs; a ``best`` checkpoint when an
epoch's mean PSNR beats the running best (from ``hfrm.best_psnr_init``)
and ``lastest`` (the reference's spelling) every 5th epoch, at the last
epoch and at ``max_steps``.

Two opt-in terms, dead in the reference, run as JAX runs them:

- ``hfrm.use_perceptual``: + :func:`perceptual_loss` of frozen VGG19
  features of ``fake * 255`` and ``gt * 255`` (torchvision weights from
  ``hfrm.vgg_ckpt``, else random ones drawn from seed 0);
- ``hfrm.use_gan``: + ``lambda_gan * mean((D(cond, fake) - 1)**2)`` (LSGAN)
  with the PatchGAN ``Discriminator`` (random weights from
  ``training.seed + 1``), which then takes its own step on the detached
  ``fake``: Adam(``hfrm.lr``, betas (0.5, 0.999)) on
  0.5 * (mean((D(cond, gt) - 1)**2) + mean(D(cond, fake)**2)).  Its
  weights, moments and step are saved beside the generator's and restored
  on resume.

Under ``torchrun`` (``parallel/distributed.py``) HFRM, and with ``use_gan``
the discriminator, run as DDP over the data mesh of
``parallel.data_axis``; each rank steps on its own batches (the global
batch is ``hfrm.batch_size`` times the number of processes), the logged
loss and PSNR are means over the ranks, and rank 0 alone writes
checkpoints and the metrics log.
"""

from __future__ import annotations

import os
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

from wavedm_tpu_torch.config import Config
from wavedm_tpu_torch.inference.loader import init_random_, resolve_device
from wavedm_tpu_torch.models.hfrm import HFRM, identity_center_init_
from wavedm_tpu_torch.models.vgg_loss import (VGG19Features, perceptual_loss,
                                              vgg19_features_state_dict)
from wavedm_tpu_torch.models.wdnet import Discriminator
from wavedm_tpu_torch.parallel.mesh import all_mean, make_mesh, replicate
from wavedm_tpu_torch.training.state import TrainState
from wavedm_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from wavedm_tpu_torch.utils.profiling import MetricsLogger, StepTimer

__all__ = ["tv_loss", "hfrm_lr", "image_psnr", "make_hfrm_optimizer",
           "HFRMTrainer"]


def tv_loss(x: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """Total-variation regulariser of (B, C, H, W) ``x`` (the reference's
    TVLoss)."""
    b, c, h, w = x.shape
    h_tv = torch.sum(torch.square(x[:, :, 1:] - x[:, :, :-1]))
    w_tv = torch.sum(torch.square(x[:, :, :, 1:] - x[:, :, :, :-1]))
    count_h = (h - 1) * w * c
    count_w = h * (w - 1) * c
    return weight * 2.0 * (h_tv / count_h + w_tv / count_w) / b


def hfrm_lr(base_lr: float, step: int) -> float:
    """The learning rate of update ``step`` (0 for the first):
    base_lr * 0.5**(step / 1e5)."""
    return base_lr * 0.5 ** (step / 100000.0)


def make_hfrm_optimizer(cfg: Config, params) -> torch.optim.Adam:
    """Adam(betas (0.5, 0.999), eps 1e-8) at ``hfrm.lr`` (each generator
    update sets its own rate, :func:`hfrm_lr`; the discriminator's stays
    at ``hfrm.lr``)."""
    return torch.optim.Adam(params, lr=cfg.hfrm.lr, betas=(0.5, 0.999),
                            eps=1e-8)


def _random_module(module: torch.nn.Module, device: torch.device,
                   seed: int) -> torch.nn.Module:
    with torch.device("meta"):
        module = module()
    module = module.to_empty(device=device)
    return init_random_(module, torch.Generator(device=device)
                        .manual_seed(seed))


def image_psnr(fake: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """(B,) PSNR of each image on [0, 1], both clipped first."""
    diff = fake.clamp(0, 1) - gt.clamp(0, 1)
    rmse = torch.sqrt(torch.mean(diff * diff, dim=(1, 2, 3)))
    return 20.0 * torch.log10(1.0 / rmse)


class HFRMTrainer:
    """Owns HFRM, its Adam state and the step; the caller supplies
    (B, H, W, 6) [cond | gt] batches in [0, 1].  Runs on the card unless
    ``device`` names another."""

    def __init__(self, cfg: Config, device=None,
                 log_fn: Callable[[str], None] = print):
        self.cfg = cfg
        self.log = log_fn
        self.device = resolve_device(device)
        self.mesh = make_mesh(cfg.parallel.data_axis, self.device)
        with torch.device("meta"):
            model = HFRM.from_config(cfg, keep_f32_params=True)
        self.model = identity_center_init_(
            model.to_empty(device=self.device)).train()
        self.ddp = replicate(self.model, self.mesh)
        n_params = sum(p.numel() for p in self.model.parameters())
        self.log(f"Total_params_model: {n_params / 1e6}M")
        self.state = TrainState(
            model=self.model,
            optimizer=make_hfrm_optimizer(cfg, self.model.parameters()),
            ema={}, step=0,
            generator=torch.Generator(device=self.device).manual_seed(
                cfg.training.seed))
        self.best_psnr = cfg.hfrm.best_psnr_init
        self.epoch = 0

        h = cfg.hfrm
        self.vgg = None
        if h.use_perceptual:
            if h.vgg_ckpt:
                with torch.device("meta"):
                    vgg = VGG19Features()
                vgg = vgg.to_empty(device=self.device)
                vgg.load_state_dict(vgg19_features_state_dict(torch.load(
                    h.vgg_ckpt, map_location="cpu", weights_only=True)))
            else:
                self.log("hfrm.use_perceptual without vgg_ckpt: random VGG "
                         "features")
                vgg = _random_module(VGG19Features, self.device, 0)
            self.vgg = vgg.eval().requires_grad_(False)
        # the discriminator's TrainState (its generator unused), and the
        # loss of its last step
        self.disc_state = self.d_loss = self.disc_ddp = None
        if h.use_gan:
            disc = _random_module(Discriminator, self.device,
                                  cfg.training.seed + 1).train()
            self.disc_state = TrainState(
                model=disc,
                optimizer=make_hfrm_optimizer(cfg, disc.parameters()),
                ema={}, step=0, generator=torch.Generator(
                    device=self.device).manual_seed(cfg.training.seed + 1))
            self.disc_ddp = replicate(disc, self.mesh)

    def train_step(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """One update on ``batch`` (array or tensor), and one of the
        discriminator with ``use_gan`` (its loss in ``d_loss``); returns
        the generator's loss and the batch-mean PSNR as device scalars, each
        a mean over the ranks of a data mesh."""
        h = self.cfg.hfrm
        x = torch.as_tensor(batch, dtype=torch.float32, device=self.device)
        x = x.permute(0, 3, 1, 2)
        cond, gt = x[:, :3].contiguous(), x[:, 3:].contiguous()
        opt = self.state.optimizer
        for group in opt.param_groups:
            group["lr"] = hfrm_lr(h.lr, self.state.step)
        opt.zero_grad(set_to_none=True)
        fake = self.ddp(cond)
        loss = 2.0 * torch.mean(torch.abs(fake * 255.0 - gt * 255.0))
        if self.vgg is not None:
            with torch.no_grad():
                real_feats = self.vgg(gt * 255.0)
            loss = loss + perceptual_loss(self.vgg(fake * 255.0), real_feats)
        if h.tv_weight > 0.0:
            loss = loss + tv_loss(fake, h.tv_weight)
        # the generator's term runs the discriminator itself, not its DDP
        # wrapper: no gradient of its own flows there
        disc = self.disc_state.model if self.disc_state else None
        if disc is not None:
            disc.requires_grad_(False)
            loss = loss + h.lambda_gan * torch.mean(
                torch.square(disc(cond, fake) - 1.0))
            disc.requires_grad_(True)
        loss.backward()
        opt.step()
        self.state.step += 1
        fake = fake.detach()
        if disc is not None:
            d_opt = self.disc_state.optimizer
            d_opt.zero_grad(set_to_none=True)
            d = self.disc_ddp
            d_loss = 0.5 * (torch.mean(torch.square(d(cond, gt) - 1.0))
                            + torch.mean(torch.square(d(cond, fake))))
            d_loss.backward()
            d_opt.step()
            self.disc_state.step += 1
            self.d_loss = all_mean(d_loss.detach(), self.mesh)
        loss, psnr = all_mean(torch.stack(
            [loss.detach(), image_psnr(fake, gt).mean()]), self.mesh)
        return loss, psnr

    # ------------------------------------------------------------------ ckpt

    def save(self, ckpt_dir: str, name: str) -> str:
        """Write ``<ckpt_dir>/<name>.pth.tar`` (the discriminator's state
        with it); returns its path."""
        return save_checkpoint(os.path.join(ckpt_dir, name), self.state,
                               self.cfg, epoch=self.epoch,
                               extra={"best_psnr": float(self.best_psnr)},
                               disc_state=self.disc_state)

    def resume(self, path: str) -> None:
        meta = load_checkpoint(path, self.state, self.cfg,
                               disc_state=self.disc_state)
        self.epoch = int(meta["epoch"])
        self.best_psnr = float(meta.get("best_psnr",
                                        self.cfg.hfrm.best_psnr_init))

    # ------------------------------------------------------------------ train

    def fit(self, batch_iter_fn: Callable[[int], Iterable],
            max_steps: Optional[int] = None,
            ckpt_dir: Optional[str] = None,
            metrics_path: Optional[str] = None
            ) -> List[Tuple[int, float, float]]:
        """Run epochs until ``hfrm.n_epochs`` or ``max_steps``; returns
        (step, loss, psnr) of each step taken.

        batch_iter_fn(epoch) -> (B, H, W, 6) batches.  After each epoch
        ``best`` is written when its mean PSNR beats ``best_psnr``, and
        ``lastest`` every 5th epoch and at the last one; ``lastest`` also
        at ``max_steps``.  A resumed run already at ``max_steps`` takes no
        step (the JAX trainer takes one more)."""
        cfg = self.cfg
        history: List[Tuple[int, float, float]] = []
        if max_steps is not None and self.state.step >= max_steps:
            return history
        timer = StepTimer()
        mlog = MetricsLogger(metrics_path) if metrics_path else None
        for epoch in range(self.epoch, cfg.hfrm.n_epochs):
            self.epoch = epoch
            epoch_psnr = []
            for batch in batch_iter_fn(epoch):
                timer.start()
                loss, psnr = self.train_step(batch)
                timer.stop(sync_on=psnr)
                step = self.state.step
                history.append((step, float(loss), float(psnr)))
                epoch_psnr.append(history[-1][2])
                if step % 100 == 0:
                    d_note = ("" if self.d_loss is None
                              else f" D loss: {float(self.d_loss):.4f}")
                    self.log(f"[Epoch {epoch}] step {step} G loss: "
                             f"{history[-1][1]:.4f} PSNR: "
                             f"{history[-1][2]:.3f} step time: "
                             f"{timer.mean:.3f}s" + d_note)
                    if mlog is not None:
                        mlog.log(step, loss=history[-1][1],
                                 psnr=history[-1][2], step_time=timer.mean)
                if max_steps is not None and step >= max_steps:
                    if ckpt_dir:
                        self.save(ckpt_dir, "lastest")
                    return history
            mean_psnr = float(np.mean(epoch_psnr)) if epoch_psnr else 0.0
            self.log(f"epoch PSNR: {mean_psnr:.4f}, "
                     f"best psnr: {self.best_psnr:.4f}")
            if ckpt_dir:
                if mean_psnr > self.best_psnr:
                    self.best_psnr = mean_psnr
                    self.save(ckpt_dir, "best")
                if epoch % 5 == 4 or epoch == cfg.hfrm.n_epochs - 1:
                    self.save(ckpt_dir, "lastest")
        return history
