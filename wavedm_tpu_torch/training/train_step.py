"""The stage-2 diffusion train step.

One call: batch prep (the domain transform) -> antithetic t and noise
draws -> eps/v loss -> backward -> optimizer -> EMA, updating the
``TrainState`` in place.  The port of ``wavedm_tpu/training/train_step.py``.
Batches arrive as (B, P, P, 6) [cond | gt] pixels in [0, 1] (the JAX
layout) and run as NCHW inside.  The domains:

- wavelet: the 2-level Haar packet of cond and target, with the HF
  conditioning from the ground truth or the frozen HFRM;
- pixel (``data.wavelet: false``, and ``data.wavelet_in_unet``, whose
  UNet takes the DWT itself): the [-1,1] pixels as they are, with
  ``data.use_fft`` the cond pixels' FFT amplitude and phase appended;
- global (``data.global_attn``, on either): the batch is (crops, totals),
  one 720x480 whole image per B images of crops, which the UNet's global
  branch takes in [-1,1] (wavelet-decomposed on the wavelet path);
- Laplacian (``data.lap``): the diffusion trains on the coarsest level of
  the 2-level Gauss pyramid of the [-1,1] pair, while the high-frequency
  translator takes its own Adam step on the sum of the per-level MSEs
  (``training/lap.py``).

As in JAX, the reported loss per pixel divides by ``pred_channels *
image_size**2`` on every domain, on the Laplacian one too, where the loss
lives on a level 4x smaller on each side.

Over a data mesh (``parallel/mesh.py``) the model is DDP- or FSDP-wrapped
and each rank steps on its slice of the global batch: every rank draws t
and the noise for the whole global batch from its generator (seeded alike
on every rank) and keeps its own slice, so the generators stay equal and a
world of N on a global batch steps as a world of one on it (JAX draws over
the global batch inside its jitted step).  DDP's backward averages the
gradients; the gradient norm is the global gradient's and the reported
losses are means over the ranks.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from wavedm_tpu_torch.config import Config
from wavedm_tpu_torch.diffusion.ema import ema_update
from wavedm_tpu_torch.diffusion.loss import (antithetic_timesteps,
                                             noise_estimation_loss)
from wavedm_tpu_torch.diffusion.sampling import fft_condition
from wavedm_tpu_torch.diffusion.schedules import get_beta_schedule
from wavedm_tpu_torch.inference.restoration import (data_transform,
                                                    inverse_data_transform)
from wavedm_tpu_torch.ops.wavelet import wavelet_dec
from wavedm_tpu_torch.parallel.mesh import (DataMesh, all_mean, grad_norm,
                                            grad_sync, unwrap)
from wavedm_tpu_torch.training.state import TrainState
from wavedm_tpu_torch.utils.profiling import annotate

__all__ = ["data_transform", "inverse_data_transform", "prepare_pixel_batch",
           "prepare_wavelet_batch", "prepare_global_batch", "StepMetrics",
           "make_train_step"]


def prepare_pixel_batch(x: torch.Tensor, cfg: Config) -> torch.Tensor:
    """(B, P, P, 6) [cond | gt] pixels in [0,1] -> (B, 6, P, P) NCHW
    training tensor in [-1,1], contiguous (the fused kernel takes no
    channels-last strides); with ``data.use_fft`` (B, 12, P, P), the cond
    channels tripled to [cond | FFT amp | FFT phase]."""
    x = data_transform(x.permute(0, 3, 1, 2).contiguous())
    if cfg.data.use_fft:
        c = cfg.data.channels
        return torch.cat([fft_condition(x[:, :c]), x[:, c:]], dim=1)
    return x


def prepare_wavelet_batch(x: torch.Tensor, cfg: Config,
                          hfrm: Optional[nn.Module] = None) -> torch.Tensor:
    """(B, P, P, 6) [cond | gt] pixels in [0,1] -> (B, 96, P/4, P/4) NCHW
    training tensor [cond(48) | gt LL(pred) | HF(45)].

    With ``use_gt_in_train`` the HF conditioning is the ground truth's
    wavelet bands; otherwise the frozen ``hfrm``'s restoration of the cond
    pixels, decomposed (it runs without autograd)."""
    m = cfg.model
    x = x.permute(0, 3, 1, 2)
    x_all = data_transform(x)
    cond_w = wavelet_dec(x_all[:, :3])
    gt_w = wavelet_dec(x_all[:, 3:6])
    if not m.use_other_channels:
        return torch.cat([cond_w, gt_w[:, :m.pred_channels]], dim=1)
    if m.use_gt_in_train:
        hf = gt_w[:, m.other_channels_begin:]
    else:
        if hfrm is None:
            raise ValueError("use_gt_in_train=False requires an hfrm")
        with torch.no_grad():
            restored = hfrm(x[:, :3].contiguous())   # HFRM takes [0,1]
        hf = wavelet_dec(data_transform(restored))[:, m.other_channels_begin:]
    return torch.cat([cond_w, gt_w[:, :m.pred_channels], hf], dim=1)


def prepare_global_batch(total: torch.Tensor, cfg: Config) -> torch.Tensor:
    """(Bg, H, W, 3) whole images in [0,1] -> the global UNet's (Bg, C, ., .)
    NCHW input: [-1,1] pixels, wavelet-decomposed on the wavelet path."""
    t = data_transform(total.permute(0, 3, 1, 2))
    if cfg.data.wavelet_domain:
        t = wavelet_dec(t)
    return t


class StepMetrics(NamedTuple):
    loss: torch.Tensor            # eps loss (sum over pixels, batch mean)
    mse_loss: torch.Tensor        # x0 MSE
    loss_per_pixel: torch.Tensor
    grad_norm: torch.Tensor
    loss_trans: torch.Tensor = torch.zeros(())   # lap translator MSE


def make_train_step(cfg: Config, model: nn.Module,
                    hfrm: Optional[nn.Module] = None,
                    mesh: Optional[DataMesh] = None) -> Callable:
    """The step for the config's domain.

    ``step(state, batch, t=None, e=None) -> StepMetrics``; on the global
    domain ``batch`` is ``(crops, totals)``.  The Laplacian domain's is
    ``step(state, lap_state, batch, lap_lr, t=None, e=None)``, which also
    advances the translator's ``LapState`` with learning rate ``lap_lr``.

    batch: (B, P, P, 6) float32 pixels in [0,1], array or tensor.  t: (B,)
    integer timesteps and e: (B, pred_channels, h, w) noise at the
    diffusion domain's geometry; each is drawn from ``state.generator`` when
    not given.  ``training.grad_accum`` > 1 splits the batch into that many
    micro-batches and averages their gradients into one update (not on the
    global and Laplacian domains, as in JAX).

    ``model`` may be wrapped for the ``mesh`` (``replicate`` or
    ``fsdp_shard``); ``batch`` is then this rank's slice and ``t`` and ``e``,
    when given, cover the global batch (this rank's slice times the mesh
    size), of which each rank keeps its own part.  The Laplacian domain
    runs on one process only."""
    m, d = cfg.model, cfg.data
    device = next(model.parameters()).device
    betas = torch.as_tensor(get_beta_schedule(
        cfg.diffusion.beta_schedule,
        beta_start=cfg.diffusion.beta_start,
        beta_end=cfg.diffusion.beta_end,
        num_diffusion_timesteps=cfg.diffusion.num_diffusion_timesteps,
    ), dtype=torch.float32, device=device)
    num_timesteps = cfg.diffusion.num_diffusion_timesteps
    num_of_pixel = m.pred_channels * d.image_size ** 2
    # JAX's arithmetic: under wavelet_in_unet the pixel batch's cond is
    # model.in_channels wide as well
    inp_channels = (m.in_channels if d.wavelet
                    else d.channels * (3 if d.use_fft else 1))
    accum = cfg.training.grad_accum
    if accum > 1 and (d.global_attn or d.lap):
        raise ValueError("training.grad_accum > 1 is not supported with "
                         "global_attn or the lap path")
    mu = m.ema_rate
    size = 1 if mesh is None else mesh.size
    if d.lap and size > 1:
        raise ValueError("the Laplacian domain trains on one process; its "
                         "translator is not replicated over a data mesh")

    def loss_fn(x, t, e, x_global):
        fn = model if x_global is None else (
            lambda xx, tt: model(xx, tt, x_global))
        return noise_estimation_loss(
            fn, x, t, e, betas, inp_channels=inp_channels,
            pred_channels=m.pred_channels,
            use_other_channels=m.use_other_channels,
            pred_type=cfg.training.pred_type,
            snr_gamma=cfg.training.snr_gamma)

    def diffusion_update(state: TrainState, x: torch.Tensor,
                         x_global: Optional[torch.Tensor],
                         t: Optional[torch.Tensor], e: Optional[torch.Tensor],
                         loss_trans: torch.Tensor) -> StepMetrics:
        """t/e draws, eps-loss gradients, the optimizer and the EMA on the
        diffusion-domain tensor ``x``."""
        n = x.shape[0]
        if n % accum:
            raise ValueError(
                f"batch of {n} crops not divisible by grad_accum={accum}")
        if t is None:
            t = antithetic_timesteps(state.generator, n * size, num_timesteps)
        if e is None:
            e = torch.randn((n * size, m.pred_channels) + tuple(x.shape[2:]),
                            generator=state.generator, device=device)
        if size > 1:
            if len(t) != n * size or len(e) != n * size:
                raise ValueError(f"t and e cover the global batch of "
                                 f"{n * size}, got {len(t)} and {len(e)}")
            t, e = (v[mesh.rank * n:(mesh.rank + 1) * n] for v in (t, e))
        t, e = t.to(device), e.to(device=device, dtype=torch.float32)

        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        simple = mse = 0.0
        mb = n // accum
        for i in range(accum):
            sl = slice(i * mb, (i + 1) * mb)
            # over a mesh the gradients are averaged on the last pass only
            with grad_sync(model, i == accum - 1):
                with annotate("train.forward"):
                    out = loss_fn(x[sl], t[sl], e[sl], x_global)
                    main = (out.mse_loss if cfg.training.use_mse
                            else out.simple_loss)
                with annotate("train.backward"):
                    (main / accum).backward()
            # micro losses are means over equal micro-batches
            simple = simple + out.simple_loss.detach() / accum
            mse = mse + out.mse_loss.detach() / accum

        with annotate("train.update"):
            gnorm = grad_norm([p.grad for p in model.parameters()
                               if p.grad is not None])
            state.optimizer.step()
            ema_update(state.ema, [(k, p) for k, p in
                                   unwrap(model).named_parameters()
                                   if k in state.ema], mu)
            state.step += 1
            simple, mse = all_mean(torch.stack([simple, mse]), mesh)
        return StepMetrics(loss=simple, mse_loss=mse,
                           loss_per_pixel=simple / num_of_pixel,
                           grad_norm=gnorm, loss_trans=loss_trans)

    if d.lap:
        from wavedm_tpu_torch.models.laplacian import LaplacianPyramid
        from wavedm_tpu_torch.training.lap import LAP_NUM_HIGH, LapState

        lap_pyr = LaplacianPyramid(LAP_NUM_HIGH)

        def lap_loss(trans: Sequence[torch.Tensor],
                     pyr: Sequence[torch.Tensor]) -> torch.Tensor:
            return sum(F.mse_loss(trans[lv], pyr[lv][:, 3:])
                       for lv in range(LAP_NUM_HIGH))

        def lap_step(state: TrainState, lap_state: LapState, batch,
                     lap_lr: float, t: Optional[torch.Tensor] = None,
                     e: Optional[torch.Tensor] = None) -> StepMetrics:
            with annotate("train.step"):
                with annotate("train.prepare"):
                    x = torch.as_tensor(batch, dtype=torch.float32,
                                        device=device)
                    pyr = lap_pyr.decompose(prepare_pixel_batch(x, cfg))
                lap_state.model.train()
                opt = lap_state.optimizer
                for group in opt.param_groups:
                    group["lr"] = lap_lr
                opt.zero_grad(set_to_none=True)
                loss_trans = lap_loss(
                    lap_state.model([lvl[:, :3] for lvl in pyr]), pyr)
                loss_trans.backward()
                opt.step()
                return diffusion_update(state, pyr[-1].contiguous(), None,
                                        t, e, loss_trans.detach())

        return lap_step

    def step(state: TrainState, batch, t: Optional[torch.Tensor] = None,
             e: Optional[torch.Tensor] = None) -> StepMetrics:
        with annotate("train.step"):
            with annotate("train.prepare"):
                x_global = None
                if d.global_attn:
                    batch, total = batch
                    x_global = prepare_global_batch(
                        torch.as_tensor(total, dtype=torch.float32,
                                        device=device), cfg)
                x = torch.as_tensor(batch, dtype=torch.float32,
                                    device=device)
                x = (prepare_wavelet_batch(x, cfg, hfrm) if d.wavelet_domain
                     else prepare_pixel_batch(x, cfg))
            return diffusion_update(state, x, x_global, t, e,
                                    torch.zeros(()))

    return step
