"""Full-image diffusive restoration on the wavelet, pixel and Laplacian
paths, and its evaluation loop.

The wavelet path, for a batch of (B, H, W, 3) degraded images in [0, 1]:

  pixels -> [-1,1] -> Haar DWT (scale 2) -> 48 cond channels at H/4 x W/4
  HFRM(pixels) -> [-1,1] -> DWT -> the 45 high-frequency channels
  x_T: pure noise, or with ``sampling.t_start`` the HFRM LL band noised
  the reverse chain: tiled over 64x64 wavelet patches -> x0 at
  ``x0_pred_index``; or, with ``sampling.whole_image``, over the whole
  wavelet image reflect-padded to the UNet's 2**(levels-1) -> final x
  [diffusion LL(3) | HFRM HF(45)] -> IWT -> [0,1]

The pixel path (``data.wavelet: false``, and ``data.wavelet_in_unet``,
whose UNet takes the DWT itself) runs the chain on the [-1,1] pixels
themselves, with no HFRM; with ``data.use_fft`` its conditioning carries
the FFT amplitude and phase of each patch (of the whole image on the
whole-image chain).  The Laplacian path (``data.lap``) takes
the (B, H, W, 6) [cond | gt] pair, decomposes it with the 2-level Gauss
pyramid, runs the chain on the coarse cond band at H/4 x W/4 and
reconstructs with the degraded high bands and the ground truth's low band:
both quirks of the reference, which the JAX package keeps (the learned
translator never reaches the restored image).  With ``data.global_attn``
the UNet also sees the whole image: the DWT of the cond pixels on the
wavelet path, the [-1,1] cond pixels on the pixel path.

All of it stays on the device; the B images run as one (B*K)-patch UNet
batch per step.  Tensors are NCHW inside; the public entry points take and
return NHWC images as the JAX ``DiffusiveRestoration`` does.
:meth:`DiffusiveRestoration.restore` scores (pair, id) samples with the
reference's PSNR variants and SSIM on the host and can dump the images.

Two kinds of parallelism over ``torchrun``'s processes
(``parallel/distributed.py``), as in JAX:
- with a ``mesh`` the tiled chain is patch-parallel: every rank restores
  the same images, each running the UNet on its range of the patches
  (``diffusion/sampling.py``), with rank 0's x_T;
- :meth:`DiffusiveRestoration.restore` in a process group scores each
  rank's own stripe of the pairs (``data/raindrop.py``) and all-reduces
  the metric sums, so every rank reports the full set's means; rank 0
  alone writes the dumps.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from wavedm_tpu_torch.config import Config
from wavedm_tpu_torch.diffusion.sampling import (ddim_sample, fft_condition,
                                                 make_overlapping_sampler)
from wavedm_tpu_torch.diffusion.schedules import (ddim_timesteps,
                                                  get_beta_schedule)
from wavedm_tpu_torch.inference.loader import resolve_device
from wavedm_tpu_torch.ops.wavelet import wavelet_dec, wavelet_rec
from wavedm_tpu_torch.parallel.distributed import (collective_device,
                                                   process_count,
                                                   process_index)
from wavedm_tpu_torch.parallel.mesh import DataMesh
from wavedm_tpu_torch.utils.profiling import annotate

__all__ = ["data_transform", "inverse_data_transform", "refuse_lap",
           "DiffusiveRestoration"]


def data_transform(x: torch.Tensor) -> torch.Tensor:
    """[0,1] -> [-1,1]."""
    return 2.0 * x - 1.0


def inverse_data_transform(x: torch.Tensor) -> torch.Tensor:
    """[-1,1] -> [0,1], clamped."""
    return torch.clamp((x + 1.0) / 2.0, 0.0, 1.0)


def refuse_lap(cfg: Config, who: str) -> None:
    """Raise for the Laplacian path in an entry point that restores lone
    degraded images: that path takes its low band from the ground truth."""
    if cfg.data.lap:
        raise ValueError(
            f"{who}: the Laplacian path (data.lap) restores from the "
            "[cond|gt] pair and takes its low band from the ground truth, "
            "which a lone degraded image does not have; evaluate pairs "
            "with cli.eval_diffusion instead")


class DiffusiveRestoration:
    """Restoration runner for a fixed config.

    Args:
      cfg: validated Config.
      unet: the diffusion UNet (``DiffusionUNet``, or
        ``DiffusionUNetGlobal`` with ``data.global_attn``; eval mode, on
        ``device``).
      hfrm: the frozen stage-1 ``HFRM`` on the wavelet path; None on the
        pixel and Laplacian paths and under ``wavelet_in_unet``, which
        take none.
      device: where everything runs; the card when None (raises if there
        is none).
      mesh: a data mesh (``parallel/mesh.py``) over which the tiled chain
        is patch-parallel; None or a mesh of one rank runs it whole.
    """

    def __init__(self, cfg: Config, unet: nn.Module,
                 hfrm: Optional[nn.Module] = None, device=None,
                 mesh: Optional[DataMesh] = None):
        if cfg.data.wavelet_domain and hfrm is None:
            raise ValueError("the wavelet path requires a frozen HFRM")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.scores = []
        self.unet, self.hfrm = unet, hfrm
        self.betas = torch.as_tensor(get_beta_schedule(
            cfg.diffusion.beta_schedule,
            beta_start=cfg.diffusion.beta_start,
            beta_end=cfg.diffusion.beta_end,
            num_diffusion_timesteps=cfg.diffusion.num_diffusion_timesteps,
        ), dtype=torch.float32)
        if cfg.sampling.t_start > 0:
            skip = max(1, cfg.sampling.t_start
                       // cfg.sampling.sampling_timesteps)
            self.seq = np.arange(0, cfg.sampling.t_start, skip,
                                 dtype=np.int32)
        else:
            self.seq = ddim_timesteps(cfg.diffusion.num_diffusion_timesteps,
                                      cfg.sampling.sampling_timesteps)
        self._restore_fns: Dict[Tuple[int, int], Callable] = {}

    def _init_chain_state(self, base_ll: Optional[torch.Tensor],
                          noise: torch.Tensor) -> torch.Tensor:
        """x at the chain's start: ``noise``, or ``base_ll`` noised to the
        chain's starting alpha-bar (float32 cumprod of float32 betas)."""
        abar = torch.cumprod(1.0 - self.betas, dim=0)
        if self.cfg.sampling.t_start > 0:
            a = abar[int(self.seq[-1])]
        elif self.cfg.data.begin_from_noise or base_ll is None:
            return noise
        else:
            a = abar[-1]
        sqrt_1ma = torch.sqrt(1.0 - a).item()
        if base_ll is None:
            return noise * sqrt_1ma
        return base_ll * torch.sqrt(a).item() + noise * sqrt_1ma

    def _init_base_ll(self, cond: torch.Tensor,
                      hfrm: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """The LL-band source noised by ``_init_chain_state``; None = pure
        noise."""
        s = self.cfg.sampling
        pc = self.cfg.model.pred_channels
        if s.t_start > 0:
            if s.init_ll == "hfrm":
                if hfrm is None:
                    raise ValueError("init_ll: hfrm needs the wavelet path")
                return hfrm[:, :pc]
            if s.init_ll == "cond":
                return cond[:, :pc]
            return None
        return None if self.cfg.data.begin_from_noise else cond[:, :pc]

    def _make_sampler(self, h: int, w: int, use_other: bool,
                      use_fft: bool = False) -> Callable:
        """The chain for (h, w) in the UNet's domain: tiled, or with
        ``sampling.whole_image`` over the whole image, reflect-padded to
        the UNet's 2**(levels-1) divisibility and cropped back.  Both map
        (x_init, x_cond, x_other, generator, step_noise, x_global) to
        (x_final, x0_preds); on the whole-image path ``step_noise`` has the
        padded geometry."""
        cfg, m = self.cfg, self.cfg.model
        use_global = cfg.data.global_attn
        chain = dict(seq=self.seq, betas=self.betas, eta=cfg.sampling.eta,
                     pred_type=cfg.training.pred_type,
                     solver=cfg.sampling.solver)
        if not cfg.sampling.whole_image:
            return make_overlapping_sampler(
                self.unet,
                image_shape=(h, w),
                patch_size=cfg.data.image_size,
                grid_r=cfg.sampling.grid_r,
                pred_channels=m.pred_channels,
                use_other=use_other,
                use_fft=use_fft,
                use_global=use_global,
                patch_micro_batch=cfg.sampling.patch_micro_batch,
                mesh=self.mesh,
                x0_keep=cfg.sampling.x0_pred_index,
                **chain)
        if use_global:
            raise ValueError(
                "whole_image + global_attn is redundant (the global branch "
                "injects whole-image context into tiles); disable one")
        div = 2 ** (len(m.ch_mult) - 1)
        pad = (0, (-w) % div, 0, (-h) % div)

        def reflect(x: torch.Tensor) -> torch.Tensor:
            return F.pad(x, pad, mode="reflect") if any(pad) else x

        def sample(x_init, x_cond, x_other=None, generator=None,
                   step_noise=None, x_global=None):
            other_p = None if x_other is None else reflect(x_other)
            cond_p = reflect(x_cond)
            if use_fft:
                cond_p = fft_condition(cond_p)

            def model_fn(xx, tt):
                # ddim_sample hands over [cond | xt]; the HF channels follow
                if other_p is not None:
                    xx = torch.cat([xx, other_p], dim=1)
                return self.unet(xx, tt)

            x_final, x0s = ddim_sample(
                model_fn, reflect(x_init), cond_p,
                generator=generator, step_noise=step_noise, **chain)
            return x_final[:, :, :h, :w], x0s[..., :h, :w]

        return sample

    def _select_output(self, x_final: torch.Tensor,
                       x0_preds: torch.Tensor) -> torch.Tensor:
        """Tiled path: the x0 estimate at ``x0_pred_index`` (the sampler is
        built with ``x0_keep``, so x0_preds holds exactly that one).
        Whole-image path: the final x."""
        if self.cfg.sampling.whole_image:
            return x_final
        return x0_preds[0]

    def _build_wavelet_restore(self, h: int, w: int) -> Callable:
        """Restore pipeline for pixel geometry (h, w), working in the
        wavelet domain (h/4, w/4)."""
        m = self.cfg.model
        sampler = self._make_sampler(h // 4, w // 4, m.use_other_channels)

        def restore(cond_pixel: torch.Tensor, noise: torch.Tensor,
                    generator: torch.Generator,
                    step_noise: Optional[torch.Tensor]):
            # cond_pixel: (B, 3, h, w) in [0,1]; noise: (B, pred, h/4, w/4)
            with annotate("restore.wavelet"):
                cond_w = wavelet_dec(data_transform(cond_pixel))
            with annotate("restore.hfrm"):
                restored = self.hfrm(cond_pixel)
            with annotate("restore.wavelet"):
                hfrm_w = wavelet_dec(data_transform(restored))
            x_init = self._init_chain_state(
                self._init_base_ll(cond_w, hfrm_w), noise)
            x_other = (hfrm_w[:, m.other_channels_begin:]
                       if m.use_other_channels else None)
            # the whole image the global UNet sees is the cond image itself,
            # in the UNet's domain
            x_global = cond_w if self.cfg.data.global_attn else None
            x_final, x0_preds = sampler(x_init, cond_w, x_other, generator,
                                        step_noise, x_global)
            sel = self._select_output(x_final, x0_preds)
            full = torch.cat([sel[:, :m.pred_channels],
                              hfrm_w[:, m.pred_channels:]], dim=1)
            with annotate("restore.wavelet"):
                out = inverse_data_transform(wavelet_rec(full))
            return out, restored

        return restore

    def _build_pixel_restore(self, h: int, w: int) -> Callable:
        """Restore pipeline for the pixel path: the chain on the [-1,1]
        pixels; the second output is the cond image passed through."""
        sampler = self._make_sampler(h, w, use_other=False,
                                     use_fft=self.cfg.data.use_fft)

        def restore(cond_pixel, noise, generator, step_noise):
            with annotate("restore.pixel"):
                cond_n = data_transform(cond_pixel)
                x_init = self._init_chain_state(
                    self._init_base_ll(cond_n, None), noise)
            x_global = cond_n if self.cfg.data.global_attn else None
            x_final, x0_preds = sampler(x_init, cond_n, None, generator,
                                        step_noise, x_global)
            sel = self._select_output(x_final, x0_preds)
            with annotate("restore.pixel"):
                out = inverse_data_transform(sel)
            return out, cond_pixel

        return restore

    def _build_lap_restore(self, h: int, w: int) -> Callable:
        """Restore pipeline for the Laplacian path: the [cond | gt] pair's
        2-level pyramid, the chain on the coarse cond band at (h/4, w/4),
        and the reconstruction from the degraded high bands and the
        ground truth's low band (see the module doc); the second output is
        the cond image."""
        from wavedm_tpu_torch.models.laplacian import LaplacianPyramid
        from wavedm_tpu_torch.training.lap import LAP_NUM_HIGH

        lap = LaplacianPyramid(LAP_NUM_HIGH)
        sampler = self._make_sampler(h // 4, w // 4, use_other=False)

        def restore(pair_pixel, noise, generator, step_noise):
            pyr = lap.decompose(data_transform(pair_pixel))
            cond_coarse, gt_lowf = pyr[-1][:, :3], pyr[-1][:, 3:]
            x_init = self._init_chain_state(
                self._init_base_ll(cond_coarse, None), noise)
            x_final, x0_preds = sampler(x_init, cond_coarse, None, generator,
                                        step_noise)
            sel = self._select_output(x_final, x0_preds)
            rec = lap.reconstruct(pyr[:-1] + [torch.cat([sel, gt_lowf],
                                                        dim=1)])
            return inverse_data_transform(rec[:, :3]), pair_pixel[:, :3]

        return restore

    def _get_restore_fn(self, h: int, w: int, nch: int) -> Callable:
        if self.cfg.data.lap:
            if nch != 6:
                raise ValueError(
                    "lap restoration needs the 6-channel [cond|gt] pair")
        elif nch != 3:
            raise ValueError(f"expected (B, H, W, 3) images, got {nch} "
                             "channels")
        if (h, w) not in self._restore_fns:
            build = (self._build_lap_restore if self.cfg.data.lap else
                     self._build_wavelet_restore
                     if self.cfg.data.wavelet_domain
                     else self._build_pixel_restore)
            self._restore_fns[(h, w)] = build(h, w)
        return self._restore_fns[(h, w)]

    @torch.no_grad()
    def restore_image_device(
        self, cond_pixel, noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        step_noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B|None, H, W, 3) [0,1] image(s) -> (restored, aux), both
        (B, H, W, 3) float32 on the device, with no host transfer.  ``aux``
        is the HFRM output on the wavelet path and the cond image on the
        others.  The Laplacian path takes the (B|None, H, W, 6) [cond | gt]
        pair instead.

        ``noise``: x_T draw as (B, pred_channels, h, w) at the chain's
        geometry (H/4 x W/4 on the wavelet and Laplacian paths, H x W on
        the pixel path); when None it is drawn on the device from
        ``generator`` (default: seeded with ``training.seed``), which also
        draws the per-step noise at ``sampling.eta`` > 0 unless
        ``step_noise`` (T, B, pred, h, w) is given.  Over a patch-parallel
        mesh every rank calls it with the same images, and x_T and each
        step's noise are rank 0's."""
        with annotate("restore"):
            x = torch.as_tensor(cond_pixel, dtype=torch.float32,
                                device=self.device)
            if x.dim() == 3:
                x = x[None]
            b, h, w, nch = x.shape
            fn = self._get_restore_fn(h, w, nch)
            if self.cfg.data.wavelet_domain or self.cfg.data.lap:
                if h % 4 or w % 4:
                    raise ValueError(f"image dims {(h, w)} must be divisible "
                                     "by 4")
                shape = (b, self.cfg.model.pred_channels, h // 4, w // 4)
            else:
                shape = (b, self.cfg.model.pred_channels, h, w)
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(
                    self.cfg.training.seed)
            if noise is None:
                noise = torch.randn(shape, generator=generator,
                                    device=self.device, dtype=torch.float32)
            elif tuple(noise.shape) != shape:
                raise ValueError(f"noise must be {shape}, got "
                                 f"{tuple(noise.shape)}")
            noise = noise.to(device=self.device, dtype=torch.float32)
            if self.mesh is not None and self.mesh.size > 1:
                noise = noise.contiguous()
                self.mesh.broadcast(noise)
            pixels = x.permute(0, 3, 1, 2).contiguous()
            out, aux = fn(pixels, noise, generator, step_noise)
            return out.permute(0, 2, 3, 1), aux.permute(0, 2, 3, 1)

    def restore_image(self, cond_pixel, noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      step_noise: Optional[torch.Tensor] = None
                      ) -> Tuple[np.ndarray, torch.Tensor]:
        """As :meth:`restore_image_device`, with the restored image fetched
        to the host as a (B, H, W, 3) numpy array; the aux output stays on
        the device."""
        out, restored = self.restore_image_device(cond_pixel, noise,
                                                  generator, step_noise)
        with annotate("sync.fetch"):
            return out.cpu().numpy(), restored

    def restore(self, samples: Iterable[Tuple[np.ndarray, str]],
                save_dir: Optional[str] = None,
                generator: Optional[torch.Generator] = None,
                eval_batch: int = 1, reduce: bool = True) -> Dict[str, float]:
        """Score (pair (H, W, 6) [cond | gt] in [0,1], image_id) samples;
        returns the mean ``psnr_torch``, ``psnr_y``, ``psnr_np_y``,
        ``ssim`` and ``n_images``, and keeps each image's
        (id, psnr_torch, psnr_y, psnr_np_y, ssim) in ``self.scores``.

        Runs of up to ``eval_batch`` same-geometry pairs restore as one
        batch (a change of geometry flushes the batch), each drawing its
        x_T from ``generator`` (default: seeded with ``training.seed``).
        Metrics are per image, on the host in float64.  With ``save_dir``
        each image writes ``{id}_output.png``, ``{id}_cond.png`` and
        ``{id}_gt.png`` there.

        In a process group every rank calls it on its own stripe of the
        pairs and the means are over all of them: the five sums are
        all-reduced in float64 (``reduce=False`` scores this process's
        samples alone, for a call made on one rank).  Only rank 0 writes
        dumps.  Each rank draws from its own generator seeded with
        ``training.seed``, as each JAX process does from its own key, so an
        image's x_T depends on the world size."""
        from wavedm_tpu_torch.utils import metrics as M
        from wavedm_tpu_torch.utils.images import save_image

        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(
                self.cfg.training.seed)
        if process_index() != 0:
            save_dir = None
        psnr_t, psnr_y, psnr_n, ssims = [], [], [], []
        self.scores = []

        def flush(batch):
            if not batch:
                return
            pairs = np.stack([p for p, _ in batch])
            # the Laplacian path restores from the whole pair (its low band
            # comes from the ground truth, see the module doc)
            inp = pairs if self.cfg.data.lap else pairs[..., :3]
            out, _ = self.restore_image(inp, generator=generator)
            for k, (pair, img_id) in enumerate(batch):
                cond, gt = pair[..., :3], pair[..., 3:]
                out0 = out[k]
                gt255 = np.clip(gt * 255, 0, 255)
                out255 = np.clip(out0 * 255, 0, 255)
                psnr_t.append(M.psnr_torch(gt, out0))
                psnr_y.append(M.psnr_y(gt, out0))
                psnr_n.append(M.psnr_np(gt255, out255, test_y_channel=True))
                ssims.append(M.ssim(gt255, out255))
                self.scores.append((img_id, psnr_t[-1], psnr_y[-1],
                                    psnr_n[-1], ssims[-1]))
                if save_dir is not None:
                    save_image(out0, f"{save_dir}/{img_id}_output.png")
                    save_image(cond, f"{save_dir}/{img_id}_cond.png")
                    save_image(gt, f"{save_dir}/{img_id}_gt.png")

        buf = []
        for pair, img_id in samples:
            if buf and pair.shape != buf[0][0].shape:
                flush(buf)
                buf = []
            buf.append((pair, img_id))
            if len(buf) == max(1, eval_batch):
                flush(buf)
                buf = []
        flush(buf)
        sums = np.array([np.sum(psnr_t), np.sum(psnr_y), np.sum(psnr_n),
                         np.sum(ssims), len(psnr_t)], np.float64)
        if reduce and process_count() > 1:
            total = torch.from_numpy(sums).to(collective_device())
            dist.all_reduce(total)
            sums = total.cpu().numpy()
        n = max(sums[4], 1.0)
        return {
            "psnr_torch": float(sums[0] / n),
            "psnr_y": float(sums[1] / n),
            "psnr_np_y": float(sums[2] / n),
            "ssim": float(sums[3] / n),
            "n_images": int(sums[4]),
        }
