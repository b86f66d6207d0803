"""Overlapping-patch DDIM sampling on NCHW tensors.

The wavelet-domain image is covered by a static grid of p x p patches at
stride ``grid_r`` (plus flush right/bottom rows).  Each step gathers the
patches of all B images into one (B*K)-patch batch (image-major), runs the
UNet on it once, scatter-adds the noise estimates back, divides by the
count mask, and applies the deterministic DDIM update.

Ported: ``solver="ddim"`` with ``eta=0``, ``pred_type="eps"`` and
``x0_keep``.  The other options of the JAX sampler raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from wavedm_tpu_torch.diffusion.schedules import alpha_bars

__all__ = ["overlapping_grid_corners", "make_overlapping_sampler"]


def overlapping_grid_corners(h: int, w: int, p: int,
                             r: int) -> List[Tuple[int, int]]:
    """Stride-r corners covering (h, w) with p-sized patches, plus
    flush-right/bottom rows."""
    hs = list(range(0, h - p + 1, r))
    ws = list(range(0, w - p + 1, r))
    if hs[-1] + p < h:
        hs.append(h - p)
    if ws[-1] + p < w:
        ws.append(w - p)
    return [(i, j) for i in hs for j in ws]


def _count_mask(corners: Sequence[Tuple[int, int]], h: int, w: int,
                p: int) -> np.ndarray:
    mask = np.zeros((h, w), dtype=np.float32)
    for (i, j) in corners:
        mask[i:i + p, j:j + p] += 1.0
    return mask


def _ddim_coeffs(betas: torch.Tensor, seq: np.ndarray, eta: float):
    """Per-step (t, at, at_next, c1, c2), float32, for the reversed DDIM
    sequence; alpha-bars are the float32 cumprod of float32 betas."""
    abar = alpha_bars(betas.to(torch.float32))
    seq = np.asarray(seq)
    t_cur = seq[::-1].copy()
    t_next = np.concatenate([[-1], seq[:-1]])[::-1].copy()
    at = abar[torch.as_tensor(t_cur + 1, dtype=torch.long)]
    at_next = abar[torch.as_tensor(t_next + 1, dtype=torch.long)]
    c1 = eta * torch.sqrt((1 - at / at_next) * (1 - at_next) / (1 - at))
    c2 = torch.sqrt((1 - at_next) - c1 ** 2)
    return (torch.as_tensor(t_cur, dtype=torch.float32), at, at_next, c1, c2)


def _not_ported(**options) -> None:
    for name, (value, default) in options.items():
        if value != default:
            raise NotImplementedError(
                f"make_overlapping_sampler: {name}={value!r} is not ported "
                "to the PyTorch sampler yet")


def make_overlapping_sampler(
    model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    *,
    image_shape: Tuple[int, int],
    patch_size: int,
    grid_r: int,
    seq: np.ndarray,
    betas: torch.Tensor,
    pred_channels: int,
    eta: float = 0.0,
    use_other: bool = False,
    use_fft: bool = False,
    use_global: bool = False,
    patch_micro_batch: int = 0,
    mesh=None,
    x0_keep: Optional[int] = None,
    pred_type: str = "eps",
    solver: str = "ddim",
):
    """Build the tiled DDIM sampler for a fixed (h, w) geometry.

    The returned ``sample(x_init, x_cond, x_other=None)`` takes NCHW
    (B, pred, h, w), (B, Cc, h, w) and (B, Co, h, w) tensors and returns
    ``(x_final, x0_preds)``: x0_preds is (T, B, pred, h, w), or
    (1, B, pred, h, w) holding only step ``x0_keep`` when that is set.
    ``model_fn(x, t)`` maps (N, Cin, p, p) and (N,) float32 timesteps to
    the (N, pred, p, p) float32 noise estimate.
    """
    _not_ported(solver=(solver, "ddim"), eta=(eta, 0.0),
                pred_type=(pred_type, "eps"), use_fft=(use_fft, False),
                use_global=(use_global, False),
                patch_micro_batch=(patch_micro_batch, 0), mesh=(mesh, None))
    h, w = image_shape
    p = patch_size
    corners = overlapping_grid_corners(h, w, p, grid_r)
    counts_np = _count_mask(corners, h, w, p)[None, None]
    t_cur, at, at_next, _, c2 = _ddim_coeffs(betas.cpu(), seq, eta)
    # float32 per-step scalars, carried as Python floats (exact f32 values)
    ts = t_cur.tolist()
    sqrt_a = torch.sqrt(at).tolist()
    sqrt_1ma = torch.sqrt(1 - at).tolist()
    sqrt_anx = torch.sqrt(at_next).tolist()
    c2 = c2.tolist()
    n_steps = len(ts)
    keep_idx = None if x0_keep is None else x0_keep % n_steps

    def gather(img: torch.Tensor) -> torch.Tensor:
        # (B, C, h, w) -> (B*K, C, p, p), image-major patch order
        pat = torch.stack([img[:, :, i:i + p, j:j + p] for i, j in corners], 1)
        return pat.reshape((-1,) + pat.shape[2:])

    def scatter_mean(et_p: torch.Tensor, b: int,
                     counts: torch.Tensor) -> torch.Tensor:
        # sum the B*K estimates back per image in corner order, normalize
        et_b = et_p.reshape((b, len(corners)) + et_p.shape[1:])
        acc = et_p.new_zeros((b, et_p.shape[1], h, w))
        for k, (i, j) in enumerate(corners):
            acc[:, :, i:i + p, j:j + p] += et_b[:, k]
        return acc / counts

    @torch.no_grad()
    def sample(x_init: torch.Tensor, x_cond: torch.Tensor,
               x_other: Optional[torch.Tensor] = None):
        b = x_init.shape[0]
        counts = torch.as_tensor(counts_np, device=x_init.device)
        static_p = [gather(x_cond)]
        if use_other:
            static_p.append(gather(x_other))
        xt, kept, x0s = x_init, None, []
        for i in range(n_steps):
            inp = torch.cat([static_p[0], gather(xt)] + static_p[1:], dim=1)
            t = torch.full((inp.shape[0],), ts[i], dtype=torch.float32,
                           device=inp.device)
            et = scatter_mean(model_fn(inp, t), b, counts)
            x0_t = (xt - et * sqrt_1ma[i]) / sqrt_a[i]
            xt = sqrt_anx[i] * x0_t + c2[i] * et
            if keep_idx is None:
                x0s.append(x0_t)
            elif i == keep_idx:
                kept = x0_t
        return xt, (torch.stack(x0s) if keep_idx is None else kept[None])

    return sample
