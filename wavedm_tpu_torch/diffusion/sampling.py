"""Reverse diffusion chains on NCHW tensors: tiled and whole-image.

``make_overlapping_sampler`` covers the wavelet-domain image with a static
grid of p x p patches at stride ``grid_r`` (plus flush right/bottom rows).
Each step gathers the patches of all B images into one (B*K)-patch batch
(image-major), runs the UNet on it (in chunks of ``patch_micro_batch`` when
set), scatter-adds the estimates back, divides by the count mask, and
applies the update.  ``ddim_sample`` runs the same chain over whole images.

Both take ``solver`` "ddim" (``eta`` >= 0) or "dpmpp2m" (DPM-Solver++(2M),
deterministic), and ``pred_type`` "eps" or "v" (a velocity output becomes
the implied epsilon, on the tiled path after the overlap average).  With
``eta`` > 0 each step adds noise drawn from an explicit
``torch.Generator``, or taken from an injected ``step_noise`` of shape
(T, B, C, H, W).  With ``use_fft`` each patch's conditioning carries its
FFT amplitude and phase (:func:`fft_condition`).

With a ``mesh`` of more than one rank (``parallel/mesh.py``) the tiled
chain is patch-parallel, as JAX's is over its mesh: each rank runs the
UNet on its contiguous range of the B*K patches, scatter-adds its
estimates into a full-size accumulator of zeros, and one all-reduce (SUM)
a step gives every rank the whole sum before the same division and update.
That moves B*pred*h*w floats a step (518 KB at B = 2 on a 720x480 image)
and needs no padding for an uneven split.  Every rank must pass the same
x_init; the noise of each step at ``eta`` > 0 is rank 0's, broadcast.

With ``use_global`` the model also takes the B whole images and the image
of each patch it is handed, so every patch attends to its own image's
tokens, in micro-batches too.  The JAX sampler hands each micro-batch of
``mb`` patches all B images and lets the model spread them over the chunk
by position (``mb / B`` patches each), which gives patches another
image's tokens whenever B > 1 (ROADMAP section 3).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from wavedm_tpu_torch.diffusion.schedules import alpha_bars
from wavedm_tpu_torch.parallel.mesh import DataMesh

__all__ = ["real_bins", "fft_condition", "overlapping_grid_corners",
           "ddim_sample",
           "make_overlapping_sampler"]

Steps = List[Dict[str, float]]


def real_bins(h: int, w: int) -> np.ndarray:
    """(h, w) mask of the bins of a real image's 2-D FFT that are real:
    the DC and Nyquist rows and columns where they meet."""
    rows, cols = (np.arange(n) * 2 % n == 0 for n in (h, w))
    return rows[:, None] & cols[None, :]


def fft_condition(cond: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 3C, H, W): [cond | |FFT2(cond)| |
    angle(FFT2(cond))], the 2-D FFT over (H, W) of each channel (JAX's
    ``fft_condition``).

    The phase is the principal value, in (-pi, pi], of the exact
    spectrum: the bins of :func:`real_bins` have an imaginary part of
    exactly 0, where an FFT may leave rounding noise or a -0 that puts a
    negative bin's phase at -pi.  JAX's does, with a sign that depends on
    the image (ROADMAP section 3)."""
    f = torch.fft.fft2(cond)
    real = torch.as_tensor(real_bins(*cond.shape[-2:]), device=cond.device)
    imag = torch.where(real, 0.0, f.imag)
    return torch.cat([cond, f.abs(), torch.atan2(imag, f.real)], dim=1)


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


def _dpmpp2m_coeffs(betas: torch.Tensor, seq: np.ndarray):
    """Per-step (t, at, sig_ratio, alpha_next, em1, c2) of DPM-Solver++(2M)
    (Lu et al. 2022), computed in float64 from the float32 alpha-bars and
    cast to float32.

    With lam = log(alpha/sigma) and h_i = lam_{i+1} - lam_i, step i maps
    x_i to (sig_{i+1}/sig_i) x_i - alpha_{i+1} expm1(-h_i) D~_i, where
    D~_i = (1 + c2_i) D_i - c2_i D_{i-1} and c2_i = h_i / (2 h_{i-1}).  The
    first and the last step are first order (c2 = 0); on the last,
    sigma -> 0 gives expm1(-inf) = -1 and a zero ratio, so x = D~."""
    abar = alpha_bars(betas.to(torch.float32)).double().numpy()
    seq = np.asarray(seq)
    t_cur = seq[::-1].copy()
    t_next = np.concatenate([[-1], seq[:-1]])[::-1].copy()
    a_cur, a_next = abar[t_cur + 1], abar[t_next + 1]
    alpha_c, sigma_c = np.sqrt(a_cur), np.sqrt(1 - a_cur)
    alpha_n, sigma_n = np.sqrt(a_next), np.sqrt(1 - a_next)
    with np.errstate(divide="ignore"):
        lam_c = np.log(alpha_c / sigma_c)
        lam_n = np.where(sigma_n > 0, np.log(
            alpha_n / np.where(sigma_n > 0, sigma_n, 1.0)), np.inf)
    h = lam_n - lam_c
    sig_ratio = np.where(sigma_c > 0, sigma_n / sigma_c, 0.0)
    em1 = np.expm1(-h)
    c2 = np.zeros_like(h)
    if len(h) > 1:
        with np.errstate(invalid="ignore", divide="ignore"):
            c2[1:] = h[1:] / (2.0 * h[:-1])
    c2[-1] = 0.0
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    return (f32(t_cur), f32(a_cur), f32(sig_ratio), f32(alpha_n), f32(em1),
            f32(c2))


def _check_chain(solver: str, eta: float, pred_type: str) -> None:
    if solver not in ("ddim", "dpmpp2m"):
        raise ValueError(f"solver must be ddim or dpmpp2m, got {solver!r}")
    if solver == "dpmpp2m" and eta > 0:
        raise ValueError("dpmpp2m is deterministic; eta must be 0")
    if pred_type not in ("eps", "v"):
        raise ValueError(f"pred_type must be eps or v, got {pred_type!r}")


def _chain_steps(betas: torch.Tensor, seq: np.ndarray, eta: float,
                 solver: str) -> Steps:
    """The per-step constants in chain order, as Python floats holding the
    float32 values."""
    betas = betas.cpu()
    if solver == "ddim":
        t, at, at_next, c1, c2 = _ddim_coeffs(betas, seq, eta)
        cols = dict(t=t, sqrt_anx=torch.sqrt(at_next), c1=c1, c2=c2)
    else:
        t, at, sig_ratio, alpha_n, em1, c2 = _dpmpp2m_coeffs(betas, seq)
        cols = dict(t=t, sig_ratio=sig_ratio, alpha_n=alpha_n, em1=em1,
                    c2=c2)
    cols.update(sqrt_a=torch.sqrt(at), sqrt_1ma=torch.sqrt(1 - at))
    names = list(cols)
    return [dict(zip(names, vals))
            for vals in zip(*(cols[k].tolist() for k in names))]


def _noise_source(eta: float, generator: Optional[torch.Generator],
                  step_noise: Optional[torch.Tensor], n_steps: int,
                  x: torch.Tensor) -> Callable[[int], Optional[torch.Tensor]]:
    """step -> the noise the step adds: None at eta = 0; else
    ``step_noise[i]``, or a (B, C, H, W) draw from ``generator`` (default:
    seed 0 on x's device)."""
    if eta <= 0:
        return lambda i: None
    if step_noise is not None:
        want = (n_steps,) + tuple(x.shape)
        if tuple(step_noise.shape) != want:
            raise ValueError(f"step_noise must be {want}, got "
                             f"{tuple(step_noise.shape)}")
        return lambda i: step_noise[i].to(device=x.device, dtype=x.dtype)
    if generator is None:
        generator = torch.Generator(device=x.device).manual_seed(0)
    return lambda i: torch.randn(x.shape, generator=generator,
                                 device=x.device, dtype=x.dtype)


def _broadcast_noise(noise: Callable[[int], Optional[torch.Tensor]],
                     mesh: DataMesh) -> Callable[[int], Optional[torch.Tensor]]:
    """The noise source with each step's draw taken from rank 0, so every
    rank of a patch-parallel chain adds the same noise."""
    def rank0(i: int) -> Optional[torch.Tensor]:
        z = noise(i)
        if z is not None:
            z = z.contiguous()
            mesh.broadcast(z)
        return z

    return rank0


def _reverse_step(s: Dict[str, float], xt: torch.Tensor, et: torch.Tensor,
                  d_prev: Optional[torch.Tensor], pred_type: str,
                  noise: Optional[torch.Tensor]):
    """One update from the (overlap-averaged) model output ``et``; returns
    (x_next, x0 estimate).  ``d_prev``: the previous step's x0 estimate
    (dpmpp2m only; zeros on the first step)."""
    if pred_type == "v":
        # v -> implied epsilon: affine per pixel in (v, x_t), so converting
        # after the overlap average equals averaging converted patches
        et = s["sqrt_1ma"] * xt + s["sqrt_a"] * et
    x0_t = (xt - et * s["sqrt_1ma"]) / s["sqrt_a"]
    if "em1" not in s:                       # DDIM
        x_next = s["sqrt_anx"] * x0_t
        if noise is not None:
            x_next = x_next + s["c1"] * noise
        return x_next + s["c2"] * et, x0_t
    d_tilde = (1 + s["c2"]) * x0_t - s["c2"] * d_prev
    return s["sig_ratio"] * xt - s["alpha_n"] * s["em1"] * d_tilde, x0_t


@torch.no_grad()
def ddim_sample(
    model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    x_cond: torch.Tensor,
    seq: np.ndarray,
    betas: torch.Tensor,
    *,
    eta: float = 0.0,
    generator: Optional[torch.Generator] = None,
    step_noise: Optional[torch.Tensor] = None,
    pred_type: str = "eps",
    solver: str = "ddim",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole-image reverse chain: ``model_fn([x_cond | x_t], t)`` at every
    step.  Returns (x_final, x0_preds) with x0_preds (T, B, C, H, W) in
    chain order (index -1 = the last step's estimate)."""
    _check_chain(solver, eta, pred_type)
    steps = _chain_steps(betas, seq, eta, solver)
    noise = _noise_source(eta, generator, step_noise, len(steps), x)
    # x0_t carries D_{i-1} for dpmpp2m
    xt, x0s = x, []
    x0_t = torch.zeros_like(x) if solver == "dpmpp2m" else None
    for i, s in enumerate(steps):
        t = torch.full((x.shape[0],), s["t"], dtype=torch.float32,
                       device=x.device)
        et = model_fn(torch.cat([x_cond, xt], dim=1), t)
        xt, x0_t = _reverse_step(s, xt, et, x0_t, pred_type, noise(i))
        x0s.append(x0_t)
    return xt, torch.stack(x0s)


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
    mesh: Optional[DataMesh] = None,
    x0_keep: Optional[int] = None,
    pred_type: str = "eps",
    solver: str = "ddim",
):
    """Build the tiled sampler for a fixed (h, w) geometry.

    The returned ``sample(x_init, x_cond, x_other=None, generator=None,
    step_noise=None, x_global=None)`` takes NCHW (B, pred, h, w),
    (B, Cc, h, w) and (B, Co, h, w) tensors and returns
    ``(x_final, x0_preds)``: x0_preds is (T, B, pred, h, w), or
    (1, B, pred, h, w) holding only step ``x0_keep`` when that is set.
    ``model_fn(x, t)`` maps (N, Cin, p, p) and (N,)
    float32 timesteps to the (N, pred, p, p) float32 output; with
    ``patch_micro_batch`` = mb > 0 it sees chunks of at most mb patches.
    With ``use_global``, ``sample`` also takes ``x_global`` (B, Cg, Hg, Wg)
    and the model is called as ``model_fn(x, t, x_global, index)``, where
    ``index`` (N,) holds the image of each of its N patches.  With a
    ``mesh`` of more than one rank, each rank's ``model_fn`` sees only its
    range of the patches (``index`` still the global image); a mesh of one
    takes the unsharded path.
    """
    if mesh is not None and not isinstance(mesh, DataMesh):
        raise ValueError(f"mesh must be a DataMesh, got {type(mesh)}")
    sharded = mesh is not None and mesh.size > 1
    _check_chain(solver, eta, pred_type)
    if patch_micro_batch < 0:
        raise ValueError("patch_micro_batch must be >= 0")
    h, w = image_shape
    p = patch_size
    corners = overlapping_grid_corners(h, w, p, grid_r)
    counts_np = _count_mask(corners, h, w, p)[None, None]
    steps = _chain_steps(betas, seq, eta, solver)
    keep_idx = None if x0_keep is None else x0_keep % len(steps)

    def gather(img: torch.Tensor) -> torch.Tensor:
        # (B, C, h, w) -> (B*K, C, p, p), image-major patch order
        pat = torch.stack([img[:, :, i:i + p, j:j + p] for i, j in corners], 1)
        return pat.reshape((-1,) + pat.shape[2:])

    def scatter_mean(et_p: torch.Tensor, b: int, counts: torch.Tensor,
                     lo: int = 0) -> torch.Tensor:
        # sum the estimates of patches lo.. back per image in corner order
        # (zeros for the other ranks' patches, then summed over the ranks),
        # normalize
        n = b * len(corners)
        if et_p.shape[0] != n:
            full = et_p.new_zeros((n,) + et_p.shape[1:])
            full[lo:lo + et_p.shape[0]] = et_p
            et_p = full
        et_b = et_p.reshape((b, len(corners)) + et_p.shape[1:])
        acc = et_p.new_zeros((b, et_p.shape[1], h, w))
        for k, (i, j) in enumerate(corners):
            acc[:, :, i:i + p, j:j + p] += et_b[:, k]
        if sharded:
            dist.all_reduce(acc, group=mesh.group)
        return acc / counts

    def apply_model(inp: torch.Tensor, t: float,
                    x_global: Optional[torch.Tensor],
                    lo: int = 0) -> torch.Tensor:
        # inp holds patches lo..lo+n-1 of the image-major order
        n = inp.shape[0]
        tt = torch.full((n,), t, dtype=torch.float32, device=inp.device)
        if use_global:
            index = (torch.arange(lo, lo + n, device=inp.device)
                     // len(corners))

            def call(sl):
                return model_fn(inp[sl], tt[sl], x_global, index[sl])
        else:
            def call(sl):
                return model_fn(inp[sl], tt[sl])
        mb = patch_micro_batch
        if not mb or n <= mb:
            return call(slice(None))
        return torch.cat([call(slice(s, s + mb)) for s in range(0, n, mb)])

    @torch.no_grad()
    def sample(x_init: torch.Tensor, x_cond: torch.Tensor,
               x_other: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               step_noise: Optional[torch.Tensor] = None,
               x_global: Optional[torch.Tensor] = None):
        b = x_init.shape[0]
        if use_global and (x_global is None or x_global.shape[0] != b):
            raise ValueError("use_global: sample needs x_global, one whole "
                             f"image for each of the {b} images")
        counts = torch.as_tensor(counts_np, device=x_init.device)
        noise = _noise_source(eta, generator, step_noise, len(steps), x_init)
        if sharded:
            noise = _broadcast_noise(noise, mesh)
            if b * len(corners) < mesh.size:        # every rank raises
                raise ValueError(f"{mesh.size} ranks for {b * len(corners)} "
                                 "patches: a rank would have none")
            lo, hi = mesh.span(b * len(corners))
            take = lambda img: gather(img)[lo:hi]   # noqa: E731
        else:
            lo, take = 0, gather
        cond_p = take(x_cond)
        static_p = [fft_condition(cond_p) if use_fft else cond_p]
        if use_other:
            static_p.append(take(x_other))
        xt, kept, x0s = x_init, None, []
        x0_t = torch.zeros_like(x_init) if solver == "dpmpp2m" else None
        for i, s in enumerate(steps):
            inp = torch.cat([static_p[0], take(xt)] + static_p[1:], dim=1)
            et_p = apply_model(inp, s["t"], x_global, lo)
            et = scatter_mean(et_p, b, counts, lo)
            xt, x0_t = _reverse_step(s, xt, et, x0_t, pred_type, noise(i))
            if keep_idx is None:
                x0s.append(x0_t)
            elif i == keep_idx:
                kept = x0_t
        return xt, (torch.stack(x0s) if keep_idx is None else kept[None])

    return sample
