"""WaveDM's stage-2 training step, in float32: the wavelet batch, the
epsilon loss and Adam.

For (B, P, P, 6) [degraded | clean] crops in [0, 1], timesteps t (B,) and
noise e (B, 3, P/4, P/4):

  cond = DWT(2 x_deg - 1), clean = DWT(2 x_clean - 1)
  hf   = clean[:, 3:], or DWT(2 HFRM(x_deg) - 1)[:, 3:] where the
         configuration conditions on the frozen HFRM
  x_t  = sqrt(abar(t)) clean[:, :3] + sqrt(1 - abar(t)) e
  loss = mean over the batch of sum over pixels of (e - UNet([cond | x_t |
         hf], t))^2

then Adam (torch's formula: bias-corrected moments, eps outside the
square root, no weight decay) over every UNet parameter, and, where the
configuration keeps one (``model.ema``), the EMA of the parameters,
ema <- mu ema + (1 - mu) params after each step (mu = ``model.ema_rate``,
the shadow starting at the weights), held in float64 so that it carries
no rounding of its own.  abar as in ``sampler.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from portbench.reference.hfrm import HFRM
from portbench.reference.precision import Prec
from portbench.reference.sampler import alpha_bars
from portbench.reference.unet import UNet
from portbench.reference.wavelet import dwt

__all__ = ["wavelet_batch", "eps_loss", "run_steps"]


def wavelet_batch(cfg: dict, crops: torch.Tensor, hfrm: Optional[HFRM],
                  prec: Prec) -> torch.Tensor:
    """(B, P, P, 6) crops -> (B, 96, P/4, P/4) [cond | clean LL | hf]."""
    x = crops.permute(0, 3, 1, 2)
    cond, clean = dwt(2.0 * x[:, :3] - 1.0), dwt(2.0 * x[:, 3:] - 1.0)
    m = cfg["model"]
    if m["use_gt_in_train"]:
        hf = clean[:, m["other_channels_begin"]:]
    else:
        with torch.no_grad():
            hf = dwt(2.0 * hfrm.run(prec, x[:, :3].contiguous()) - 1.0)
        hf = hf[:, m["other_channels_begin"]:]
    return torch.cat([cond, clean[:, :m["pred_channels"]], hf], dim=1)


def eps_loss(cfg: dict, unet: UNet, prec: Prec, x0: torch.Tensor,
             t: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    m = cfg["model"]
    ci, pc = m["in_channels"], m["pred_channels"]
    a = alpha_bars(cfg).to(x0.device)[t + 1][:, None, None, None]
    xt = x0[:, ci:ci + pc] * a.sqrt() + e * (1.0 - a).sqrt()
    inp = torch.cat([x0[:, :ci], xt, x0[:, ci + pc:]], dim=1)
    out = unet.run(prec, inp, t.float())
    return (e - out).square().sum(dim=(1, 2, 3)).mean()


def run_steps(cfg: dict, unet: UNet, hfrm: Optional[HFRM],
              crops: Sequence[torch.Tensor], ts: Sequence[torch.Tensor],
              es: Sequence[torch.Tensor], prec: Prec = Prec()
              ) -> Dict[str, object]:
    """Train ``unet`` in place for len(crops) steps.  Returns each step's
    ``loss``, the first step's gradient norm of each parameter
    (``grad``), the norm of each parameter's change over all the steps
    (``change``), the norm of each parameter at the start (``norm``) and,
    where the configuration keeps an EMA, the norm of each parameter's
    EMA change over the steps (``ema``)."""
    o = cfg["optim"]
    b1, b2, lr, eps = o["beta1"], o["beta2"], o["lr"], o["eps"]
    mu = cfg["model"]["ema_rate"] if cfg["model"]["ema"] else None
    names = [n for n, _ in unet.named_parameters()]
    params = [p for _, p in unet.named_parameters()]
    start = [p.detach().clone() for p in params]
    shadow = [] if mu is None else [p.double() for p in start]
    mom = [torch.zeros_like(p) for p in params]
    sq = [torch.zeros_like(p) for p in params]
    losses: List[float] = []
    grad: Dict[str, float] = {}
    for k, (x, t, e) in enumerate(zip(crops, ts, es), start=1):
        loss = eps_loss(cfg, unet, prec, wavelet_batch(cfg, x, hfrm, prec),
                        t, e)
        grads = torch.autograd.grad(loss, params)
        losses.append(float(loss.detach()))
        if k == 1:
            grad = {n: float(g.norm()) for n, g in zip(names, grads)}
        with torch.no_grad():
            c1, c2 = 1.0 - b1 ** k, 1.0 - b2 ** k
            for p, g, m1, m2 in zip(params, grads, mom, sq):
                m1.mul_(b1).add_(g, alpha=1.0 - b1)
                m2.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                p.sub_(lr / c1 * m1 / (m2.sqrt() / c2 ** 0.5 + eps))
            for p, s in zip(params, shadow):
                s.mul_(mu).add_(p.double(), alpha=1.0 - mu)
    out = dict(loss=losses, grad=grad,
               change={n: float((p.detach() - s).norm())
                       for n, p, s in zip(names, params, start)},
               norm={n: float(s.norm()) for n, s in zip(names, start)})
    if mu is not None:
        out["ema"] = {n: float((sh - s.double()).norm())
                      for n, sh, s in zip(names, shadow, start)}
    return out
