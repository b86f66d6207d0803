"""The work a cell does, counted on the benchmark's own reference model.

``torch.utils.flop_counter.FlopCounterMode`` counts the dense FLOPs of
every convolution, matmul and their backward passes (2 per multiply-add)
while the reference runs on the ``meta`` device at the cell's shapes, so
nothing is computed and the count is the same whatever kernels the
program runs.  Elementwise work, norms and the optimizer count 0.
``conv`` is the part of ``total`` in convolutions (forward and backward).
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference.hfrm import HFRM
from portbench.reference.precision import Prec
from portbench.reference.train import eps_loss, wavelet_batch
from portbench.reference.unet import UNet
from portbench.reference.wavelet import dwt, iwt

__all__ = ["Work", "count", "unet_forward", "restore_call", "train_step"]

META = torch.device("meta")


class Work(dict):
    """{"total": FLOPs, "conv": FLOPs in convolutions}."""

    def __add__(self, other: "Work") -> "Work":
        return Work({k: self[k] + other[k] for k in self})

    def __mul__(self, n: int) -> "Work":
        return Work({k: self[k] * n for k in self})


def count(fn) -> Work:
    mode = FlopCounterMode(display=False)
    with mode:
        fn()
    by_op = mode.get_flop_counts().get("Global", {})
    conv = sum(v for op, v in by_op.items() if "convolution" in str(op))
    return Work(total=float(mode.get_total_flops()), conv=float(conv))


def _models(cfg: dict, hfrm: bool):
    with torch.device(META):
        unet = UNet.from_config(cfg)
        return unet, (HFRM.from_config(cfg) if hfrm else None)


def unet_forward(cfg: dict, n: int) -> Work:
    """One UNet call on ``n`` patches."""
    unet, _ = _models(cfg, False)
    p = cfg["data"]["image_size"]
    cin = unet.conv_in.weight.shape[1]
    x = torch.empty(n, cin, p, p, device=META)
    t = torch.zeros(n, device=META)
    with torch.no_grad():
        return count(lambda: unet.run(Prec(), x, t))


def restore_call(cfg: dict, batch: int, height: int, width: int,
                 patches_per_image: int) -> Work:
    """One restore of ``batch`` images: the HFRM, the entry and exit
    transforms and every step's UNet call on all the patches."""
    _, hfrm = _models(cfg, True)
    img = torch.empty(batch, 3, height, width, device=META)
    steps = cfg["sampling"]["sampling_timesteps"]

    def prep():
        dwt(img)
        dwt(hfrm.run(Prec(), img))
        iwt(torch.empty(batch, 48, height // 4, width // 4, device=META))

    with torch.no_grad():
        edges = count(prep)
    return edges + unet_forward(cfg, batch * patches_per_image) * steps


def train_step(cfg: dict, batch: int, size: int) -> Work:
    """One training step on ``batch`` crops of ``size`` pixels: the batch's
    transforms (and the frozen HFRM where the configuration conditions on
    it), the UNet's forward and backward."""
    m = cfg["model"]
    unet, hfrm = _models(cfg, not m["use_gt_in_train"])
    crops = torch.empty(batch, size, size, 6, device=META)
    t = torch.zeros(batch, dtype=torch.long, device=META)
    e = torch.empty(batch, m["pred_channels"], size // 4, size // 4,
                    device=META)

    def step():
        x0 = wavelet_batch(cfg, crops, hfrm, Prec())
        eps_loss(cfg, unet, Prec(), x0, t, e).backward()

    return count(step)
