"""WDNet, the legacy wavelet-demoireing stack, on NCHW tensors.

The port of ``wavedm_tpu/models/wdnet.py``: ``SEBlock``,
``ResidualDenseBlock5C``, ``DMDB2``, ``RRDB``, ``WDNet`` and the PatchGAN
``Discriminator`` that stage 1's GAN term trains (``hfrm.use_gan``).  The
key names are the reference's, so its state_dicts load as they stand
(``tests/golden/wdnet_small.npz``): each conv sits in a ``conv_block``
``nn.Sequential`` with its activation (``cascade2.{i}.RDB1.conv{k}.0``),
``final`` and ``xbranch`` in one more (``final.0.0``).  The reference's
TF-style same padding equals ``padding = dilation * (k - 1) / 2`` for its
odd kernels.  The Discriminator is the pix2pix PatchGAN layout
(``model.{0,2,5,8,12}``), which JAX's parameter tree maps onto in order.
The identity-centre init lives in ``models/hfrm.py``
(:func:`identity_center_init_`), where stage 1 uses it.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["SEBlock", "ResidualDenseBlock5C", "DMDB2", "RRDB", "WDNet",
           "Discriminator", "DILATIONS"]

DILATIONS = (1, 2, 5, 7, 12, 19, 31)


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def _conv(cin: int, cout: int, k: int, dilation: int = 1,
          act: bool = True) -> nn.Sequential:
    """The reference's ``conv_block``: a same-padded conv, then LeakyReLU
    (0.2) unless ``act`` is off."""
    layers = [nn.Conv2d(cin, cout, k, padding=dilation * (k - 1) // 2,
                        dilation=dilation)]
    if act:
        layers.append(nn.LeakyReLU(0.2))
    return nn.Sequential(*layers)


class SEBlock(nn.Module):
    """Squeeze-excite through a bottleneck of ``reduction`` units (not
    channels / reduction: the reference's quirk)."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Linear(channels, reduction)
        self.fc2 = nn.Linear(reduction, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.sigmoid(self.fc2(F.relu(self.fc1(x.mean(dim=(2, 3))))))
        return x * y[:, :, None, None]


class ResidualDenseBlock5C(nn.Module):
    """Five densely connected 3x3 convs, the output scaled by 0.2."""

    def __init__(self, nc: int = 64, gc: int = 32):
        super().__init__()
        for k in range(1, 5):
            setattr(self, f"conv{k}", _conv(nc + (k - 1) * gc, gc, 3))
        self.conv5 = _conv(nc + 4 * gc, nc, 3, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        for k in range(1, 5):
            feats.append(getattr(self, f"conv{k}")(torch.cat(feats, dim=1)))
        return self.conv5(torch.cat(feats, dim=1)) * 0.2


class DMDB2(nn.Module):
    """Two RDBs beside a dilated shortcut branch."""

    def __init__(self, nc: int = 64, gc: int = 32, dilation: int = 1):
        super().__init__()
        self.RDB1 = ResidualDenseBlock5C(nc, gc)
        self.RDB2 = ResidualDenseBlock5C(nc, gc)
        self.deli = _conv(nc, nc, 3, dilation)
        self.deli2 = _conv(nc, nc, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out2 = self.RDB2(self.RDB1(x) + x)
        d = self.deli(x)
        return out2 * 0.2 + d + 0.2 * self.deli2(d)


class RRDB(nn.Module):
    """Residual-in-residual dense block, never instantiated by the
    reference: three RDBs with running residual adds, ``out3 * 0.2 +
    deli(x)``, and a ``SAM(64, 2)`` whose call the reference comments out
    (built here for its parameters, never applied)."""

    def __init__(self, nc: int = 64, gc: int = 32, dilation: int = 1):
        super().__init__()
        from wavedm_tpu_torch.models.sam import SAM

        self.RDB1 = ResidualDenseBlock5C(nc, gc)
        self.RDB2 = ResidualDenseBlock5C(nc, gc)
        self.RDB3 = ResidualDenseBlock5C(nc, gc)
        self.deli = _conv(nc, nc, 3, dilation)
        self.sam1 = SAM(64, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.RDB1(x) + x
        out = self.RDB2(out) + out
        out = self.RDB3(out) + out
        return out * 0.2 + self.deli(x)


class WDNet(nn.Module):
    """(B, 48, h, w) wavelet bands -> 48 bands: a 1x1 and a 3x3 conv, seven
    DMDB2 blocks at dilations ``DILATIONS``, a 1x1 conv.  ``xbranch``
    exists in the reference but its forward never uses it."""

    def __init__(self, in_channel: int = 3):
        super().__init__()
        self.xbranch = nn.Sequential(_conv(in_channel, 64, 3))
        self.cascade1 = nn.Sequential(
            nn.Conv2d(48, 64, 1), nn.LeakyReLU(0.2),
            nn.Conv2d(64, 64, 3, padding=1), nn.LeakyReLU(0.2))
        self.cascade2 = nn.Sequential(*[DMDB2(64, 32, d) for d in DILATIONS])
        self.final = nn.Sequential(_conv(64, 48, 1, act=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.final(self.cascade2(self.cascade1(x)))


class Discriminator(nn.Module):
    """Conditional PatchGAN: (B, 3, H, W) pair -> (B, 1, H/16, W/16)
    scores in (0, 1); InstanceNorm without affine after all but the first
    conv."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        layers, cin = [], 2 * in_channels
        for cout, norm in ((64, False), (128, True), (256, True),
                           (512, True)):
            layers.append(nn.Conv2d(cin, cout, 4, stride=2, padding=1))
            if norm:
                layers.append(nn.InstanceNorm2d(cout))
            layers.append(nn.LeakyReLU(0.2))
            cin = cout
        layers += [nn.ZeroPad2d((1, 0, 1, 0)),
                   nn.Conv2d(512, 1, 4, padding=1, bias=False), nn.Sigmoid()]
        self.model = nn.Sequential(*layers)

    def forward(self, img_a: torch.Tensor,
                img_b: torch.Tensor) -> torch.Tensor:
        return self.model(torch.cat([img_a, img_b], dim=1))
