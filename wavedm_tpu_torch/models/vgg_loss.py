"""VGG19 perceptual-loss features on NCHW tensors.

The port of ``wavedm_tpu/models/vgg_loss.py``: torchvision's
``vgg19().features`` stack built layer by layer (the card's machine has no
torchvision), with its ``features.{i}`` key names, truncated at relu5_2
(index 31), returning the relu taps after the second conv of each stage
(relu1_2, relu2_2, relu3_2, relu4_2, relu5_2 at indices 3, 8, 13, 22,
31).  :func:`perceptual_loss` sums the L1 distances of the taps over the
reference's per-layer divisors.  Inputs are [0, 255] images with no
ImageNet normalisation, as the reference feeds them.

A torchvision ``vgg19`` ``state_dict`` (``hfrm.vgg_ckpt``) loads through
:func:`vgg19_features_state_dict`; without one the features are random,
as they are in JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn as nn

__all__ = ["VGG19Features", "perceptual_loss", "vgg19_features_state_dict",
           "PERCEPTUAL_DIVISORS", "TAPS"]

# (out_channels, convs) of each stage, a 2x2 max pool between stages
_STAGES = ((64, 2), (128, 2), (256, 4), (512, 4), (512, 4))
TAPS = ("relu1", "relu2", "relu3", "relu4", "relu5")
PERCEPTUAL_DIVISORS = (2.6, 4.8, 3.7, 5.6, 5.6)
# torchvision's features index of each tap; the stack ends at relu5_2
_TAP_AT = dict(zip((3, 8, 13, 22, 31), TAPS))


class VGG19Features(nn.Module):
    """(B, 3, H, W) -> {tap name: (B, C, H / 2**s, W / 2**s)}."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for width, convs in _STAGES:
            for _ in range(convs):
                layers += [nn.Conv2d(cin, width, 3, padding=1), nn.ReLU()]
                cin = width
            layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers[:max(_TAP_AT) + 1])

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        taps = {}
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in _TAP_AT:
                taps[_TAP_AT[i]] = x
        return taps


def perceptual_loss(feats_fake: Mapping[str, torch.Tensor],
                    feats_real: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sum over the taps of mean|fake - real| / divisor."""
    return sum(torch.mean(torch.abs(feats_fake[name] - feats_real[name]))
               / div for name, div in zip(TAPS, PERCEPTUAL_DIVISORS))


def vgg19_features_state_dict(sd: Mapping) -> Dict[str, torch.Tensor]:
    """A torchvision ``vgg19`` state_dict (numpy or torch values) ->
    :class:`VGG19Features`'s: the ``features.{i}`` convs up
    to relu5_2, as float32 tensors; the rest (conv5_3, conv5_4, the
    classifier) is dropped, as JAX's ``convert_vgg19_features`` drops
    it."""
    keep = {f"features.{i}.{p}" for i in range(max(_TAP_AT))
            for p in ("weight", "bias")}
    return {k: torch.as_tensor(v, dtype=torch.float32)
            for k, v in sd.items() if k in keep}
