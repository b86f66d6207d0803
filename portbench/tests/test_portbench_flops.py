"""The benchmark's FLOP count (``lib/flops.py``, on its own reference)
against the port's work counter (``utils/work.count_work``)."""

import json

import torch

from portbench import registry
from portbench.lib import flops
from portbench_tiny import F32, TINY
from wavedm_tpu_torch.config import apply_overrides, config_from_dict
from wavedm_tpu_torch.models.unet import DiffusionUNet
from wavedm_tpu_torch.utils.work import count_work


def _raw(name, extra=()):
    raw = json.loads(json.dumps(registry.config(name)["config"]))
    return apply_overrides(raw, list(extra))


def _port_forward(raw, n):
    cfg = config_from_dict(json.loads(json.dumps(raw)))
    p = raw["data"]["image_size"]
    with torch.device("meta"):
        unet = DiffusionUNet.from_config(cfg)
        x = torch.empty(n, unet.conv_in.weight.shape[1], p, p)
    with torch.no_grad():
        return count_work(unet, x, torch.zeros(n, device="meta")).flops


def test_a_90_patch_forward_is_7195_tflop():
    raw = _raw("wavedm_wavelet_prod")
    work = flops.unet_forward(raw, 90)
    assert work["total"] == 7195027046400
    assert work["total"] == _port_forward(raw, 90)
    assert 0.99 < work["conv"] / work["total"] < 1.0


def test_counts_agree_at_a_small_size():
    raw = _raw("wavedm_wavelet_prod", TINY + F32)
    assert flops.unet_forward(raw, 6)["total"] == _port_forward(raw, 6)


def test_a_restore_call_is_its_parts():
    raw = _raw("wavedm_wavelet_prod")
    call = flops.restore_call(raw, 8, 480, 720, 45)
    unet = flops.unet_forward(raw, 360)["total"] * 10
    assert unet < call["total"] < 1.01 * unet
    assert abs(call["total"] / 8e12 - 36.09) < 0.01


def test_train_steps_count_forward_and_backward():
    prod = flops.train_step(_raw("wavedm_wavelet_prod"), 16, 256)
    ref = flops.train_step(_raw("wavedm_wavelet_ref"), 8, 256)
    fwd = flops.unet_forward(_raw("wavedm_wavelet_ref"), 8)["total"]
    # the backward is twice the forward, but for conv_in's input gradient
    # (the batch takes none)
    assert 2.98 < ref["total"] / fwd < 3.0
    assert abs(prod["total"] / 1e12 - 4.180) < 1e-3
    assert abs(ref["total"] / 1e12 - 1.912) < 1e-3
