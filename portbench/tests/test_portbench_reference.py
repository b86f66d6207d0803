"""The plain reference against the port's plain float32 route on the CPU,
at a small size: each model alone on the same weights, then a whole
restore and a whole train step through the harness."""

import json

import pytest
import torch

from portbench import registry
from portbench.lib.weights import make_weights, reference, seeded
from portbench.reference.precision import Prec
from portbench.reference.wavelet import dwt, iwt
from portbench_tiny import F32, TINY, tiny_run
from wavedm_tpu_torch.config import apply_overrides, config_from_dict
from wavedm_tpu_torch.inference.loader import build_hfrm, build_unet
from wavedm_tpu_torch.ops.wavelet_plain import (wavelet_dec_plain,
                                                wavelet_rec_plain)


@pytest.fixture
def tiny_raw():
    raw = registry.config("wavedm_wavelet_prod")["config"]
    return apply_overrides(json.loads(json.dumps(raw)), TINY + F32)


def test_wavelet_matches_the_port():
    x = torch.randn(2, 3, 16, 24, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(dwt(x), wavelet_dec_plain(x, 2))
    z = torch.randn(2, 48, 4, 6, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(iwt(z), wavelet_rec_plain(z, 2))
    torch.testing.assert_close(iwt(dwt(x)), x, atol=1e-6, rtol=0)


def test_models_match_the_port(tiny_raw):
    cfg = config_from_dict(json.loads(json.dumps(tiny_raw)))
    unet, hfrm = reference(tiny_raw, 7, "cpu", True)
    sd_u, sd_h = seeded(tiny_raw, 7, "cpu", True)
    port_u = build_unet(cfg, sd_u, "cpu")
    port_h = build_hfrm(cfg, sd_h, "cpu")
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, port_u.conv_in.weight.shape[1], 8, 8, generator=g)
    t = torch.tensor([0.0, 30.0, 270.0, 999.0])
    img = torch.rand(2, 3, 32, 48, generator=g)
    with torch.no_grad():
        torch.testing.assert_close(unet.run(Prec(), x, t), port_u(x, t),
                                   atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(hfrm.run(Prec(), img), port_h(img),
                                   atol=1e-5, rtol=1e-5)


def test_weights_are_the_seeds(tiny_raw):
    unet, _ = reference(tiny_raw, 11, "cpu", False)
    again = make_weights(unet, 11, "unet", "cpu")
    other = make_weights(unet, 12, "unet", "cpu")
    for name, p in unet.named_parameters():
        assert torch.equal(p.detach(), again[name])
    assert not torch.equal(again["conv_in.weight"], other["conv_in.weight"])
    hfrm_sd = seeded(tiny_raw, 11, "cpu", True)[1]
    assert float(hfrm_sd["encoders.0.0.beta"].abs().max()) > 0.1


def test_a_restore_matches_the_port():
    r = tiny_run("restore_prod_b8", F32)
    assert r["correct"]
    assert r["checked"]["img_rms_gap"]["value"] < 1e-6
    assert r["checked"]["img_max_gap"]["value"] < 1e-5


def test_a_train_step_matches_the_port():
    r = tiny_run("train_ref_b8")
    assert r["correct"]
    assert r["checked"]["loss_gap"]["value"] < 1e-6
    assert r["checked"]["grad_gap"]["value"] < 1e-5
    assert r["checked"]["change_gap"]["value"] < 1e-4
    assert r["checked"]["ema_gap"]["value"] < 0.05


def test_the_png_reader_matches_pil():
    import glob
    import os

    import numpy as np
    from PIL import Image

    from portbench.lib.images import decode_png

    paths = sorted(glob.glob(os.path.join(
        registry.REPO, "data", "raindrop", "raindrop_test", "*", "*.png")))
    assert len(paths) == 16
    for p in paths:
        with open(p, "rb") as f:
            got = decode_png(f.read())
        assert np.array_equal(got, np.asarray(Image.open(p).convert("RGB")))
