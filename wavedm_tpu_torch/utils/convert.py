"""Carry weights across: JAX parameter trees -> the port's ``state_dict``.

The JAX package keeps its parameters as nested dicts of arrays (NHWC convs
with HWIO kernels, Dense kernels as (in, out)).  These functions are the
exact inverse of ``wavedm_tpu/utils/torch_compat.py``'s converters: conv
kernels go HWIO -> OIHW, Dense kernels (in, out) -> (out, in), and the keys
become the reference's, which the port's modules use.  Leaves may be numpy
arrays or anything ``np.asarray`` accepts.

:func:`load_torch_checkpoint` loads reference ``.pth``/``.pth.tar`` files.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

__all__ = ["unet_state_dict_from_flax", "unet_global_state_dict_from_flax",
           "lap_state_dict_from_flax", "hfrm_state_dict_from_flax",
           "wdnet_state_dict_from_flax", "rrdb_state_dict_from_flax",
           "sam_state_dict_from_flax",
           "discriminator_state_dict_from_flax",
           "vgg19_state_dict_from_flax", "load_torch_checkpoint"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(sd: Dict, key: str, p: Mapping) -> None:
    sd[f"{key}.weight"] = _t(np.transpose(np.asarray(p["kernel"]),
                                          (3, 2, 0, 1)))
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _dense(sd: Dict, key: str, p: Mapping) -> None:
    sd[f"{key}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (1, 0)))
    sd[f"{key}.bias"] = _t(p["bias"])


def _norm(sd: Dict, key: str, p: Mapping) -> None:
    sd[f"{key}.weight"] = _t(p["norm"]["scale"])
    sd[f"{key}.bias"] = _t(p["norm"]["bias"])


def _resnet_block(sd: Dict, key: str, p: Mapping) -> None:
    _norm(sd, f"{key}.norm1", p["norm1"])
    _conv(sd, f"{key}.conv1", p["conv1"])
    _dense(sd, f"{key}.temb_proj", p["temb_proj"])
    _norm(sd, f"{key}.norm2", p["norm2"])
    _conv(sd, f"{key}.conv2", p["conv2"])
    for name in ("nin_shortcut", "conv_shortcut"):
        if name in p:
            _conv(sd, f"{key}.{name}", p[name])


def _attn_block(sd: Dict, key: str, p: Mapping) -> None:
    _norm(sd, f"{key}.norm", p["norm"])
    for name in ("q", "k", "v", "proj_out"):
        _conv(sd, f"{key}.{name}", p[name])


def unet_state_dict_from_flax(params: Mapping, num_levels: int,
                              num_res_blocks: int) -> Dict[str, torch.Tensor]:
    """JAX ``DiffusionUNet`` params -> the port's (and the reference's)
    ``DiffusionUNet`` state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    _dense(sd, "temb.dense.0", params["temb"]["dense0"])
    _dense(sd, "temb.dense.1", params["temb"]["dense1"])
    _conv(sd, "conv_in", params["conv_in"])
    for i in range(num_levels):
        for j in range(num_res_blocks):
            _resnet_block(sd, f"down.{i}.block.{j}",
                          params[f"down_{i}_block_{j}"])
            if f"down_{i}_attn_{j}" in params:
                _attn_block(sd, f"down.{i}.attn.{j}",
                            params[f"down_{i}_attn_{j}"])
        if f"down_{i}_downsample" in params:
            _conv(sd, f"down.{i}.downsample.conv",
                  params[f"down_{i}_downsample"]["conv"])
    _resnet_block(sd, "mid.block_1", params["mid_block_1"])
    _attn_block(sd, "mid.attn_1", params["mid_attn_1"])
    _resnet_block(sd, "mid.block_2", params["mid_block_2"])
    for i in range(num_levels):
        for j in range(num_res_blocks + 1):
            _resnet_block(sd, f"up.{i}.block.{j}", params[f"up_{i}_block_{j}"])
            if f"up_{i}_attn_{j}" in params:
                _attn_block(sd, f"up.{i}.attn.{j}", params[f"up_{i}_attn_{j}"])
        if f"up_{i}_upsample" in params:
            _conv(sd, f"up.{i}.upsample.conv",
                  params[f"up_{i}_upsample"]["conv"])
    _norm(sd, "norm_out", params["norm_out"])
    _conv(sd, "conv_out", params["conv_out"])
    return sd


def _conv_transpose(sd: Dict, key: str, p: Mapping) -> None:
    # Flax's ConvTranspose convolves the zero-stuffed input with the kernel
    # as it is; torch's transposed conv uses it flipped, laid out (I, O)
    sd[f"{key}.weight"] = _t(np.transpose(
        np.asarray(p["kernel"])[::-1, ::-1], (2, 3, 0, 1)))
    sd[f"{key}.bias"] = _t(p["bias"])


def _attn_global(sd: Dict, key: str, p: Mapping) -> None:
    _norm(sd, f"{key}.norm_patch", p["norm_patch"])
    _norm(sd, f"{key}.norm_global", p["norm_global"])
    for name in ("q", "k", "v", "proj_out"):
        _conv(sd, f"{key}.{name}", p[name])


def unet_global_state_dict_from_flax(params: Mapping, num_levels: int,
                                     num_res_blocks: int
                                     ) -> Dict[str, torch.Tensor]:
    """JAX ``DiffusionUNetGlobal`` params -> the port's
    ``DiffusionUNetGlobal`` state_dict.

    The names are the port's (``models/unet_global.py``), made from JAX's:
    the original reference's ``.pth`` names for ``DiffusionUNet_Global`` are
    not in this repository to check against, and the JAX package's
    ``utils/torch_compat.py`` maps none either, so a reference checkpoint
    of that model does not load through these names."""
    sd = unet_state_dict_from_flax(params, num_levels, num_res_blocks)
    _conv(sd, "global_conv_in", params["global_conv_in"])
    for side in ("down", "up"):
        for i in range(num_levels):
            p = params.get(f"{side}_global_{i}_conv")
            if p is not None:
                (_conv if side == "down" else _conv_transpose)(
                    sd, f"{side}.{i}.global_conv", p)
            if f"{side}_global_{i}_proj" in params:
                _conv(sd, f"{side}.{i}.global_proj",
                      params[f"{side}_global_{i}_proj"])
            _attn_global(sd, f"{side}.{i}.global_attn",
                         params[f"{side}_global_{i}_attn"])
    return sd


def lap_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``LapHighTrans`` params -> the port's ``LapHighTrans``
    state_dict, whose module names are JAX's (``trans_high.res_0.conv1``
    for ``trans_high/res_0/conv1``)."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(prefix: str, p: Mapping) -> None:
        if "kernel" in p:
            _conv(sd, prefix, p)
            return
        for name, sub in p.items():
            walk(f"{prefix}.{name}" if prefix else name, sub)

    walk("", params)
    return sd


def _hfrm_block(sd: Dict, key: str, p: Mapping) -> None:
    for name in ("norm1", "norm2"):
        sd[f"{key}.{name}.weight"] = _t(p[name]["weight"])
        sd[f"{key}.{name}.bias"] = _t(p[name]["bias"])
    for name in ("conv1", "conv2", "conv3", "conv4", "conv5"):
        _conv(sd, f"{key}.{name}", p[name])
    _conv(sd, f"{key}.channel_attn.chan_conv", p["channel_attn"]["chan_conv"])
    sd[f"{key}.beta"] = _t(p["beta"]).reshape(1, -1, 1, 1)
    sd[f"{key}.gamma"] = _t(p["gamma"]).reshape(1, -1, 1, 1)


def hfrm_state_dict_from_flax(params: Mapping, enc_blk_nums, mid_blk_num: int,
                              dec_blk_nums) -> Dict[str, torch.Tensor]:
    """JAX ``HFRM`` params -> the port's (and the reference's) HFRM
    state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "conv_in", params["conv_in"])
    for li, num in enumerate(enc_blk_nums):
        for bi in range(num):
            _hfrm_block(sd, f"encoders.{li}.{bi}", params[f"enc_{li}_{bi}"])
        _conv(sd, f"downs.{li}", params[f"down_{li}"])
    for bi in range(mid_blk_num):
        _hfrm_block(sd, f"mid_blks.{bi}", params[f"mid_{bi}"])
    for li, num in enumerate(dec_blk_nums):
        _conv(sd, f"ups.{li}.0", params[f"up_{li}"])
        for bi in range(num):
            _hfrm_block(sd, f"decoders.{li}.{bi}", params[f"dec_{li}_{bi}"])
    _conv(sd, "conv_out", params["conv_out"])
    return sd


def _rdb(sd: Dict, key: str, p: Mapping) -> None:
    for k in range(1, 6):
        _conv(sd, f"{key}.conv{k}.0", p[f"conv{k}"])


def wdnet_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``WDNet`` params -> the port's (and the reference's) ``WDNet``
    state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "xbranch.0.0", params["xbranch"])
    _conv(sd, "cascade1.0", params["cascade1_conv1"])
    _conv(sd, "cascade1.2", params["cascade1_conv2"])
    i = 0
    while f"dmdb_{i}" in params:
        p, key = params[f"dmdb_{i}"], f"cascade2.{i}"
        _rdb(sd, f"{key}.RDB1", p["rdb1"])
        _rdb(sd, f"{key}.RDB2", p["rdb2"])
        _conv(sd, f"{key}.deli.0", p["deli"])
        _conv(sd, f"{key}.deli2.0", p["deli2"])
        i += 1
    _conv(sd, "final.0.0", params["final"])
    return sd


def sam_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``SAM`` params -> the port's (and the reference's) ``SAM``
    state_dict.  JAX builds no ``conv_in``, which the reference never
    applies: it comes out zero."""
    sd: Dict[str, torch.Tensor] = {}
    for name in ("conv1", "conv2", "conv3", "conv_out"):
        _conv(sd, name, params[name])
    k = np.asarray(params["conv1"]["kernel"])
    sd["conv_in.weight"] = torch.zeros(k.shape[3], k.shape[2], 3, 3)
    for name in ("irnn1", "irnn2"):
        for wname, w in params[name].items():
            sd[f"{name}.{wname}"] = _t(w).reshape(())
    if "attention_layer" in params:
        a = params["attention_layer"]
        _conv(sd, "attention_layer.conv3", a["conv3"])
        _conv(sd, "attention_layer.ca.fc1", a["ca"]["fc1"])
        _conv(sd, "attention_layer.ca.fc2", a["ca"]["fc2"])
        _conv(sd, "attention_layer.sa.conv1", a["sa"]["conv1"])
    return sd


def rrdb_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``RRDB`` params -> the port's ``RRDB`` state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for i in (1, 2, 3):
        _rdb(sd, f"RDB{i}", params[f"rdb{i}"])
    _conv(sd, "deli.0", params["deli"])
    for k, v in sam_state_dict_from_flax(params["sam1"]).items():
        sd[f"sam1.{k}"] = v
    return sd


def discriminator_state_dict_from_flax(params: Mapping
                                       ) -> Dict[str, torch.Tensor]:
    """JAX ``Discriminator`` params -> the port's PatchGAN
    ``Discriminator`` (``model.{0,2,5,8,12}``) state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for i, idx in enumerate((0, 2, 5, 8)):
        _conv(sd, f"model.{idx}", params[f"block_{i}_conv"])
    _conv(sd, "model.12", params["conv_out"])
    return sd


# torchvision features index of each conv of VGG19, up to conv5_2
_VGG_CONVS = (("conv1_1", 0), ("conv1_2", 2), ("conv2_1", 5), ("conv2_2", 7),
              ("conv3_1", 10), ("conv3_2", 12), ("conv3_3", 14),
              ("conv3_4", 16), ("conv4_1", 19), ("conv4_2", 21),
              ("conv4_3", 23), ("conv4_4", 25), ("conv5_1", 28),
              ("conv5_2", 30))


def vgg19_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``VGG19Features`` params -> the port's ``VGG19Features``
    (torchvision's ``features.{i}``) state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for name, idx in _VGG_CONVS:
        _conv(sd, f"features.{idx}", params[name])
    return sd


def load_torch_checkpoint(path: str, ema: bool = False,
                          pred_type: Optional[str] = None
                          ) -> Dict[str, torch.Tensor]:
    """A reference ``.pth``/``.pth.tar`` file -> its state_dict on the CPU.

    ``ema=True`` returns the EMA shadow (``obj['ema_helper']``, same keys
    as ``state_dict``: the reference registers its EMAHelper on the
    unwrapped module).  ``pred_type``: raise unless the file was trained
    with it; the port's checkpoints record it, and a file without the key
    (the reference's) counts as ``"eps"``."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if pred_type is not None:
        saved = obj.get("pred_type", "eps") if isinstance(obj, dict) else "eps"
        if saved != pred_type:
            raise ValueError(
                f"checkpoint {path} was trained with pred_type={saved!r}, "
                f"the config says {pred_type!r}")
    if ema:
        if not (isinstance(obj, dict) and "ema_helper" in obj):
            raise KeyError(f"checkpoint {path} has no 'ema_helper' entry")
        return dict(obj["ema_helper"])
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return dict(obj)
