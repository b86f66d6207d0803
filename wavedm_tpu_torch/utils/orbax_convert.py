"""The JAX package's Orbax checkpoints -> the port's checkpoint files.

``wavedm_tpu/utils/checkpoint.py:save_checkpoint`` writes a directory: an
Orbax tree of ``params``, ``opt_state``, ``ema``, ``step`` and ``rng``, and
``wavedm_meta.json`` (``epoch`` and the trainer's extra scalars).
:func:`convert_orbax_checkpoint` reads one (orbax is imported inside, so
this module imports where orbax is absent; the conversion itself runs on a
host that has it) and writes the file ``utils/checkpoint.py`` writes,
which ``build_restorer``, ``build_hfrm``, ``DiffusionTrainer.resume`` and
``HFRMTrainer.resume`` load:

- weights: a diffusion UNet's params and EMA through
  ``unet_state_dict_from_flax`` (``unet_global_state_dict_from_flax`` for
  the global-attention UNet of ``data.global_attn``), a stage-1 HFRM's
  params through ``hfrm_state_dict_from_flax`` (it keeps no EMA).  The
  parameter tree says which it is; any other tree raises, as does one
  whose shapes differ from the model the config builds, or a global tree
  under a config without ``data.global_attn`` (and the reverse).
- the Laplacian path's translator (``data.lap``; JAX checkpoints it as
  the extra tree ``lap``): its params through
  ``lap_state_dict_from_flax`` and its Adam moments the same way, under
  the file's ``lap`` entry that ``DiffusionTrainer.resume`` reads.
- stage 1's discriminator (``hfrm.use_gan``; the extra tree ``disc``): its
  params through ``discriminator_state_dict_from_flax``, its Adam moments
  the same way and its step, under the file's ``disc`` entry that
  ``HFRMTrainer.resume`` reads.
- optimizer: each moment tree goes through the same layout transform as
  the weights into the torch optimizer's ``state_dict``, indexed in
  ``named_parameters()`` order, with the config's hyperparameters:
  optax ``scale_by_adam`` (``mu`` -> ``exp_avg``, ``nu`` ->
  ``exp_avg_sq``, ``count`` -> ``step``), the JAX package's torch-exact
  amsgrad (also ``nu_max`` -> ``max_exp_avg_sq``), RMSProp (``nu`` ->
  ``square_avg``; ``step`` from the train state) and SGD's momentum
  (``trace`` -> ``momentum_buffer``).  A state the mapping cannot carry,
  or one that disagrees with the config's optimizer, raises naming it; no
  file is written without the optimizer's moments.
- metadata: ``step`` from the tree, ``epoch`` and the extra scalars
  (``best_psnr``) from the meta file, ``pred_type`` from the config (JAX
  checkpoints record none; the port's loaders check it).
- generator: a JAX PRNG key cannot become a torch generator's state, so
  the file carries ``training.seed`` in its place and ``load_checkpoint``
  seeds the generator with it: a resumed run draws other t and noise than
  JAX's would have.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch

from wavedm_tpu_torch.config import Config
from wavedm_tpu_torch.models.hfrm import HFRM
from wavedm_tpu_torch.models.unet import DiffusionUNet
from wavedm_tpu_torch.models.unet_global import DiffusionUNetGlobal
from wavedm_tpu_torch.models.wdnet import Discriminator
from wavedm_tpu_torch.training.hfrm_trainer import make_hfrm_optimizer
from wavedm_tpu_torch.training.lap import make_lap_model, make_lap_optimizer
from wavedm_tpu_torch.training.state import make_optimizer
from wavedm_tpu_torch.utils.checkpoint import write_checkpoint
from wavedm_tpu_torch.utils.convert import (discriminator_state_dict_from_flax,
                                            hfrm_state_dict_from_flax,
                                            lap_state_dict_from_flax,
                                            unet_global_state_dict_from_flax,
                                            unet_state_dict_from_flax)

__all__ = ["read_orbax_checkpoint", "checkpoint_kind",
           "convert_orbax_checkpoint"]

META_FILE = "wavedm_meta.json"


def _plain(tree):
    """Orbax's restored tree (optax's namedtuple states come back as dicts,
    its ``chain`` as a list) as dicts, lists, None and numpy leaves."""
    if isinstance(tree, Mapping):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    return None if tree is None else np.asarray(tree)


def read_orbax_checkpoint(path: str) -> Tuple[Dict, Dict]:
    """(tree, meta) of the checkpoint directory ``path``."""
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"{path}: not an Orbax checkpoint directory")
    tree = _plain(ocp.PyTreeCheckpointer().restore(path))
    meta_path = os.path.join(path, META_FILE)
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return tree, meta


def checkpoint_kind(params: Mapping) -> str:
    """``"unet"`` or ``"hfrm"`` from the top level of a parameter tree."""
    keys = set(params)
    if {"temb", "conv_in", "conv_out", "mid_block_1"} <= keys:
        return "unet"
    if {"conv_in", "conv_out", "enc_0_0", "down_0", "up_0"} <= keys:
        return "hfrm"
    raise ValueError(
        "not a checkpoint of the diffusion UNet or of HFRM: its parameter "
        f"tree's top level is {sorted(keys)[:8]}")


def _model(kind: str, cfg: Config):
    """(the model on the meta device, params tree -> its state_dict)."""
    with torch.device("meta"):
        if kind == "unet":
            m = cfg.model
            if cfg.data.global_attn:
                return (DiffusionUNetGlobal.from_config(
                    cfg, keep_f32_params=True),
                    lambda p: unet_global_state_dict_from_flax(
                        p, len(m.ch_mult), m.num_res_blocks))
            return (DiffusionUNet.from_config(cfg, keep_f32_params=True),
                    lambda p: unet_state_dict_from_flax(
                        p, len(m.ch_mult), m.num_res_blocks))
        h = cfg.hfrm
        return (HFRM.from_config(cfg, keep_f32_params=True),
                lambda p: hfrm_state_dict_from_flax(
                    p, h.enc_blk_nums, h.middle_blk_num, h.dec_blk_nums))


def _moments(opt_state) -> Dict:
    """The one moment-carrying entry of an optax state (a ``chain``'s
    list, possibly nested), as a dict; raises for any other."""
    found: List[Dict] = []

    def walk(s):
        if s is None:
            return
        if isinstance(s, list):
            for item in s:
                walk(item)
            return
        keys = set(s)
        if not keys or keys == {"count"}:    # empty states, schedule count
            return
        if keys in ({"count", "mu", "nu"}, {"count", "mu", "nu", "nu_max"},
                    {"nu"}, {"trace"}):
            found.append(s)
            return
        raise ValueError(
            f"optimizer state with fields {sorted(keys)} cannot be carried to "
            "torch (Adam mu/nu[/nu_max], RMSProp nu or SGD trace)")

    walk(opt_state)
    if len(found) != 1:
        raise ValueError(f"expected one optimizer moment state, found "
                         f"{len(found)}: no file is written without it")
    return found[0]


def _torch_optimizer_state(moments: Dict, model: torch.nn.Module,
                           optimizer: torch.optim.Optimizer) -> Dict:
    """A torch optimizer ``state_dict`` holding ``moments`` ({torch state
    key: state_dict of it}), indexed in ``named_parameters()`` order."""
    named = [n for n, p in model.named_parameters() if p.requires_grad]
    state = {i: {key: torch.tensor(val) if key == "step" else val[name]
                 for key, val in moments.items()}
             for i, name in enumerate(named)}
    return {"state": state,
            "param_groups": optimizer.state_dict()["param_groups"]}


def _aux_entry(tree: Mapping, model: torch.nn.Module, to_sd: Callable,
               make_opt: Callable, what: str) -> Dict:
    """An extra JAX state tree (``params``, Adam ``opt_state``) of the
    model ``model`` -> the file's entry for it: its ``state_dict`` and
    torch optimizer state."""
    sd = to_sd(tree["params"])
    want = model.state_dict()
    if set(sd) != set(want) or any(sd[k].shape != want[k].shape
                                   for k in sd):
        raise ValueError(f"the {what}'s parameters do not fit its model")
    s = _moments(tree["opt_state"])
    if "mu" not in s or "nu_max" in s:
        raise ValueError(f"the {what}'s optimizer state is not Adam")
    moments = {"exp_avg": to_sd(s["mu"]), "exp_avg_sq": to_sd(s["nu"]),
               "step": float(s["count"])}
    optimizer = make_opt(list(model.parameters()))
    return {"state_dict": sd,
            "optimizer": _torch_optimizer_state(moments, model, optimizer)}


def _lap_entry(lap_tree: Mapping) -> Dict:
    """The JAX ``LapState`` tree -> the file's ``lap`` entry."""
    with torch.device("meta"):
        model = make_lap_model()
    return _aux_entry(lap_tree, model, lap_state_dict_from_flax,
                      make_lap_optimizer, "lap translator")


def _disc_entry(disc_tree: Mapping, cfg: Config) -> Dict:
    """The JAX discriminator's ``TrainState`` tree -> the file's ``disc``
    entry."""
    with torch.device("meta"):
        model = Discriminator()
    entry = _aux_entry(disc_tree, model, discriminator_state_dict_from_flax,
                       lambda params: make_hfrm_optimizer(cfg, params),
                       "discriminator")
    return dict(entry, step=int(disc_tree["step"]))


def _optimizer_state(opt_state, kind: str, cfg: Config, step: int,
                     to_sd: Callable) -> Tuple[str, Dict[str, Dict]]:
    """(torch optimizer name, {torch state key: state_dict of it})."""
    s = _moments(opt_state)
    if "trace" in s:
        name, trees = "SGD", {"momentum_buffer": s["trace"]}
    elif "mu" in s:
        name = "Adam (amsgrad)" if "nu_max" in s else "Adam"
        trees = {"exp_avg": s["mu"], "exp_avg_sq": s["nu"]}
        if "nu_max" in s:
            trees["max_exp_avg_sq"] = s["nu_max"]
    else:
        name, trees = "RMSProp", {"square_avg": s["nu"]}
    if kind == "hfrm":
        want = "Adam"
    else:
        want = cfg.optim.optimizer
        if want == "Adam" and cfg.optim.amsgrad:
            want = "Adam (amsgrad)"
    if name != want:
        raise ValueError(f"the checkpoint holds {name} state, the config's "
                         f"optimizer is {want}")
    out = {key: to_sd(tree) for key, tree in trees.items()}
    if "mu" in s:
        out["step"] = float(s["count"])
    elif name == "RMSProp":
        out["step"] = float(step)
    return name, out


def convert_orbax_checkpoint(src: str, dst: str, cfg: Config) -> Dict:
    """Convert the Orbax checkpoint directory ``src`` (a diffusion UNet's
    or a stage-1 HFRM's, trained with ``cfg``) into the port's checkpoint
    file ``dst`` (``.pth.tar`` appended if missing).  Returns a summary:
    ``path``, ``kind``, ``optimizer``, ``step``, ``epoch``."""
    tree, meta = read_orbax_checkpoint(src)
    kind = checkpoint_kind(tree["params"])
    if kind == "unet" and ("global_conv_in" in tree["params"]
                           ) != cfg.data.global_attn:
        raise ValueError(
            f"{src}: a {'global' if cfg.data.global_attn else 'plain'} "
            "UNet config for a checkpoint of the other UNet "
            "(data.global_attn)")
    if "lap" in tree and not cfg.data.lap:
        raise ValueError(f"{src} holds a Laplacian-path translator; the "
                         "config has no data.lap")
    model, to_sd = _model(kind, cfg)
    sd = to_sd(tree["params"])
    want = model.state_dict()
    wrong = sorted(set(sd) ^ set(want)) + sorted(
        k for k in set(sd) & set(want) if sd[k].shape != want[k].shape)
    if wrong:
        raise ValueError(f"{src}: the {kind} parameters do not fit the "
                         f"config's model at {wrong[:5]}")
    ema = to_sd(tree["ema"]) if kind == "unet" else {}
    step = int(tree["step"])
    opt_name, moments = _optimizer_state(tree["opt_state"], kind, cfg, step,
                                         to_sd)

    params = [p for p in model.parameters() if p.requires_grad]
    optimizer = (make_optimizer(cfg.optim, params) if kind == "unet"
                 else make_hfrm_optimizer(cfg, params))
    opt_sd = _torch_optimizer_state(moments, model, optimizer)
    extra = {k: v for k, v in meta.items() if k != "epoch"}
    if "lap" in tree:
        extra["lap"] = _lap_entry(tree["lap"])
    if "disc" in tree:
        if kind != "hfrm":
            raise ValueError(f"{src}: a discriminator beside a {kind}")
        extra["disc"] = _disc_entry(tree["disc"], cfg)
    path = write_checkpoint(dst, cfg, state_dict=sd, optimizer=opt_sd,
                            ema_helper=ema, step=step,
                            generator=int(cfg.training.seed),
                            epoch=int(meta.get("epoch", 0)), extra=extra)
    return {"path": path, "kind": kind, "optimizer": opt_name, "step": step,
            "epoch": int(meta.get("epoch", 0))}
