"""PyTorch port: its copy of the config schema against the JAX package's,
and the two profiles ``chip_smoke.py`` builds in code against the YAML
files they stand for."""

import dataclasses
import glob
import os

import pytest

from wavedm_tpu.config import load_config as jax_load_config

from wavedm_tpu_torch.config import (ConfigError, Config, load_config,
                                     production_profile, reference_profile,
                                     rehearsal_flagship_profile,
                                     rehearsal_profile)

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "wavedm_tpu", "configs")


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(CONFIGS,
                                                               "*.yaml"))),
                         ids=os.path.basename)
def test_yaml_configs_load_as_in_jax(path):
    ours = dataclasses.asdict(load_config(path))
    theirs = dataclasses.asdict(jax_load_config(path))
    assert ours == theirs


# keys no ported path reads (the production YAML sets its own)
TRAINING_ONLY = {("sampling", "batch_size"),
                 ("hfrm", "batch_size"), ("hfrm", "n_epochs"),
                 ("hfrm", "best_psnr_init"), ("hfrm", "remat")}


@pytest.mark.parametrize("profile,name", [
    (reference_profile, "raindrop_wavelet.yaml"),
    (production_profile, "raindrop_wavelet_production.yaml"),
    (rehearsal_profile, "rehearsal_wavelet.yaml"),
    (rehearsal_flagship_profile, "rehearsal_flagship.yaml"),
])
def test_profiles_match_their_yaml(profile, name):
    built = dataclasses.asdict(profile())
    loaded = dataclasses.asdict(load_config(os.path.join(CONFIGS, name)))
    for section in ("data", "model", "diffusion", "training", "sampling",
                    "optim", "parallel", "hfrm"):
        for key, value in built[section].items():
            if (section, key) not in TRAINING_ONLY:
                assert value == loaded[section][key], (section, key)


@pytest.mark.parametrize("profile,name", [
    ("rehearsal", "rehearsal_wavelet.yaml"),
    ("rehearsal_flagship", "rehearsal_flagship.yaml")])
def test_rehearsal_profiles_equal_their_yaml_in_full(profile, name):
    """The tools' built-in configs (no yaml needed) equal JAX's loads of
    the YAML files they stand for, every key."""
    assert dataclasses.asdict(load_config(profile)) == dataclasses.asdict(
        jax_load_config(os.path.join(CONFIGS, name)))


def test_validation_errors():
    cfg = Config()
    cfg.parallel.fused_groupnorm = cfg.parallel.fused_resblock = True
    with pytest.raises(ConfigError):
        cfg.validate()
    cfg = Config()
    cfg.data.image_size = 32
    with pytest.raises(ConfigError):
        cfg.validate()
