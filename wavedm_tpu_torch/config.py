"""Typed configuration: the port's own copy of the reference schema.

Same sections, keys, defaults and validation as ``wavedm_tpu/config.py``, so
the YAML files under ``wavedm_tpu/configs/`` load unchanged.  ``yaml`` is
imported only inside the YAML loaders; everything the restoration path
runs builds its ``Config`` in code.  Where ``yaml`` is not installed,
:func:`load_config` still takes the built-in profiles by name
(``reference``, ``production``, and ``pixel``, ``global`` and ``lap`` for
the variant configs) and ``--set`` values as JSON, or as plain strings.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Tuple


class ConfigError(ValueError):
    """Raised when a config fails validation."""


@dataclass
class DataConfig:
    dataset: str = "RainDrop"
    image_size: int = 64          # UNet working resolution (wavelet domain)
    patch_size: int = 256         # pixel-domain crop size
    lap: bool = False
    global_attn: bool = False
    wavelet: bool = True
    wavelet_in_unet: bool = False
    use_window: bool = False
    window_size: int = 2
    begin_from_noise: bool = True
    use_fft: bool = False
    channels: int = 3
    num_workers: int = 8
    device_cache: bool = False
    data_dir: str = "./data"
    conditional: bool = True

    @property
    def wavelet_domain(self) -> bool:
        """The chain and the UNet work on wavelet coefficients, conditioned
        by a frozen HFRM: the wavelet path, unless the UNet takes the DWT
        itself (``wavelet_in_unet``, which runs the pixel path's chain)."""
        return self.wavelet and not self.wavelet_in_unet

    def validate(self) -> None:
        if self.wavelet and self.patch_size % 4 != 0:
            raise ConfigError("wavelet path needs patch_size divisible by 4")
        if self.wavelet_domain:
            if self.image_size * 4 != self.patch_size:
                raise ConfigError(
                    "wavelet config requires image_size == patch_size / 4 "
                    f"(got image_size={self.image_size}, "
                    f"patch_size={self.patch_size})")
        if self.use_window and self.window_size < 1:
            raise ConfigError("window_size must be >= 1")
        if self.global_attn and self.use_window:
            raise ConfigError("global_attn does not compose with use_window")
        if self.global_attn and self.wavelet_in_unet:
            raise ConfigError(
                "global_attn does not compose with wavelet_in_unet")
        if self.global_attn and not self.conditional:
            raise ConfigError("global_attn requires conditional")
        if self.lap and self.wavelet:
            raise ConfigError(
                "lap is a pixel-path domain transform; set wavelet: false")
        if self.lap and self.use_fft:
            raise ConfigError("lap + use_fft is unsupported")
        if self.lap and self.global_attn:
            raise ConfigError("lap + global_attn is unsupported")
        if self.lap and self.patch_size % 4 != 0:
            raise ConfigError("lap path needs patch_size divisible by 4")


@dataclass
class ModelConfig:
    in_channels: int = 48
    out_ch: int = 3
    pred_channels: int = 3
    use_other_channels: bool = True
    other_channels_begin: int = 3
    use_gt_in_train: bool = True
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 6)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16,)
    dropout: float = 0.0
    ema_rate: float = 0.9999
    ema: bool = True
    resamp_with_conv: bool = True

    def __post_init__(self):
        self.ch_mult = tuple(self.ch_mult)
        self.attn_resolutions = tuple(self.attn_resolutions)

    def validate(self) -> None:
        if self.pred_channels > self.in_channels:
            raise ConfigError("pred_channels cannot exceed in_channels")
        if (self.use_other_channels
                and self.other_channels_begin > self.in_channels):
            raise ConfigError("other_channels_begin out of range")
        if not 0.0 <= self.dropout < 1.0:
            raise ConfigError("dropout must be in [0, 1)")
        if not 0.0 < self.ema_rate < 1.0:
            raise ConfigError("ema_rate must be in (0, 1)")

    @property
    def unet_in_channels(self) -> int:
        """cond(in) + x_t(pred) + other HF channels: 96 for the flagship."""
        if self.use_other_channels:
            return (self.in_channels * 2 + self.pred_channels
                    - self.other_channels_begin)
        return self.in_channels + self.pred_channels


@dataclass
class DiffusionConfig:
    beta_schedule: str = "linear"
    beta_start: float = 0.0001
    beta_end: float = 0.02
    num_diffusion_timesteps: int = 1000

    def validate(self) -> None:
        if self.beta_schedule not in ("linear", "quad", "const", "jsd",
                                      "sigmoid"):
            raise ConfigError(f"unknown beta_schedule {self.beta_schedule!r}")
        if self.num_diffusion_timesteps < 1:
            raise ConfigError("num_diffusion_timesteps must be >= 1")


@dataclass
class TrainingConfig:
    use_mse: bool = False
    patch_n: int = 8
    batch_size: int = 1
    n_epochs: int = 38000
    n_iters: int = 2000000
    snapshot_freq: int = 3000
    validation_freq: int = 3000
    seed: int = 61
    pred_type: str = "eps"        # parameterization the weights were trained with
    snr_gamma: float = 0.0
    keep_snapshots: int = 0
    grad_accum: int = 1

    def validate(self) -> None:
        if self.batch_size < 1 or self.patch_n < 1:
            raise ConfigError("batch_size and patch_n must be >= 1")
        if self.pred_type not in ("eps", "v"):
            raise ConfigError("training.pred_type must be 'eps' or 'v'")
        if self.snr_gamma < 0:
            raise ConfigError("training.snr_gamma must be >= 0")
        if self.grad_accum < 1:
            raise ConfigError("training.grad_accum must be >= 1")
        if (self.batch_size * self.patch_n) % self.grad_accum:
            raise ConfigError(
                "batch_size*patch_n must be divisible by grad_accum")


@dataclass
class SamplingConfig:
    batch_size: int = 1
    last_only: bool = True
    sampling_timesteps: int = 25
    grid_r: int = 16              # overlap grid stride
    eta: float = 0.0
    x0_pred_index: int = -5       # reference keeps x0_preds[-5]
    patch_micro_batch: int = 0
    jit_mode: str = "scan"        # JAX-only knob, accepted for YAML compatibility
    whole_image: bool = False
    t_start: int = 0              # > 0: truncated chain over [0, t_start)
    init_ll: str = "hfrm"         # what is noised to t_start
    solver: str = "ddim"

    def validate(self) -> None:
        if self.sampling_timesteps < 1:
            raise ConfigError("sampling_timesteps must be >= 1")
        if self.grid_r < 1:
            raise ConfigError("grid_r must be >= 1")
        if self.jit_mode not in ("scan", "step"):
            raise ConfigError("jit_mode must be 'scan' or 'step'")
        if self.t_start < 0:
            raise ConfigError("t_start must be >= 0 (0 disables truncation)")
        if self.init_ll not in ("hfrm", "cond", "noise"):
            raise ConfigError("init_ll must be 'hfrm', 'cond', or 'noise'")
        if self.solver not in ("ddim", "dpmpp2m"):
            raise ConfigError("solver must be 'ddim' or 'dpmpp2m'")
        if self.solver == "dpmpp2m" and self.eta > 0:
            raise ConfigError("dpmpp2m is deterministic: eta must be 0")


@dataclass
class OptimConfig:
    optimizer: str = "Adam"
    lr: float = 0.00004
    weight_decay: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.999
    amsgrad: bool = False
    eps: float = 1e-8

    def validate(self) -> None:
        if self.optimizer not in ("Adam", "RMSProp", "SGD"):
            raise ConfigError(f"unknown optimizer {self.optimizer!r}")


@dataclass
class ParallelConfig:
    data_axis: int = -1
    fsdp: bool = False
    compute_dtype: str = "float32"   # activations: bfloat16 | float32
    # GroupNorm(+swish) at every UNet norm site with the rounding of JAX's
    # Pallas kernel (off: flax's GroupNorm's, through the same kernel
    # outside autograd)
    fused_groupnorm: bool = False
    # GN->swish->conv3x3 through the fused CUDA kernel at every ResnetBlock
    fused_resblock: bool = False

    def validate(self) -> None:
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ConfigError("compute_dtype must be float32 or bfloat16")
        if self.fused_groupnorm and self.fused_resblock:
            raise ConfigError(
                "fused_groupnorm and fused_resblock are alternative GN "
                "strategies; enable at most one")


@dataclass
class HFRMConfig:
    dim: int = 32
    enc_blk_nums: Tuple[int, ...] = (2, 2, 2, 4)
    middle_blk_num: int = 6
    dec_blk_nums: Tuple[int, ...] = (2, 2, 2, 2)
    ckpt_path: str = ""
    lr: float = 0.0002
    batch_size: int = 8
    n_epochs: int = 800
    best_psnr_init: float = 31.0
    remat: bool = False
    use_perceptual: bool = False
    vgg_ckpt: str = ""
    use_gan: bool = False
    lambda_gan: float = 1.0
    tv_weight: float = 0.0

    def __post_init__(self):
        self.enc_blk_nums = tuple(self.enc_blk_nums)
        self.dec_blk_nums = tuple(self.dec_blk_nums)

    def validate(self) -> None:
        if len(self.enc_blk_nums) != len(self.dec_blk_nums):
            raise ConfigError("enc/dec block lists must have equal depth")


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    sampling: SamplingConfig = field(default_factory=SamplingConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    hfrm: HFRMConfig = field(default_factory=HFRMConfig)

    def validate(self) -> "Config":
        for f in dataclasses.fields(self):
            getattr(self, f.name).validate()
        if self.sampling.t_start >= self.diffusion.num_diffusion_timesteps:
            raise ConfigError(
                "sampling.t_start must be < diffusion.num_diffusion_timesteps")
        if (self.sampling.t_start > 0 and self.sampling.init_ll == "hfrm"
                and not self.data.wavelet_domain):
            raise ConfigError("init_ll: hfrm requires the wavelet path")
        return self


_SECTION_TYPES = {
    "data": DataConfig,
    "model": ModelConfig,
    "diffusion": DiffusionConfig,
    "training": TrainingConfig,
    "sampling": SamplingConfig,
    "optim": OptimConfig,
    "parallel": ParallelConfig,
    "hfrm": HFRMConfig,
}


def config_from_dict(raw: dict) -> Config:
    sections = {}
    for name, value in raw.items():
        if name not in _SECTION_TYPES:
            raise ConfigError(f"unknown config section '{name}'")
        if not isinstance(value, dict):
            raise ConfigError(f"section '{name}' must be a mapping")
        cls = _SECTION_TYPES[name]
        known = {f.name for f in dataclasses.fields(cls)}
        for key in value:
            if key not in known:
                raise ConfigError(f"unknown key '{name}.{key}' in config")
        sections[name] = cls(**value)
    return Config(**sections).validate()


def _parse_value(text: str):
    """An override's value: YAML where ``yaml`` is installed; else JSON
    (numbers, true/false, lists), else the string itself."""
    try:
        import yaml
    except ImportError:
        try:
            return json.loads(text)
        except ValueError:
            return text.strip()
    return yaml.safe_load(text)


def apply_overrides(raw: dict, overrides) -> dict:
    """Apply ``section.key=value`` strings (values YAML-parsed, as the
    JAX package's ``--set``) to a raw config mapping; unknown sections and
    keys still fail in :func:`config_from_dict`."""
    for ov in overrides:
        key, eq, sval = ov.partition("=")
        parts = key.strip().split(".")
        if not eq or len(parts) != 2 or not sval.strip():
            raise ConfigError(
                f"override '{ov}' must look like section.key=value")
        sec, k = parts
        if not isinstance(raw.get(sec, {}), dict):
            raise ConfigError(f"override '{ov}': section '{sec}' is not a "
                              "mapping")
        raw.setdefault(sec, {})[k] = _parse_value(sval)
    return raw


def load_config(path: str, overrides=()) -> Config:
    """Load and validate a YAML config file (the reference's schema), or a
    built-in profile by name (a key of ``PROFILES``), with
    ``section.key=value`` overrides applied before validation."""
    if path in PROFILES:
        raw = dataclasses.asdict(PROFILES[path]())
    else:
        import yaml

        with open(path, "r") as f:
            raw = yaml.safe_load(f)
    if not isinstance(raw, dict):
        raise ConfigError(f"config file {path} did not parse to a mapping")
    if overrides:
        raw = apply_overrides(raw, overrides)
    return config_from_dict(raw)


def reference_profile() -> Config:
    """``raindrop_wavelet.yaml``: 25 DDIM steps from noise, keep
    x0_preds[-5], float32."""
    return Config().validate()


def production_profile() -> Config:
    """``raindrop_wavelet_production.yaml``: 10 steps over [0, 300) from the
    HFRM LL band, keep x0_preds[-1], bfloat16; it trains on the HFRM's
    conditioning (``use_gt_in_train: false``) with 2 x 8 crops a step at
    lr 1e-4."""
    cfg = Config()
    cfg.model.use_gt_in_train = False
    cfg.optim.lr = 1e-4
    cfg.training = TrainingConfig(batch_size=2, n_epochs=100000,
                                  snapshot_freq=2500,
                                  validation_freq=1000000)
    cfg.sampling = SamplingConfig(sampling_timesteps=10, t_start=300,
                                  init_ll="hfrm", x0_pred_index=-1)
    cfg.parallel = ParallelConfig(compute_dtype="bfloat16")
    return cfg.validate()


def pixel_profile() -> Config:
    """``raindrop.yaml``: pixel-space diffusion, 128x128 crops, 6 UNet input
    channels, ch_mult 1,1,2,2,4,4, 20 crops a step, no HFRM."""
    cfg = Config()
    cfg.data = DataConfig(image_size=128, patch_size=128, wavelet=False)
    cfg.model = ModelConfig(in_channels=3, use_other_channels=False,
                            other_channels_begin=0, use_gt_in_train=False,
                            ch_mult=(1, 1, 2, 2, 4, 4))
    cfg.training = TrainingConfig(patch_n=20, n_epochs=12000,
                                  snapshot_freq=5000, validation_freq=5000)
    return cfg.validate()


def global_profile() -> Config:
    """``raindrop_wavelet_global.yaml``: the reference profile with the
    global-attention UNet (``data.global_attn``)."""
    cfg = reference_profile()
    cfg.data.global_attn = True
    return cfg.validate()


def lap_profile() -> Config:
    """``raindrop_lap.yaml``: the Laplacian path, diffusion on the 16x16
    coarse level of 64x64 crops (64x64 patches of the coarse level at
    eval), ch_mult 1,2,2,4, 20 crops a step."""
    cfg = pixel_profile()
    cfg.data.image_size = cfg.data.patch_size = 64
    cfg.data.lap = True
    cfg.model.ch_mult = (1, 2, 2, 4)
    return cfg.validate()


def rehearsal_profile() -> Config:
    """``rehearsal_wavelet.yaml``: the reference protocol at a reduced
    scale (UNet ch 64, ch_mult 1,2,4, one res block; HFRM dim 16, one
    block a level), on the device crop cache: the dress rehearsal's."""
    cfg = Config()
    cfg.data.device_cache = True
    cfg.model = ModelConfig(use_gt_in_train=False, ch=64, ch_mult=(1, 2, 4),
                            num_res_blocks=1)
    cfg.training = TrainingConfig(patch_n=4, batch_size=2, n_epochs=100000,
                                  snapshot_freq=2000,
                                  validation_freq=1000000)
    cfg.optim.lr = 0.0002
    cfg.hfrm = HFRMConfig(dim=16, enc_blk_nums=(1, 1, 1, 1),
                          middle_blk_num=1, dec_blk_nums=(1, 1, 1, 1),
                          batch_size=2, n_epochs=100000, best_psnr_init=10.0)
    return cfg.validate()


def rehearsal_flagship_profile() -> Config:
    """``rehearsal_flagship.yaml``: the flagship UNet and HFRM trained on
    the synthetic rehearsal split (2 x 8 crops a step at lr 1e-4, HFRM
    conditioning, HFRM with remat); the eval sweep's config."""
    cfg = Config()
    cfg.data.device_cache = True
    cfg.model.use_gt_in_train = False
    cfg.training = TrainingConfig(batch_size=2, n_epochs=100000,
                                  snapshot_freq=2500,
                                  validation_freq=1000000)
    cfg.optim.lr = 0.0001
    cfg.hfrm = HFRMConfig(remat=True, batch_size=2, n_epochs=100000,
                          best_psnr_init=10.0)
    return cfg.validate()


PROFILES = {"reference": reference_profile, "production": production_profile,
            "pixel": pixel_profile, "global": global_profile,
            "lap": lap_profile, "rehearsal": rehearsal_profile,
            "rehearsal_flagship": rehearsal_flagship_profile}
