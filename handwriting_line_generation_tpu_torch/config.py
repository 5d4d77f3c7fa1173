"""Configuration: a copy of ``handwriting_line_generation_tpu/config.py``'s
dataclasses, with the same fields and defaults, and a loader for the repo's
own config files (``configs/*.json``).  ``DiscriminatorConfig`` is carried
as a plain field set because ``ModelConfig`` holds it; its module is not
ported yet.  Reference-schema configs are translated by the JAX package
only.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch


@dataclass
class HWRConfig:
    kind: str = "cnn_only"          # cnn_only | crnn | none
    norm: str = "batch"             # batch | group | none
    small: bool = False
    pad: str = "none"               # none | pad | less
    num_class: int = 80


@dataclass
class StyleConfig:
    """Character-aware style extractor settings."""
    kind: str = "char"              # char | none
    style_dim: int = 128
    char_style_dim: int = 0         # 0 => single-vector style (paper config)
    dim: int = 64
    char_dim: int = 128
    global_pool: bool = True
    window: int = 2
    char_capacity: int = 16
    norm: str = "group"
    activ: str = "relu"
    average_found_char_style: float = 1.0
    vae: bool = False


@dataclass
class GeneratorConfig:
    """StyleGAN-ish spaced-text generator."""
    kind: str = "pure"              # pure | none
    dim: int = 256                  # gen_dim
    n_style_trans: int = 6
    append_style: bool = True
    emb_dropout: float = 0.0
    small: bool = False
    fused_epilogue: bool = False    # block epilogues through the CUDA kernel
                                    # (ops.gen_epilogue); same math/params as
                                    # the sequential path, inference only
    phase_upsample: bool = False    # not ported: must stay False
    use_char_style: bool = True     # condition on per-position char styles
                                    # when char_style_dim > 0


@dataclass
class DiscriminatorConfig:
    enabled: bool = True
    dim: int = 64
    use_low: bool = True
    use_med: bool = True
    small: bool = False
    cond: bool = False
    use_global: bool = False


@dataclass
class SpacerConfig:
    """Blank/duplicate count predictor."""
    enabled: bool = True
    count_duplicates: bool = True
    dim: int = 128


@dataclass
class ModelConfig:
    num_class: int = 80
    style: StyleConfig = field(default_factory=StyleConfig)
    hwr: HWRConfig = field(default_factory=HWRConfig)
    generator: GeneratorConfig = field(default_factory=GeneratorConfig)
    discriminator: DiscriminatorConfig = field(
        default_factory=DiscriminatorConfig)
    spacer: SpacerConfig = field(default_factory=SpacerConfig)
    count_std: float = 1e-8
    dup_std: float = 1e-9
    max_gen_length: int = 500
    image_height: int = 64
    hwr_frozen: bool = True
    pretrained_hwr: Optional[str] = None
    use_hwr_pred_for_style: bool = True
    # "float32" | "bfloat16": compute dtype of the conv/matmul hot path;
    # norm statistics, spacing math and the tanh output stay float32
    compute_dtype: str = "float32"

    def char_cond_dim(self) -> int:
        """Per-position style channels the generator consumes."""
        if (self.style.char_style_dim > 0 and self.generator.use_char_style
                and not self.style.vae):
            return self.style.char_style_dim
        return 0

    def packed_style_dim(self) -> int:
        """Width of one flat style-bank entry ``[g | spacing | char.flat]``."""
        csd = self.style.char_style_dim
        if csd == 0 or self.style.vae:
            return self.style.style_dim
        return self.style.style_dim + csd + self.num_class * csd

    def torch_compute_dtype(self) -> torch.dtype:
        """Validated map of ``compute_dtype`` to a torch dtype."""
        if self.compute_dtype in ("float32", "f32"):
            return torch.float32
        if self.compute_dtype in ("bfloat16", "bf16"):
            return torch.bfloat16
        raise ValueError(
            "model.compute_dtype must be 'float32' or 'bfloat16', got "
            f"{self.compute_dtype!r}")


@dataclass
class DataConfig:
    dataset: str = "synthetic"       # iam_author | iam_lines | rimes_author | synthetic | text
    data_dir: str = ""
    batch_size: int = 2              # authors per batch for author datasets
    a_batch_size: int = 2            # lines per author
    img_height: int = 64
    max_width: int = 1300
    charset: str = "iam"             # iam | rimes | path to json
    augmentation: Optional[str] = "affine"
    width_buckets: Tuple[int, ...] = (192, 320, 448, 576, 704, 832, 1024, 1344)
    label_buckets: Tuple[int, ...] = (24, 48, 72, 96)
    fg_masks: bool = True
    shuffle: bool = True
    text_data: Optional[str] = None  # corpus path for gen-only lessons
    num_workers: int = 2
    synthetic_authors: int = 20
    synthetic_lines: int = 50
    spaced_loc: Optional[str] = None    # npz of rid -> spaced class row
    style_loc: Optional[str] = None     # npz/glob of {styles,authors[,ids]}
    identity_spaced: bool = False
    synthetic_version: int = 2
    u8_transfer: bool = True         # images reach the device as raw u8
                                     # pixels (ops.augment.dequantize_image)


@dataclass
class OptimConfig:
    kind: str = "adam"
    lr: float = 2e-4
    betas: Tuple[float, float] = (0.5, 0.999)
    weight_decay: float = 0.0
    lr_schedule: str = "none"   # none | LR_test | cyclic | cyclic-full |
                                # 1cycle | rampup | warmup
    warmup_steps: int = 1000
    cycle_size: int = 500


@dataclass
class TrainerConfig:
    kind: str = "gan"               # gan | hwr | auto
    iterations: int = 175_000
    val_step: int = 10_000
    save_step: int = 25_000
    save_step_minor: int = 250
    log_step: int = 250
    save_dir: str = "saved/"
    curriculum: Dict[str, List[List[Any]]] = field(default_factory=dict)
    balance_loss: str = "sign_preserve_var"
    balance_var_x: Dict[str, List[float]] = field(
        default_factory=lambda: {"0": [0.6, 0.5, 0.4, 0.75]})
    interpolate_gen_styles: str = "extra-0.5"
    prev_style_size: int = 100
    no_bg_loss: bool = True
    encoder_weights: Optional[str] = None
    encoder_type: str = "2tight"
    loss: Dict[str, str] = field(default_factory=dict)
    loss_weights: Dict[str, float] = field(default_factory=dict)
    loss_params: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    grad_clip: float = 2.0
    text_data_max_len: Optional[int] = None
    casesensitive: bool = True
    style_detach: bool = False
    print_every: int = 250
    print_dir: Optional[str] = None
    seed: int = 0
    swa: bool = False
    swa_start: int = 0
    swa_c_iters: int = 1
    monitor: Optional[str] = "val_gen_CER"
    monitor_mode: str = "min"       # min | max
    use_style_cache: bool = False


@dataclass
class AutoencoderConfig:
    # 2tight (paper) | 2tighter | 2 | 3 | skip | small | no_skip | space |
    # smallSpace | 32 (models.autoencoder.AE_KINDS)
    kind: str = "2tight"
    hwr_classes: int = 80           # CTC aux head classes; 0 disables


@dataclass
class MeshConfig:
    data: int = -1
    model: int = 1


@dataclass
class Config:
    name: str = "experiment"
    model: ModelConfig = field(default_factory=ModelConfig)
    autoencoder: Optional[AutoencoderConfig] = None
    data: DataConfig = field(default_factory=DataConfig)
    optimizer: OptimConfig = field(default_factory=OptimConfig)
    optimizer_discriminator: OptimConfig = field(default_factory=OptimConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _dataclass_from_dict(cls, data: Dict[str, Any]):
    """Build dataclass ``cls`` from a plain dict, recursing into fields
    whose default is a dataclass; unknown keys are ignored."""
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for key, value in data.items():
        if key not in fields:
            continue
        f = fields[key]
        default = (f.default_factory()
                   if f.default_factory is not dataclasses.MISSING
                   else f.default)
        if dataclasses.is_dataclass(default) and isinstance(value, dict):
            kwargs[key] = _dataclass_from_dict(type(default), value)
        elif isinstance(default, tuple) and isinstance(value, list):
            kwargs[key] = tuple(value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


def config_from_dict(data: Dict[str, Any]) -> Config:
    cfg = _dataclass_from_dict(Config, data)
    if data.get("autoencoder") is not None:
        cfg.autoencoder = _dataclass_from_dict(AutoencoderConfig,
                                               data["autoencoder"])
    return cfg


def load_config(path: str) -> Config:
    """Load one of the repo's own config files (``configs/*.json``)."""
    with open(path) as f:
        data = json.load(f)
    if "arch" in data or "data_loader" in data:
        raise ValueError(f"{path} is a reference-schema config; the port "
                         f"reads the repo's own schema only")
    return config_from_dict(data)
