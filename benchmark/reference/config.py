"""Configuration: a copy of ``handwriting_line_generation_tpu/config.py``:
the dataclasses with the same fields and defaults, the loader of the repo's
own config files (``configs/*.json``), the translation of reference-schema
configs (the published ``arch``/``data_loader`` JSONs, auto-detected by
:func:`load_config`), and the ``a.b.c=value`` overrides of the training
CLI (:func:`apply_overrides`).
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

    @staticmethod
    def from_flags(flags: Optional[str], num_class: int) -> "HWRConfig":
        """The reference's ``hwr`` string ("CNNOnly batchnorm", ...)."""
        flags = flags or ""
        if "none" in flags or not flags:
            return HWRConfig(kind="none", num_class=num_class)
        kind = "cnn_only" if "CNNOnly" in flags else "crnn"
        norm = "group" if "group" in flags else (
            "none" if ("no_norm" in flags or "no norm" in flags)
            else "batch")
        pad = ("less" if "pad less" in flags
               else ("pad" if "pad" in flags else "none"))
        return HWRConfig(kind=kind, norm=norm,
                         small="small" in flags or "sma32" in flags,
                         pad=pad, num_class=num_class)


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

    @staticmethod
    def from_flags(flags: Optional[str], dim: int) -> "DiscriminatorConfig":
        """The reference's ``discriminator`` string: "use low", "no med",
        "small", and un-negated "cond"/"global" heads."""
        if not flags:
            return DiscriminatorConfig(enabled=False)
        return DiscriminatorConfig(
            enabled=True, dim=dim, use_low="use low" in flags,
            use_med="no med" not in flags, small="small" in flags,
            cond="no cond" not in flags and "cond" in flags.replace(
                "condAP", "AP"),
            use_global="no global" not in flags and "global" in flags)


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


def config_from_reference(ref: Dict[str, Any]) -> Config:
    """Translate a reference-schema config (``arch``, ``model``,
    ``data_loader``, ``trainer``, ``optimizer*``) into the repo's own."""
    m = ref.get("model", {})
    trainer = ref.get("trainer", {})
    dl = ref.get("data_loader", {})

    num_class = m.get("num_class", 80)
    model = ModelConfig(num_class=num_class)
    autoenc = None
    if ref.get("arch", "HWWithStyle") == "Autoencoder":
        autoenc = AutoencoderConfig(
            kind={"2tight": "2tight", "2tighter": "2tighter", "2": "2",
                  "no skip": "no_skip"}.get(m.get("type", "2tight"),
                                            "2tight"),
            hwr_classes=m.get("hwr", 0) or 0)
    else:
        model.hwr = HWRConfig.from_flags(m.get("hwr", ""), num_class)
        if "char" in m.get("style", "none"):
            model.style = StyleConfig(
                kind="char",
                style_dim=m.get("style_dim", 256),
                char_style_dim=m.get("char_style_dim", 0),
                dim=m.get("style_extractor_dim",
                          m.get("style_dim", 256) // 4),
                char_dim=m.get("char_style_extractor_dim",
                               2 * m.get("style_extractor_dim", 64)),
                global_pool=m.get("style_global_pool", False),
                window=m.get("char_style_window", 6),
                norm=m.get("style_norm", "none"),
                activ=m.get("style_activ", "lrelu"),
                average_found_char_style=m.get("average_found_char_style",
                                               0.0),
            )
        else:
            model.style = StyleConfig(kind="none")
        gen_flags = m.get("generator", "none")
        if gen_flags and gen_flags != "none":
            model.generator = GeneratorConfig(
                kind="pure", dim=m.get("gen_dim", 256),
                n_style_trans=m.get("n_style_trans", 6),
                append_style=m.get("gen_append_style", False),
                emb_dropout=float(m.get("style_emb_dropout", 0.0) or 0.0),
                small="small" in gen_flags)
        else:
            model.generator = GeneratorConfig(kind="none")
        model.discriminator = DiscriminatorConfig.from_flags(
            m.get("discriminator"), m.get("disc_dim", 64))
        spacer = m.get("spacer")
        model.spacer = SpacerConfig(
            enabled=bool(spacer),
            count_duplicates=isinstance(spacer, str) and "duplicate" in spacer,
            dim=m.get("spacer_dim", 128))
        model.count_std = m.get("count_std", 0.1)
        model.dup_std = m.get("dup_std", 0.03)
        model.max_gen_length = m.get("max_gen_length", 500)
        model.hwr_frozen = m.get("hwr_frozen", False)
        model.pretrained_hwr = m.get("pretrained_hwr")
        model.use_hwr_pred_for_style = m.get("use_hwr_pred_for_style", True)

    dataset_map = {"HWDataset": "iam_lines", "AuthorHWDataset": "iam_author",
                   "AuthorRIMESLinesDataset": "rimes_author"}
    data = DataConfig(
        dataset=dataset_map.get(dl.get("data_set_name", ""), "synthetic"),
        data_dir=dl.get("data_dir", ""),
        batch_size=dl.get("batch_size", 2),
        a_batch_size=dl.get("a_batch_size", 1),
        img_height=dl.get("img_height", 64),
        max_width=dl.get("max_width", 1300),
        charset="rimes" if "RIMES" in dl.get("char_file", "") else "iam",
        augmentation=dl.get("augmentation"),
        fg_masks="fg_masks_dir" in dl,
        shuffle=dl.get("shuffle", True),
        text_data=trainer.get("text_data"),
        spaced_loc=dl.get("spaced_loc"),
        style_loc=dl.get("style_loc"),
        identity_spaced=dl.get("no_spacing_for_spaced", False),
    )

    def _opt(prefix: str) -> OptimConfig:
        o = ref.get("optimizer" + prefix, {})
        sched = trainer.get("use_learning_schedule", False)
        sched = "warmup" if sched is True else (sched or "none")
        return OptimConfig(
            kind=ref.get("optimizer_type" + prefix, "Adam").lower(),
            lr=o.get("lr", 2e-4), betas=tuple(o.get("betas", (0.9, 0.999))),
            weight_decay=o.get("weight_decay", 0.0), lr_schedule=sched,
            warmup_steps=trainer.get("warmup_steps", 1000),
            cycle_size=trainer.get("cycle_size", 500))

    kind = "gan"
    if trainer.get("class") == "AutoTrainer":
        kind = "auto"
    elif "curriculum" not in trainer:
        kind = "hwr"

    tcfg = TrainerConfig(
        kind=kind,
        iterations=trainer.get("iterations", 100_000),
        val_step=trainer.get("val_step", 1000),
        save_step=trainer.get("save_step", 25_000),
        save_step_minor=trainer.get("save_step_minor", 250),
        log_step=trainer.get("log_step", 100),
        save_dir=trainer.get("save_dir", "saved/"),
        curriculum=trainer.get("curriculum", {}),
        balance_loss=trainer.get("balance_loss", "") or "",
        balance_var_x=trainer.get("balance_var_x", {}),
        interpolate_gen_styles=str(trainer.get("interpolate_gen_styles", "")),
        prev_style_size=trainer.get("prev_style_size", 100),
        no_bg_loss=trainer.get("no_bg_loss", False),
        encoder_weights=trainer.get("encoder_weights"),
        encoder_type=trainer.get("encoder_type", "2tight"),
        loss=ref.get("loss", {}),
        loss_weights=ref.get("loss_weights", {}),
        loss_params=ref.get("loss_params", {}),
        text_data_max_len=trainer.get("text_data_max_len"),
        casesensitive=trainer.get("casesensitive", True),
        style_detach=trainer.get("style_detach",
                                 trainer.get("detach_style", False)),
        print_every=trainer.get("print_every", 250),
        print_dir=trainer.get("print_dir"),
    )

    return Config(name=ref.get("name", "experiment"), model=model,
                  autoencoder=autoenc, data=data,
                  optimizer=_opt(""),
                  optimizer_discriminator=_opt("_discriminator"),
                  trainer=tcfg)


def load_config(path: str) -> Config:
    """Load a config file: the repo's own schema, or the reference's
    (auto-detected by its ``arch`` or ``data_loader`` key)."""
    with open(path) as f:
        data = json.load(f)
    if "arch" in data or "data_loader" in data:
        return config_from_reference(data)
    return config_from_dict(data)


def apply_overrides(cfg: Config, overrides: List[str]) -> Config:
    """Apply ``a.b.c=value`` overrides in place.  Dots or ``=`` separate
    the path's segments left of the last ``=``; the value keeps its dots
    (``lr=0.0001``).  A value starting with ``[`` or ``{`` is JSON; else
    an int, then a float, then ``true``/``false`` in either case, else the
    string as it is (so ``data.text_data=`` sets ``""``).  A missing field
    raises ``AttributeError``."""
    for ov in overrides or []:
        *segs, value = ov.split("=")
        if not segs:
            raise ValueError(f"override '{ov}' has no '=':"
                             " expected a.b.c=value")
        path = [p for seg in segs for p in seg.split(".")]
        if value[:1] in ("[", "{"):
            value = json.loads(value)
        else:
            try:
                value = int(value)
            except ValueError:
                try:
                    value = float(value)
                except ValueError:
                    if value in ("true", "True", "false", "False"):
                        value = value.lower() == "true"
        node = cfg
        for part in path[:-1]:
            node = (node[part] if isinstance(node, dict)
                    else getattr(node, part))
        if isinstance(node, dict):
            node[path[-1]] = value
        else:
            if not hasattr(node, path[-1]):
                raise AttributeError(f"no config field {'.'.join(path)}")
            setattr(node, path[-1], value)
    return cfg
