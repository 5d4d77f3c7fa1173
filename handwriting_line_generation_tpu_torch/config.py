"""Model configuration: the subset of ``handwriting_line_generation_tpu/
config.py`` that the generation slice reads, with the same fields and
defaults.  ``HWRConfig`` and ``DiscriminatorConfig`` are carried as plain
field sets because ``ModelConfig`` holds them; their modules are not ported
yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

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
