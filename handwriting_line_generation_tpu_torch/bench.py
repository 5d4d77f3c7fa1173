"""Generated handwriting lines per second on one GPU.

The port's counterpart of the repo-root ``bench.py``: the paper-width
generation path (num_class 80, style_dim 128, gen dim 256, appended style,
spacer dim 128 with duplicates, no recognizer or discriminator, whole-network
bfloat16) with ``fused_epilogue=True``, so every block epilogue runs the
CUDA kernel.  512 copies of a 35-character line at ``spaced_len`` 192, i.e.
64 x 768 px lines; seeded random weights.

    python -m handwriting_line_generation_tpu_torch.bench [batch]

prints one JSON line ``{"metric", "value", "unit", "device"}``.  Needs a
CUDA device: it raises without one.
"""

from __future__ import annotations

import json
import sys
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from handwriting_line_generation_tpu_torch.charset import IAM_CHARSET
from handwriting_line_generation_tpu_torch.config import (
    DiscriminatorConfig, GeneratorConfig, HWRConfig, ModelConfig,
    SpacerConfig, StyleConfig,
)
from handwriting_line_generation_tpu_torch.inference.generate import (
    GenerationSession, cast_params_bf16,
)
from handwriting_line_generation_tpu_torch.init import init_model

TEXT = "The quick brown fox jumps over dogs"      # 35 chars
SPACED_LEN = 192                                  # -> 64 x 768 px lines
STYLE_DIM = 128


def paper_config(fused_epilogue: bool = True) -> ModelConfig:
    """``bench.py``'s paper-width model, bfloat16, fused epilogue."""
    return ModelConfig(
        num_class=80,
        style=StyleConfig(style_dim=STYLE_DIM, dim=64, char_dim=128,
                          window=2),
        generator=GeneratorConfig(dim=256, append_style=True,
                                  fused_epilogue=fused_epilogue),
        discriminator=DiscriminatorConfig(enabled=False),
        spacer=SpacerConfig(dim=128, count_duplicates=True),
        hwr=HWRConfig(kind="none"),
        compute_dtype="bfloat16",
    )


def build(batch: int = 512, device=None, seed: int = 0
          ) -> Tuple[GenerationSession, torch.Tensor, torch.Tensor,
                     torch.Tensor]:
    """Session on ``device`` (default cuda) with seeded bf16 weights, and
    ``(labels, lens, styles)`` for ``batch`` copies of :data:`TEXT`."""
    model = cast_params_bf16(init_model(paper_config(), seed))
    session = GenerationSession(model, IAM_CHARSET, device=device)
    labels, lens = session.encode_texts([TEXT] * batch)
    styles = np.random.default_rng(seed + 1).standard_normal(
        (batch, STYLE_DIM)).astype(np.float32)
    return session, labels, lens, torch.from_numpy(styles).to(session.device)


def time_forward(session: GenerationSession, labels, lens, styles,
                 iters: int = 10, warmup: int = 2) -> float:
    """Milliseconds per forward (spacer, spacing, generator), by CUDA
    events around ``iters`` forwards after ``warmup``."""
    for i in range(warmup):
        session.forward(labels, lens, styles, spaced_len=SPACED_LEN, seed=i)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        session.forward(labels, lens, styles, spaced_len=SPACED_LEN, seed=i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv: Optional[Sequence[str]] = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    batch = int(argv[0]) if argv else 512
    session, labels, lens, styles = build(batch)
    ms = time_forward(session, labels, lens, styles)
    print(json.dumps({
        "metric": "generated_lines_per_sec_per_chip",
        "value": batch * 1000.0 / ms,
        "unit": "lines/s",
        "device": torch.cuda.get_device_name(session.device),
    }))


if __name__ == "__main__":
    main()
