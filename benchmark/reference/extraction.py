"""The reference of a style-extraction request, and the numbers that judge
one.

A request is a batch of u8 lines, dequantized on the card, through
``StyleExtractor.extract`` (the recognizer, its frames past each line's
ink set to blank, then the char style encoder over each author's lines):
the packed styles, one row an author, and the recognizer's masked
log-probabilities.  The judgement:

* ``style_gap``: over the authors, the largest ``|style - ref| / |ref|``;
* ``pred_gap``: the widest gap between the program's and the reference's
  log-probabilities over every line's frames.
"""

from __future__ import annotations

from typing import Dict

import torch

from reference.models.hw_with_style import pack_style
from reference.ops.augment import dequantize_image


def frames_of(width: torch.Tensor, W: int) -> torch.Tensor:
    return torch.clamp((width + 3) // 4, 1, W // 4)


@torch.no_grad()
def request(model, image_u8, width, a_batch: int) -> Dict:
    """The request by the reference model: ``{"styles", "pred"}``."""
    image = dequantize_image(image_u8, width)
    frames = frames_of(width, image.shape[2])
    style, pred = model.extract_style(image, a_batch, frame_lengths=frames)
    return {"styles": pack_style(style)[::a_batch].float(),
            "pred": pred.float()}


@torch.no_grad()
def judge(model, image_u8, width, a_batch: int, out: Dict
          ) -> Dict[str, float]:
    ref = request(model, image_u8, width, a_batch)
    s = out["styles"].float().to(ref["styles"].device)
    num = (s - ref["styles"]).norm(dim=1)
    den = ref["styles"].norm(dim=1).clamp(min=1e-12)
    p = out["pred"].float().to(ref["pred"].device)
    flips = int((p.argmax(-1) != ref["pred"].argmax(-1)).sum())
    return {"style_gap": float((num / den).max()),
            "pred_gap": float((p - ref["pred"]).abs().max()),
            "argmax_flips": flips,
            "style_gap_median": float((num / den).median())}
