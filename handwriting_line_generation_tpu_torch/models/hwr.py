"""Handwriting recognizer with a CTC head: ``CNNOnlyHWR``.

Counterpart of ``handwriting_line_generation_tpu/models/hwr.py``: a 7-conv
trunk collapsing H = 64 to 2 rows, a mean over the remaining height, a
dilated 1-D conv stack and a float32 log-softmax over classes.  Every conv
and pool is ``SAME``, so the output has exactly ``T = W/4`` frames.  Images
come in NHWC ``[B, H, W, 1]`` and log-probs go out batch-major
``[B, T, num_class]``, as in the JAX package; inside, the trunk is NCHW and
the 1-D stack ``[B, C, T]``.  ``CRNN`` and ``SmallCRNN`` are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from handwriting_line_generation_tpu_torch.models.layers import (
    GroupNorm, conv, max_pool,
)

TRUNK_WIDTHS = (64, 128, 256, 256, 512, 512, 512)
TRUNK_NORMED = (False, False, True, False, True, False, True)
DILATIONS = (2, 4, 1, 8)


class _ConvTrunk(nn.Module):
    """64-128-256-256-512-512-512 3x3 convs, group norm after convs 2, 4
    and 6 ("batch" maps to group norm, as in the JAX package), ReLU; 2x2
    pools after convs 0 (unless ``small``) and 1, (2, 1)-strided ``SAME``
    pools after convs 3 and 5."""

    def __init__(self, norm: str = "group", small: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.small = small
        self.dtype = dtype
        ins = (1,) + TRUNK_WIDTHS[:-1]
        self.convs = nn.ModuleList(nn.Conv2d(i, o, 3)
                                   for i, o in zip(ins, TRUNK_WIDTHS))
        self.use_norm = norm != "none"
        self.norms = nn.ModuleList(
            GroupNorm(f, dtype) for f, n in zip(TRUNK_WIDTHS, TRUNK_NORMED)
            if n and self.use_norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:     # [B, 1, H, W]
        k = 0
        for i, layer in enumerate(self.convs):
            x = conv(x, layer, self.dtype, padding=1)
            if TRUNK_NORMED[i] and self.use_norm:
                x = self.norms[k](x)
                k += 1
            x = F.relu(x)
            if i == 0 and not self.small:
                x = max_pool(x, (2, 2))
            elif i == 1:
                x = max_pool(x, (2, 2))
            elif i in (3, 5):
                x = max_pool(x, (2, 2), (2, 1), padding="SAME")
        return x                                 # [B, 512, H/32, W/4]


class CNNOnlyHWR(nn.Module):
    """Conv trunk + height mean + dilated 1-D stack (2, 4, 1, 8) ->
    log-probs.  ``pad`` zero-pads the input horizontally by one ("less") or
    two ("pad") image heights per side with the background value -1."""

    def __init__(self, num_class: int, norm: str = "group",
                 small: bool = False, pad: str = "none",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_class = num_class
        self.small = small
        self.pad = pad
        self.dtype = dtype
        self.trunk = _ConvTrunk(norm, small, dtype)
        self.use_norm = norm != "none"
        self.convs = nn.ModuleList(nn.Conv1d(512, 512, 3) for _ in DILATIONS)
        self.norms = nn.ModuleList(GroupNorm(512, dtype) for _ in DILATIONS
                                   if self.use_norm)
        self.out = nn.Conv1d(512, num_class, 3)

    def forward(self, x: torch.Tensor, return_features: bool = False):
        """``[B, H, W, 1]`` images -> ``[B, T, num_class]`` float32
        log-probs.  ``return_features``: also the height-collapsed trunk
        sequence ``[B, T, 512]`` before the dilated stack, in the compute
        dtype (the quality harness's FID features)."""
        x = _maybe_pad(x, self.pad, self.small)
        feats = self.trunk(x.permute(0, 3, 1, 2))
        seq = feats.float().mean(dim=2).to(self.dtype)        # [B, 512, T]
        skip = seq
        for i, (layer, dil) in enumerate(zip(self.convs, DILATIONS)):
            seq = conv(seq, layer, self.dtype, padding=dil, dilation=dil)
            if self.use_norm:
                seq = self.norms[i](seq)
            seq = F.relu(seq)
        logits = conv(seq, self.out, self.dtype, padding=1)
        out = F.log_softmax(logits.float(), dim=1).transpose(1, 2)
        if return_features:
            return out, skip.transpose(1, 2)
        return out


def _maybe_pad(x: torch.Tensor, pad: str, small: bool) -> torch.Tensor:
    """Horizontal pad of NHWC by one ("less") or two ("pad") heights per
    side, with the paper background -1."""
    if pad == "none" or not pad:
        return x
    h = 32 if small else 64
    w = h if pad == "less" else 2 * h
    return F.pad(x, (0, 0, w, w), value=-1.0)


def build_hwr(kind: str, num_class: int, norm: str = "group",
              small: bool = False, pad: str = "none",
              dtype: torch.dtype = torch.float32):
    if kind == "cnn_only":
        return CNNOnlyHWR(num_class, norm, small, pad, dtype)
    if kind in ("crnn", "small_crnn"):
        raise NotImplementedError(
            f"hwr kind {kind!r} is not ported yet (ROADMAP.md Queue 1 "
            f"item 4: CRNN/SmallCRNN)")
    if kind == "none":
        return None
    raise ValueError(f"unknown hwr kind {kind!r}")
