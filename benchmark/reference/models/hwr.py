"""Handwriting recognizers with a CTC head.

Counterpart of ``handwriting_line_generation_tpu/models/hwr.py``:

* :class:`CNNOnlyHWR` — a 7-conv trunk collapsing H = 64 to 2 rows, a mean
  over the remaining height, a dilated 1-D conv stack and a float32
  log-softmax over classes;
* :class:`CRNN` — the same trunk and mean, then two bidirectional LSTM
  layers, each followed by a dense layer, and a dense head;
* :class:`SmallCRNN` — a 7-conv trunk for H = 24 lines (per-channel
  dropout, off unless asked for), one bidirectional LSTM and a dense head.

Every conv and pool is ``SAME``, so the output has exactly ``T = W/4``
frames.  Images come in NHWC ``[B, H, W, 1]`` and log-probs go out
batch-major ``[B, T, num_class]``, as in the JAX package; inside, the trunk
is NCHW and the 1-D stack ``[B, C, T]``.  The LSTMs run in float32 whatever
the compute dtype, as the JAX package's scanned ones do.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from reference.models.layers import (
    GroupNorm, channel_dropout, conv, max_pool,
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


class BiLSTM(nn.Module):
    """flax ``nn.RNN(OptimizedLSTMCell(hidden))`` over ``[B, T, in]`` and
    the same with ``reverse=True, keep_order=True``, concatenated:
    ``[B, T, 2 * hidden]``, zero initial state, float32.  Direction ``d``'s
    weights are ``weight_ih[d]`` (the ``ii/if/ig/io`` kernels, rows in
    (i, f, g, o) order), ``weight_hh[d]`` and ``bias_hh[d]`` (the
    ``hi/hf/hg/ho`` dense layers); flax's input kernels have no bias, so
    none is trained here either.  Runs as one ``torch.lstm`` call (cuDNN on
    the card)."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        k = hidden ** -0.5                 # torch's nn.LSTM init range
        self.weight_ih = nn.Parameter(
            torch.empty(2, 4 * hidden, in_features).uniform_(-k, k))
        self.weight_hh = nn.Parameter(
            torch.empty(2, 4 * hidden, hidden).uniform_(-k, k))
        self.bias_hh = nn.Parameter(torch.zeros(2, 4 * hidden))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        zero = x.new_zeros(4 * self.hidden)
        weights = [w for d in range(2) for w in (
            self.weight_ih[d], self.weight_hh[d], zero, self.bias_hh[d])]
        h0 = x.new_zeros(2, x.shape[0], self.hidden)
        out, _, _ = torch.lstm(x, (h0, h0), weights, True, 1, 0.0,
                               torch.is_grad_enabled(), True, True)
        return out


class CRNN(nn.Module):
    """Conv trunk + height mean, then twice a bidirectional LSTM and a
    dense layer to ``hidden``, then a dense head and a float32
    log-softmax (the reference's ``cnn_lstm.py``)."""

    def __init__(self, num_class: int, hidden: int = 512,
                 norm: str = "group", small: bool = False,
                 pad: str = "none", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_class = num_class
        self.small = small
        self.pad = pad
        self.dtype = dtype
        self.trunk = _ConvTrunk(norm, small, dtype)
        self.lstms = nn.ModuleList([BiLSTM(TRUNK_WIDTHS[-1], hidden),
                                    BiLSTM(hidden, hidden)])
        self.denses = nn.ModuleList(nn.Linear(2 * hidden, hidden)
                                    for _ in range(2))
        self.out = nn.Linear(hidden, num_class)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _maybe_pad(x, self.pad, self.small)
        feats = self.trunk(x.permute(0, 3, 1, 2))
        seq = feats.float().mean(dim=2).to(self.dtype).float()
        seq = seq.transpose(1, 2)                          # [B, T, 512]
        for lstm, lin in zip(self.lstms, self.denses):
            seq = lin(lstm(seq))
        return F.log_softmax(self.out(seq), dim=-1)


SMALL_WIDTHS = (128, 128, 256, 256, 512, 512, 512)
SMALL_NORMED = (False, True, True, False, True, False, True)
SMALL_DROPPED = (False, False, True, True, True, True, True)


class SmallCRNN(nn.Module):
    """A compact CRNN for H = 24 lines: 7 3x3 convs (128-128-256-256-512-
    512-512), group norm after convs 1, 2, 4 and 6, per-channel dropout
    after convs 2-6, ReLU; 2x2 pools after convs 1 and 3, a (2, 1)-strided
    ``SAME`` pool after conv 5; the height mean, one bidirectional LSTM,
    a dense head and a log-softmax.  Inputs narrower than 12 px are padded
    to 12 with -1, split evenly (the extra column on the right)."""

    def __init__(self, num_class: int, hidden: int = 512,
                 norm: str = "group", dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_class = num_class
        self.dropout = dropout
        self.dtype = dtype
        ins = (1,) + SMALL_WIDTHS[:-1]
        self.convs = nn.ModuleList(nn.Conv2d(i, o, 3)
                                   for i, o in zip(ins, SMALL_WIDTHS))
        self.use_norm = norm != "none"
        self.norms = nn.ModuleList(
            GroupNorm(f, dtype) for f, n in zip(SMALL_WIDTHS, SMALL_NORMED)
            if n and self.use_norm)
        self.lstm = BiLSTM(SMALL_WIDTHS[-1], hidden)
        self.out = nn.Linear(2 * hidden, num_class)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """``generator``: draw the dropout masks from it; None (the
        default, and what the JAX HWR trainer does) keeps dropout off."""
        if x.shape[2] < 12:
            d = 12 - x.shape[2]
            x = F.pad(x, (0, 0, d // 2, d - d // 2), value=-1.0)
        x = x.permute(0, 3, 1, 2)
        k = 0
        for i, layer in enumerate(self.convs):
            x = conv(x, layer, self.dtype, padding=1)
            if SMALL_NORMED[i] and self.use_norm:
                x = self.norms[k](x)
                k += 1
            if SMALL_DROPPED[i]:
                x = channel_dropout(x, self.dropout, generator,
                                    per_channel=True)
            x = F.relu(x)
            if i in (1, 3):
                x = max_pool(x, (2, 2))
            elif i == 5:
                x = max_pool(x, (2, 2), (2, 1), padding="SAME")
        seq = x.float().mean(dim=2).to(self.dtype).float().transpose(1, 2)
        return F.log_softmax(self.out(self.lstm(seq)), dim=-1)


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
    if kind == "crnn":
        return CRNN(num_class, norm=norm, small=small, pad=pad, dtype=dtype)
    if kind == "small_crnn":
        return SmallCRNN(num_class, norm=norm, dtype=dtype)
    if kind == "none":
        return None
    raise ValueError(f"unknown hwr kind {kind!r}")
