"""Spacing predictor ("spacer").

Counterpart of ``handwriting_line_generation_tpu/models/count_cnn.py``: the
label one-hots concatenated with the broadcast style go through three
(Conv1d k3 -> GroupNorm -> ReLU) layers and a 1x1 conv predicting per
character ``(blanks_before, duplicates)``, scaled by learned ``std`` and
shifted by ``mean`` (initialized to (1.5, 0.5) and (2, 0)).  The final 1x1
conv and ``x * std + mean`` stay float32: the counts feed spacing math.
Inference only: dropout is the identity.

``label_onehot [B, L, C]``, ``style [B, S]`` -> ``[B, L, n_out]``.
"""

from __future__ import annotations

import torch
from torch import nn

from reference.models.layers import GroupNorm, conv


class CountCNN(nn.Module):
    def __init__(self, in_ch: int, hidden: int = 128, n_out: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        widths = (hidden, hidden // 2, hidden // 4)
        self.convs = nn.ModuleList()
        self.norms = nn.ModuleList()
        for w in widths:
            self.convs.append(nn.Conv1d(in_ch, w, 3))
            self.norms.append(GroupNorm(w, dtype))
            in_ch = w
        self.out = nn.Conv1d(in_ch, n_out, 1)
        if n_out == 2:
            mean, std = [2.0, 0.0], [1.5, 0.5]
        else:
            mean, std = [2.0] * n_out, [1.0] * n_out
        self.mean = nn.Parameter(torch.tensor(mean))
        self.std = nn.Parameter(torch.tensor(std))

    def forward(self, label_onehot: torch.Tensor,
                style: torch.Tensor) -> torch.Tensor:
        B, L, _ = label_onehot.shape
        s = style[:, None, :].expand(B, L, style.shape[-1])
        x = torch.cat([label_onehot, s.to(label_onehot.dtype)], dim=-1)
        x = x.to(self.dtype).transpose(1, 2)                    # [B, C, L]
        for c, norm in zip(self.convs, self.norms):
            x = torch.relu(norm(conv(x, c, self.dtype, padding=1)))
        x = conv(x, self.out, torch.float32).transpose(1, 2)    # [B, L, n]
        return x * self.std.float() + self.mean.float()
