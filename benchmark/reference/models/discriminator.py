"""Multi-scale spectral-norm patch discriminator.

Counterpart of ``handwriting_line_generation_tpu/models/discriminator.py``:
a trunk (a 7x7 conv with group norm, then spectral-norm convs with average
pools) feeding a medium-resolution patch head (``use_med``) and a low
head of 1-D convs on the height-collapsed map (``use_low``); ``use_global``
adds a pooled whole-line score and ``cond`` a projection score
``<embed(style), pooled features>``.  Heights are VALID, so a 64-px input
collapses to 1 at the heads (64 -> 58 -> 56 -> 28 -> 26 -> 24 -> 12 ->
10 -> 5 -> 3 -> 1); widths are SAME-padded and shrink only in the pools.

Returns the per-scale score maps, each flattened to float32 ``[B, N_i]``.
Dropout (0.05 in the trunk, 0.025 in the low head, one draw per sample and
channel) runs only when a ``torch.Generator`` is passed; the JAX GAN
trainer never enables it.  Layers are kept in flax's creation order
(``convs``: ``Conv_<i>``, ``norms``: ``GroupNorm_<i>``, ``sn``:
``SNConv_<i>``) and the forward takes them in that order.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from reference.models.layers import (
    GroupNorm, SNConv, avg_pool, channel_dropout, conv, dense,
)

_LOW = (0, 0, 1, 1)                     # VALID height, SAME width (3 taps)


class DiscriminatorAP(nn.Module):
    def __init__(self, dim: int = 64, use_low: bool = True,
                 use_med: bool = True, small: bool = False,
                 cond: bool = False, use_global: bool = False,
                 leak: float = 0.1, style_dim: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d = dim
        self.use_low, self.use_med, self.small = use_low, use_med, small
        self.cond, self.use_global = cond, use_global
        self.leak, self.dtype = leak, dtype
        self.convs = nn.ModuleList([nn.Conv2d(1, d, 7),
                                    nn.Conv2d(2 * d, 2 * d, 3)])
        self.norms = nn.ModuleList([GroupNorm(d, dtype),
                                    GroupNorm(2 * d, dtype)])
        pv = (1, 1, 1, 1) if small else _LOW
        sn = [SNConv(d, d, (3, 3), pv, dtype),
              SNConv(d, 2 * d, (3, 3), pv, dtype),
              SNConv(2 * d, 2 * d, (3, 3), _LOW, dtype),
              SNConv(2 * d, 4 * d, (3, 3), _LOW, dtype)]
        if use_med:
            sn.append(SNConv(4 * d, 1, (3, 3), _LOW, dtype))
        if use_low:
            sn += [SNConv(4 * d, 2 * d, (3, 3), _LOW, dtype),
                   SNConv(2 * d, 4 * d, (1, 3), _LOW, dtype),
                   SNConv(4 * d, 4 * d, (1, 3), _LOW, dtype),
                   SNConv(4 * d, 4 * d, (1, 3), _LOW, dtype),
                   SNConv(4 * d, 1, (1, 1), (0, 0, 0, 0), dtype)]
        self.sn = nn.ModuleList(sn)
        self.global_fc = self.global_out = self.cond_proj = None
        if use_global:
            self.global_fc = nn.Linear(4 * d, 4 * d)
            self.global_out = nn.Linear(4 * d, 1)
        if cond:
            self.cond_proj = nn.Linear(style_dim, 4 * d, bias=False)

    def forward(self, x: torch.Tensor, style: Optional[torch.Tensor] = None,
                update_u: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        """NHWC ``x [B, 64, W, 1]`` -> list of float32 ``[B, N_i]`` scores.
        ``update_u``: each spectral-norm conv advances its ``u``;
        ``generator``: draws the dropout masks (none without one)."""
        dt = self.dtype
        act = lambda v: F.leaky_relu(v, self.leak)
        drop = lambda v, p: channel_dropout(v, p, generator, True)
        sn: Iterator[SNConv] = iter(self.sn)
        snc = lambda v: next(sn)(v, update_u)
        f32 = lambda v: v.float().reshape(v.shape[0], -1)

        x = x.permute(0, 3, 1, 2).to(dt)
        x = conv(F.pad(x, (3, 3, 0, 0)), self.convs[0], dt)        # H 58
        x = act(self.norms[0](x))
        m = act(snc(x))                                            # 56
        if not self.small:
            m = avg_pool(m, (2, 2))                                # 28
        m = act(drop(snc(m), 0.05))                                # 26
        mL = avg_pool(act(snc(m)), (2, 2))                         # 24 -> 12
        mL = conv(F.pad(mL, (1, 1, 0, 0)), self.convs[1], dt)      # 10
        mL = avg_pool(act(self.norms[1](mL)), (2, 2))              # 5
        mL = act(drop(snc(mL), 0.05))                              # 3

        out: List[torch.Tensor] = []
        if self.use_med:
            out.append(f32(snc(mL)))                               # H 1
        if self.use_low:
            y = act(drop(snc(mL), 0.025))                          # H 1
            y = avg_pool(y, (1, 2))
            y = act(drop(snc(y), 0.025))
            y = act(drop(snc(y), 0.025))
            y = avg_pool(y, (1, 2))
            y = act(drop(snc(y), 0.025))
            out.append(f32(snc(y)))
        if self.use_global or self.cond:
            pooled = mL.mean(dim=(2, 3))                           # [B, 4d]
            if self.use_global:
                g = act(dense(pooled, self.global_fc, dt))
                out.append(dense(g, self.global_out, dt).float())
            if self.cond:
                if style is None:
                    raise ValueError(
                        "cond discriminator needs the conditioning style")
                proj = F.linear(style.to(pooled.dtype),
                                self.cond_proj.weight.to(dt))
                out.append((pooled * proj).sum(-1, keepdim=True).float())
        return out
