"""Character-aware style encoder.

Counterpart of ``handwriting_line_generation_tpu/models/char_style.py``.
Per (sample, class) it takes the top-K highest-score frames whose argmax is
that class, gathers a ``±window`` patch of trunk features around each, runs
the class's own small extractor on every patch (all 79 extractors as one
batched bank: per-class weights stacked on a leading class axis, computed
with batched matmuls, no loop over classes), and averages the results by
score.  A global branch over the whole line joins them in the heads.

Two behaviours of the JAX module that its own comments do not state:

* :class:`StyleTrunk`'s output length is ``T = W/4 - 2``, not ``W/4``: its
  two ``(4, 4)`` blocks of stride ``(2, 1)`` pad W by ``(1, 1)`` and so
  each drop a column (W = 192, 1024, 2048 give T = 46, 254, 510).  The
  recognizer's ``W/4`` frames are therefore always longer, and
  :class:`CharStyleEncoder` always truncates ``recog`` to its first ``T``
  frames (the JAX comment calls the lengths "equal by construction").  The
  port reproduces the truncation, and the edge padding of a shorter
  ``recog``.
* Inside the vmapped extractor, flax's GroupNorm reduces over every axis
  but the batch: the K slots, the window and the channels of a group, per
  (sample, class).  The zero-score slots that fill a class's K (their
  weight is 0) so enter the statistics of the slots that count, and which
  frames fill them matters: ``lax.top_k`` takes ties (all zero scores) by
  lower index, which the port reproduces with a stable descending sort.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from reference.models.layers import (
    ConvBlock, GroupNorm, conv, dense, group_count,
)

RECOG_FLOOR = -30.0          # below any real log-softmax (masked: -1e30)


class StyleTrunk(nn.Module):
    """Conv pyramid collapsing H 64 -> 1; ``[B, 1, 64, W]`` ->
    ``[B, 4*dim, T]`` with ``T = W/4 - 2`` (module docstring)."""

    def __init__(self, dim: int = 64, norm: str = "group", act: str = "relu",
                 pad_type: str = "replicate",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(act=act, pad_type=pad_type, dtype=dtype)
        d = dim
        blocks = [ConvBlock(1, d, (5, 5), padding=(2, 2, 2, 2), norm=norm,
                            **kw)]
        for _ in range(2):
            blocks.append(ConvBlock(d, 2 * d, (4, 4), (2, 2), (1, 1, 1, 1),
                                    norm=norm, **kw))
            d *= 2
            blocks.append(ConvBlock(d, d, (3, 3), padding=(0, 0, 1, 1),
                                    norm=norm, **kw))
        blocks.append(ConvBlock(d, d, (4, 4), (2, 1), (0, 0, 1, 1), norm=norm,
                                **kw))
        blocks.append(ConvBlock(d, d, (4, 4), (2, 1), (0, 0, 1, 1),
                                norm="none", act="none", pad_type=pad_type,
                                dtype=dtype))
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x[:, :, 0, :]


# -- per-class banks: parameters with a leading class axis N ---------------


class BankConv1d(nn.Module):
    """N 1-D convs, weight ``[N, out, in, k]``: ``[N, M, L, in]`` ->
    ``[N, M, L', out]``.  One batched matmul against all k taps at once,
    then the taps' outputs shifted into place and summed."""

    def __init__(self, n: int, in_ch: int, out_ch: int, kernel: int,
                 padding: int):
        super().__init__()
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(n, out_ch, in_ch, kernel))
        self.bias = nn.Parameter(torch.zeros(n, out_ch))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        N, M, L, cin = x.shape
        cout, k, p = self.weight.shape[1], self.weight.shape[3], self.padding
        w = self.weight.to(dtype).permute(0, 2, 3, 1).reshape(N, cin, k * cout)
        y = torch.bmm(x.to(dtype).reshape(N, M * L, cin), w)
        y = F.pad(y.reshape(N, M, L, k, cout), (0, 0, 0, 0, p, p))
        lo = L + 2 * p - k + 1
        out = sum(y[:, :, j:j + lo, j] for j in range(k))
        return out + self.bias.to(dtype)[:, None, None, :]


class BankDense(nn.Module):
    """N dense layers, weight ``[N, in, out]`` (flax's layout):
    ``[N, M, in]`` -> ``[N, M, out]``."""

    def __init__(self, n: int, in_f: int, out_f: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, in_f, out_f))
        self.bias = nn.Parameter(torch.zeros(n, out_f))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return torch.baddbmm(self.bias.to(dtype)[:, None, :], x.to(dtype),
                             self.weight.to(dtype))


class BankGroupNorm(nn.Module):
    """N GroupNorms with flax's semantics (eps 1e-6, one-pass float32
    variance) over ``[N, B, K, L, C]``: statistics per (class, sample) over
    K, L and the channels of a group (the module docstring says why K)."""

    def __init__(self, n: int, channels: int, eps: float = 1e-6):
        super().__init__()
        self.groups, self.eps = group_count(channels), eps
        self.weight = nn.Parameter(torch.ones(n, channels))
        self.bias = nn.Parameter(torch.zeros(n, channels))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        N, B, K, L, C = x.shape
        G = self.groups
        xf = x.float().reshape(N, B, K * L, G, C // G)
        mean = xf.mean(dim=(2, 4), keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=(2, 4), keepdim=True)
                          - mean * mean, min=0.0)
        scale = self.weight.float().reshape(N, 1, 1, G, C // G)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * scale) \
            + self.bias.float().reshape(N, 1, 1, G, C // G)
        return y.reshape(N, B, K, L, C).to(dtype)


class CharExtractorBank(nn.Module):
    """The ``num_class - 1`` per-class extractors (residual 1-D conv, pool,
    FC over one char window) over patches ``[N, B, K, 2w+1, C]`` ->
    ``[N, B, K, out_dim]``.  ``small`` (window < 3): a 1x1 conv; else a
    halving average pool and a VALID 3-conv."""

    def __init__(self, n: int, in_ch: int, dim: int, out_dim: int,
                 small: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.small, self.dtype = small, dtype
        self.conv0 = BankConv1d(n, in_ch, dim, 3, 1)
        self.norm0 = BankGroupNorm(n, dim)
        self.conv1 = BankConv1d(n, dim, in_ch, 3, 1)
        self.conv2 = BankConv1d(n, in_ch, 2 * dim, 1 if small else 3, 0)
        self.norm1 = BankGroupNorm(n, 2 * dim)
        self.dense0 = BankDense(n, 2 * dim, 2 * dim)
        self.dense1 = BankDense(n, 2 * dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        N, B, K, L, C = x.shape
        flat = lambda t: t.reshape(N, B * K, t.shape[-2], t.shape[-1])
        full = lambda t: t.reshape(N, B, K, t.shape[-2], t.shape[-1])
        h = self.conv0(flat(F.relu(x)), dt)
        h = F.relu(self.norm0(full(h), dt))
        h = F.relu(full(self.conv1(flat(h), dt)) + x)
        h = flat(h)
        if not self.small:
            h = F.avg_pool1d(h.transpose(2, 3).reshape(-1, C, L), 2)
            h = h.reshape(N, B * K, C, -1).transpose(2, 3)
        h = F.relu(self.norm1(full(self.conv2(h, dt)), dt))
        h = h.mean(dim=3).reshape(N, B * K, -1)
        h = F.relu(self.dense0(h, dt))
        return self.dense1(h, dt).reshape(N, B, K, -1)


class FillPredBank(nn.Module):
    """Per found class, the styles of all classes from its own
    (``[N, B, csd]`` -> ``[N, B, num_class, csd]``)."""

    def __init__(self, n: int, num_class: int, csd: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_class, self.dtype = num_class, dtype
        self.dense0 = BankDense(n, csd, 2 * csd)
        self.dense1 = BankDense(n, 2 * csd, csd * num_class)

    def forward(self, s: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.dense0(s, self.dtype))
        out = self.dense1(h, self.dtype)
        return out.reshape(out.shape[0], out.shape[1], self.num_class, -1)


class CharStyleEncoder(nn.Module):
    """image ``[B, 64, W, 1]`` and recognizer log-probs ``recog [B, Tr, C]``
    -> ``[B, style_dim]`` float32 (single style, the paper's path), or
    ``(mu, log_sigma)`` with ``vae``, or ``(g_style, spacing_style,
    char_styles [B, num_class, csd])`` when ``char_style_dim > 0``."""

    def __init__(self, num_class: int, style_dim: int = 128,
                 char_style_dim: int = 0, dim: int = 64, char_dim: int = 128,
                 window: int = 2, capacity: int = 16, norm: str = "group",
                 act: str = "relu", pad_type: str = "replicate",
                 average_found_char_style: float = 1.0, vae: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_class, self.style_dim = num_class, style_dim
        self.char_style_dim, self.window = char_style_dim, window
        self.capacity, self.vae, self.dtype = capacity, vae, dtype
        self.mix = average_found_char_style
        csd = self.csd
        c4 = 4 * dim
        n = num_class - 1
        self.trunk = StyleTrunk(dim, norm, act, pad_type, dtype)
        self.bank = CharExtractorBank(n, c4, char_dim, csd, window < 3, dtype)
        if not self.single_style:
            self.fill = FillPredBank(n, num_class, csd, dtype)
        self.global_convs = nn.ModuleList([nn.Conv1d(c4 + num_class, c4, 5),
                                           nn.Conv1d(c4, c4, 3),
                                           nn.Conv1d(c4, c4, 3)])
        self.global_norm = GroupNorm(c4, dtype)
        self.dense0 = nn.Linear(c4 + csd, c4)
        if self.single_style:
            head = 2 * style_dim if vae else style_dim
        else:
            head = style_dim + csd
        self.head = nn.Linear(c4, head)

    @property
    def single_style(self) -> bool:
        return self.char_style_dim == 0

    @property
    def csd(self) -> int:
        return self.style_dim if self.single_style else self.char_style_dim

    def _patches(self, x: torch.Tensor, recog: torch.Tensor):
        """Top-K frames per (sample, class) by score and their zero-padded
        ``±window`` feature patches: ``([N, B, K, 2w+1, C4], scores [B, N,
        K])``, a score 0 where a class has fewer than K frames."""
        B, T, C4 = x.shape
        pred = recog.argmax(dim=-1)                          # [B, T]
        cls = torch.arange(1, self.num_class, device=x.device)
        probs = recog[:, :, 1:].exp().transpose(1, 2)        # [B, N, T]
        score = torch.where(pred[:, None, :] == cls[None, :, None], probs,
                            0.0)
        # lax.top_k order: descending, ties (only zero scores tie, weight 0,
        # but they fill the K slots of the extractor's GroupNorm) by lower
        # frame index — a stable descending sort gives exactly that
        top_scores, top_idx = torch.sort(score, dim=-1, descending=True,
                                         stable=True)
        K = self.capacity
        top_scores, top_idx = top_scores[..., :K], top_idx[..., :K]
        w = self.window
        offs = torch.arange(-w, w + 1, device=x.device)
        pos = top_idx.transpose(0, 1)[..., None] + offs      # [N, B, K, 2w+1]
        valid = (pos >= 0) & (pos < T)
        b_idx = torch.arange(B, device=x.device)[None, :, None, None]
        patches = x[b_idx, pos.clamp(0, T - 1)]              # [N,B,K,2w+1,C4]
        patches = torch.where(valid[..., None], patches, 0.0)
        return patches, top_scores

    def _char_average(self, char_styles: torch.Tensor, wgt: torch.Tensor):
        """Score-weighted average of the crops' styles: ``[B, csd]``
        (single style), or the per-class averages mixed with the fill
        predictions, ``(avg [B, csd], all_char [B, num_class, csd])``."""
        if self.single_style:
            total = torch.einsum("bnk,nbkd->bd", wgt, char_styles)
            denom = wgt.sum(dim=(1, 2))[:, None]
            return torch.where(denom > 0, total / denom.clamp(min=1e-12),
                               total), None
        cls_total = torch.einsum("bnk,nbkd->bnd", wgt, char_styles)
        cls_wsum = wgt.sum(dim=2)                            # [B, N]
        found = cls_wsum > 0
        cls_avg = torch.where(found[..., None],
                              cls_total / cls_wsum.clamp(min=1e-12)[..., None],
                              0.0)
        fills = self.fill(cls_avg.transpose(0, 1))           # [N, B, nc, csd]
        nf = found.sum(dim=1).clamp(min=1)[:, None, None]
        fill_avg = torch.where(found.t()[:, :, None, None], fills,
                               0.0).sum(dim=0) / nf
        own = F.pad(cls_avg, (0, 0, 1, 0))                   # blank row
        found_full = F.pad(found, (1, 0))
        all_char = torch.where(found_full[..., None],
                               own * (1.0 - self.mix) + fill_avg * self.mix,
                               fill_avg)
        return all_char.sum(dim=1) / self.num_class, all_char

    def features(self, image: torch.Tensor, recog: torch.Tensor):
        """Trunk features ``[B, C4, T]`` and ``recog`` floored at -30 and
        cut (or edge-padded) to their ``T`` frames."""
        recog = torch.clamp(recog, min=RECOG_FLOOR)
        x = self.trunk(image.permute(0, 3, 1, 2))            # [B, C4, T]
        T = x.shape[2]
        Tr = recog.shape[1]
        if Tr > T:
            recog = recog[:, :T]
        elif Tr < T:
            recog = torch.cat([recog, recog[:, -1:].expand(
                -1, T - Tr, -1)], dim=1)
        return x, recog

    def char_styles(self, x: torch.Tensor, recog: torch.Tensor):
        """Dispatch and the extractor bank: :meth:`_char_average` of the
        top-K crops' styles."""
        patches, top_scores = self._patches(x.transpose(1, 2), recog)
        char_styles = self.bank(patches)                     # [N, B, K, csd]
        return self._char_average(char_styles.float(), top_scores)

    def forward(self, image: torch.Tensor, recog: torch.Tensor):
        x, recog = self.features(image, recog)
        return self.heads(x, recog, *self.char_styles(x, recog))

    def heads(self, x: torch.Tensor, recog: torch.Tensor,
              avg_char: torch.Tensor, all_char):
        """The global/spacing branch over the whole line, joined with the
        char average in the dense heads."""
        dt = self.dtype
        h = torch.cat([F.relu(x), recog.to(x.dtype).transpose(1, 2)], dim=1)
        h = F.relu(conv(h, self.global_convs[0], dt, padding=2))
        h = F.max_pool1d(h, 2)
        h = conv(h, self.global_convs[1], dt, padding=1)
        h = F.relu(self.global_norm(h))
        h = F.relu(conv(h, self.global_convs[2], dt, padding=1))
        pooled = h.mean(dim=2)                               # [B, C4]
        comb = torch.cat([pooled, avg_char.to(pooled.dtype)], dim=-1)
        comb = F.relu(dense(comb, self.dense0, dt))
        out = dense(comb, self.head, dt).float()
        if self.single_style:
            if self.vae:
                return out[:, :self.style_dim], out[:, self.style_dim:]
            return out
        csd = self.csd
        return out[:, csd:], out[:, :csd], all_char.float()
