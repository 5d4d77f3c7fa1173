"""Composite handwriting-generation model: the generation flows.

Counterpart of ``handwriting_line_generation_tpu/models/hw_with_style.py``.
This slice ports the ``spacer`` and the ``generator`` and the flows that
need only them: ``space``, ``generate`` and ``generate_spaced``, plus the
style packing helpers.  The recognizer, style extractor and discriminator
come with later slices (ROADMAP.md).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from handwriting_line_generation_tpu_torch.config import ModelConfig
from handwriting_line_generation_tpu_torch.models.count_cnn import CountCNN
from handwriting_line_generation_tpu_torch.models.generator import \
    SpacedGenerator
from handwriting_line_generation_tpu_torch.ops.spacing import (
    insert_spaces, onehot,
)


class HWWithStyle(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg
        dt = c.torch_compute_dtype()
        self.generator = SpacedGenerator(
            num_class=c.num_class, style_dim=c.style.style_dim,
            dim=c.generator.dim, n_style_trans=c.generator.n_style_trans,
            append_style=c.generator.append_style,
            emb_dropout=c.generator.emb_dropout, small=c.generator.small,
            char_style_dim=c.char_cond_dim(),
            fused_epilogue=c.generator.fused_epilogue,
            phase_upsample=c.generator.phase_upsample,
            dtype=dt) if c.generator.kind == "pure" else None
        self.spacer = CountCNN(
            in_ch=c.num_class + c.style.style_dim, hidden=c.spacer.dim,
            n_out=2 if c.spacer.count_duplicates else 1,
            dtype=dt) if c.spacer.enabled else None

    def space(self, labels, label_lengths, style, *, spaced_len: int,
              generator: Optional[torch.Generator] = None, normals=None):
        """Spacer counts + jittered scatter -> spaced class map ``[B, T]``."""
        c = self.cfg
        counts = self.spacer(onehot(labels, c.num_class), _flat_style(style))
        spaced, total = insert_spaces(
            labels, label_lengths, counts, generator, max_len=spaced_len,
            count_std=c.count_std, dup_std=c.dup_std,
            count_duplicates=c.spacer.count_duplicates, normals=normals)
        return spaced, {"counts": counts, "total_len": total}

    def _style_tuple(self, style):
        """Unpack flat bank rows to tuples when the extractor is tuple-style
        (the packed layout of :func:`pack_style`)."""
        c = self.cfg
        if (c.style.char_style_dim > 0 and not isinstance(style, tuple)
                and style.shape[-1] == c.packed_style_dim()):
            return unpack_style(style, c.style.style_dim,
                                c.style.char_style_dim, c.num_class)
        return style

    def _spaced_style(self, spaced, style):
        if self.cfg.char_cond_dim() == 0:
            return None
        style = self._style_tuple(style)
        if not isinstance(style, tuple):
            raise ValueError("char-conditioned generator needs tuple styles")
        return space_style(spaced, style)

    def generate(self, labels, label_lengths, style, *, spaced_len: int,
                 generator: Optional[torch.Generator] = None,
                 normals=None, noise: Optional[List[torch.Tensor]] = None):
        """Text -> image: spacer, ``insert_spaces``, generator.  Returns
        ``(image [B, 64, 4T, 1], aux)``.  ``generator`` draws the count
        jitter and the noise planes unless ``normals`` / ``noise`` give
        them."""
        style = self._style_tuple(style)
        spaced, aux = self.space(labels, label_lengths, style,
                                 spaced_len=spaced_len, generator=generator,
                                 normals=normals)
        img = self.generate_spaced(spaced, style, noise=noise,
                                   generator=generator)
        aux["spaced"] = spaced
        return img, aux

    def generate_spaced(self, spaced, style,
                        noise: Optional[List[torch.Tensor]] = None,
                        generator: Optional[torch.Generator] = None):
        """Generator on a precomputed spaced class map ``[B, T]``."""
        style = self._style_tuple(style)
        return self.generator(onehot(spaced, self.cfg.num_class),
                              _flat_style(style), noise=noise,
                              spaced_style=self._spaced_style(spaced, style),
                              generator=generator)


def _flat_style(style):
    """Tuple styles use the global component for broadcast consumers."""
    return style[0] if isinstance(style, tuple) else style


def space_style(spaced: torch.Tensor,
                style: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
                ) -> torch.Tensor:
    """Per-position placement of tuple styles ``(g, spacing [B, D],
    char [B, num_class, D])``: a position holding character ``c`` gets
    ``char[b, c]``, every blank position gets ``spacing[b]``.  ``[B, T, D]``.
    """
    _, spacing, char = style
    idx = spaced.long()[:, :, None].expand(-1, -1, char.shape[-1])
    gathered = torch.gather(char, 1, idx)
    return torch.where((spaced != 0)[:, :, None], gathered,
                       spacing[:, None, :])


def pack_style(style) -> torch.Tensor:
    """Flatten a style (or tuple) to one bank row ``[B, D_packed]``:
    ``[g | spacing | char.flat]``; VAE ``(mu, log_sigma)`` stores mu."""
    if not isinstance(style, tuple):
        return style
    if len(style) == 2:
        return style[0]
    g, spacing, char = style
    return torch.cat([g, spacing, char.reshape(char.shape[0], -1)], dim=-1)


def unpack_style(flat: torch.Tensor, style_dim: int, char_style_dim: int,
                 num_class: int):
    """Inverse of :func:`pack_style` (identity when ``char_style_dim==0``)."""
    if char_style_dim == 0:
        return flat
    g = flat[:, :style_dim]
    spacing = flat[:, style_dim:style_dim + char_style_dim]
    char = flat[:, style_dim + char_style_dim:].reshape(
        flat.shape[0], num_class, char_style_dim)
    return g, spacing, char
