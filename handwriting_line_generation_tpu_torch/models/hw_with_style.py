"""Composite handwriting-generation model.

Counterpart of ``handwriting_line_generation_tpu/models/hw_with_style.py``:
the recognizer (``hwr``), the style extractor, the ``generator``, the
``discriminator`` and the ``spacer``, and the flows over them:

* ``generate`` / ``generate_spaced`` — labels + style -> spacer counts ->
  spaced one-hot -> generator image;
* ``recognize`` — HWR log-probs;
* ``extract_style`` — HWR log-probs (masked past each line's ink) and the
  width-concatenated lines of each author -> one style per author, repeated
  per line;
* ``autoencode`` — extract the style, align the prediction to the label
  (``viterbi_align``) and regenerate the line;
* ``discriminate`` — the discriminator's per-scale scores.

Every submodule is built when the config asks for it (the recognizer
unless ``hwr.kind`` is "none", the extractor when ``style.kind`` is
"char", the discriminator when ``discriminator.enabled``); a flow runs only
the ones it needs, so generation never runs the recognizer.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import List, Optional, Tuple

import torch
from torch import nn

from handwriting_line_generation_tpu_torch.config import ModelConfig
from handwriting_line_generation_tpu_torch.models.char_style import \
    CharStyleEncoder
from handwriting_line_generation_tpu_torch.models.count_cnn import CountCNN
from handwriting_line_generation_tpu_torch.models.discriminator import \
    DiscriminatorAP
from handwriting_line_generation_tpu_torch.models.generator import \
    SpacedGenerator
from handwriting_line_generation_tpu_torch.models.hwr import build_hwr
from handwriting_line_generation_tpu_torch.ops import rows
from handwriting_line_generation_tpu_torch.ops.align import viterbi_align
from handwriting_line_generation_tpu_torch.ops.ctc import mask_frames_to_blank
from handwriting_line_generation_tpu_torch.ops.spacing import (
    insert_spaces, onehot,
)
from handwriting_line_generation_tpu_torch.utils import tracing

# the root span of a served reconstruction (``StyleExtractor.reconstruct``)
RECON_ROOT = "recon.request"


def collapse_author_batch(image: torch.Tensor, seq: torch.Tensor,
                          a_batch_size: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Width-concatenate each author's ``a_batch_size`` lines: ``image
    [B, H, W, C]`` -> ``[B/a, H, a*W, C]``, ``seq [B, T, C]`` ->
    ``[B/a, a*T, C]``."""
    B, H, W, C = image.shape
    a = a_batch_size
    img = image.reshape(B // a, a, H, W, C).transpose(1, 2)
    T, Cs = seq.shape[1:]
    return img.reshape(B // a, H, a * W, C), seq.reshape(B // a, a * T, Cs)


class HWWithStyle(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg
        dt = c.torch_compute_dtype()
        self.hwr = build_hwr(c.hwr.kind, c.num_class, c.hwr.norm,
                             c.hwr.small, c.hwr.pad, dt)
        s = c.style
        self.style_extractor = CharStyleEncoder(
            num_class=c.num_class, style_dim=s.style_dim,
            char_style_dim=s.char_style_dim, dim=s.dim, char_dim=s.char_dim,
            window=s.window, capacity=s.char_capacity, norm=s.norm,
            act=s.activ, average_found_char_style=s.average_found_char_style,
            vae=s.vae, dtype=dt) if s.kind == "char" else None
        self.generator = SpacedGenerator(
            num_class=c.num_class, style_dim=c.style.style_dim,
            dim=c.generator.dim, n_style_trans=c.generator.n_style_trans,
            append_style=c.generator.append_style,
            emb_dropout=c.generator.emb_dropout, small=c.generator.small,
            char_style_dim=c.char_cond_dim(),
            fused_epilogue=c.generator.fused_epilogue,
            phase_upsample=c.generator.phase_upsample,
            dtype=dt) if c.generator.kind == "pure" else None
        d = c.discriminator
        self.discriminator = DiscriminatorAP(
            dim=d.dim, use_low=d.use_low, use_med=d.use_med, small=d.small,
            cond=d.cond, use_global=d.use_global, style_dim=s.style_dim,
            dtype=dt) if d.enabled else None
        self.spacer = CountCNN(
            in_ch=c.num_class + c.style.style_dim, hidden=c.spacer.dim,
            n_out=2 if c.spacer.count_duplicates else 1,
            dtype=dt) if c.spacer.enabled else None

    def recognize(self, image: torch.Tensor) -> torch.Tensor:
        """HWR log-probs ``[B, W/4, num_class]`` of ``[B, H, W, 1]``."""
        return self.hwr(image)

    def extract_style(self, image: torch.Tensor, a_batch_size: int = 1,
                      pred: Optional[torch.Tensor] = None,
                      frame_lengths: Optional[torch.Tensor] = None):
        """Style of each group of ``a_batch_size`` consecutive lines (one
        author's), repeated per line.  Returns ``(style, pred)``.

        ``frame_lengths``: recognizer frames past each line's ink width
        become blank, so pad frames neither spike nor feed style crops."""
        with tracing.span("style.recognizer"):
            if pred is None:
                pred = self.hwr(image)
            if frame_lengths is not None:
                pred = mask_frames_to_blank(pred, frame_lengths)
                if tracing.enabled():
                    # recognizer frames inside the lines, against all
                    T = pred.shape[1]
                    tracing.count("style.frames_used",
                                  frame_lengths.clamp(max=T))
                    tracing.count("style.frames_slots", pred.shape[0] * T)
        with tracing.span("style.char_style"):
            img_c, pred_c = collapse_author_batch(image, pred, a_batch_size)
            style = self.style_extractor(img_c, pred_c)
            rep = lambda s: s.repeat_interleave(a_batch_size, dim=0)
            if isinstance(style, tuple):
                return tuple(rep(s) for s in style), pred
            return rep(style), pred

    def autoencode(self, image: torch.Tensor, labels: torch.Tensor,
                   label_lengths: torch.Tensor, a_batch_size: int = 1,
                   spaced_label: Optional[torch.Tensor] = None,
                   frame_lengths: Optional[torch.Tensor] = None,
                   pred: Optional[torch.Tensor] = None,
                   noise: Optional[List[torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None,
                   vae_generator: Optional[torch.Generator] = None,
                   vae_eps: Optional[torch.Tensor] = None):
        """Reconstruct each line in its own extracted style: extract, align
        the prediction to the label (``viterbi_align`` unless
        ``spaced_label`` is given), regenerate.  Returns ``(image [B, 64,
        4T, 1], aux)`` with aux's ``style``, ``pred`` and ``spaced_label``.

        ``pred``: the recognizer's unmasked log-probs of ``image``, when the
        caller has them (not recomputed).  ``noise`` / ``generator``: the
        generator's noise planes, as in :meth:`generate_spaced`.  A VAE
        extractor regenerates from ``mu + exp(log_sigma) * eps``, ``eps``
        given as ``vae_eps`` or drawn from ``vae_generator``, when either is
        given, and from ``mu`` otherwise; aux keeps ``(mu, log_sigma)``."""
        style, pred = self.extract_style(image, a_batch_size, pred=pred,
                                         frame_lengths=frame_lengths)
        if self.cfg.style.vae and (vae_generator is not None
                                   or vae_eps is not None):
            mu, log_sigma = style
            eps = (rows.randn(mu.shape, vae_generator, device=mu.device,
                              dtype=mu.dtype)
                   if vae_eps is None else vae_eps.to(mu))
            gen_style = mu + torch.exp(log_sigma) * eps
        else:
            gen_style = _flat_style(style)
        # a served reconstruction's spans and counters carry its root's
        # prefix; elsewhere the alignment keeps the name the GAN lessons'
        # trace reads
        served = tracing.root() == RECON_ROOT
        if spaced_label is None:       # discrete: no gradient flows
            with tracing.span("recon.align" if served
                              else "gan.viterbi_align"):
                spaced_label = viterbi_align(pred.detach(), labels,
                                             label_lengths)
            if served:
                # lattice states inside the labels, against all the
                # recursion carries, and its steps (viterbi_align counts
                # recon.align_launches, the kernel's launches)
                tracing.count("recon.lattice_used",
                              2 * label_lengths.long() + 1)
                tracing.count("recon.lattice_slots",
                              labels.shape[0] * (2 * labels.shape[1] + 1))
                tracing.count("recon.align_steps", pred.shape[1] - 1)
        with tracing.span("recon.generator") if served else nullcontext():
            recon = self.generator(
                onehot(spaced_label, self.cfg.num_class), gen_style,
                noise=noise,
                spaced_style=self._spaced_style(spaced_label, style),
                generator=generator)
        return recon, {"style": style, "pred": pred,
                       "spaced_label": spaced_label}

    def discriminate(self, image: torch.Tensor,
                     style: Optional[torch.Tensor] = None,
                     update_u: bool = True,
                     generator: Optional[torch.Generator] = None
                     ) -> List[torch.Tensor]:
        """Per-scale float32 scores ``[B, N_i]`` of ``[B, 64, W, 1]``
        images; each spectral-norm conv advances its ``u`` when
        ``update_u``.  ``style``: the conditioning style of a ``cond``
        discriminator; ``generator``: dropout masks (off without one)."""
        return self.discriminator(image, style=style, update_u=update_u,
                                  generator=generator)

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
