"""Generation / interpolation inference API.

Counterpart of ``handwriting_line_generation_tpu/inference/generate.py``:
fixed text + interpolated random styles, two-style interpolation sweeps,
horizontal stretch sweeps, style vector math, per-author sampling and
MTurk-batch rendering.  Deterministic spacing uses zero count/dup jitter.
PyTorch runs eagerly, so there is no per-shape executable cache; every
call runs under ``torch.inference_mode``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from handwriting_line_generation_tpu_torch.charset import Charset
from handwriting_line_generation_tpu_torch.device import resolve_device
from handwriting_line_generation_tpu_torch.models.hw_with_style import (
    HWWithStyle, _flat_style,
)
from handwriting_line_generation_tpu_torch.ops.spacing import (
    insert_spaces, onehot,
)
from handwriting_line_generation_tpu_torch.utils import tracing


class GenerationSession:
    """A model on a device, with the generation modes around it.

    ``device`` defaults to ``cuda`` and raises without a GPU; pass
    ``device="cpu"`` to run on the CPU.  The model is moved there and put in
    eval mode.
    """

    def __init__(self, model: HWWithStyle, charset: Charset,
                 deterministic_spacing: bool = True, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.charset = charset
        self.deterministic_spacing = deterministic_spacing

    # -- core ----------------------------------------------------------

    @torch.inference_mode()
    def forward(self, label: torch.Tensor, lens: torch.Tensor,
                style: torch.Tensor, *, spaced_len: int, seed: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Spacer -> ``insert_spaces`` -> generator on device tensors.
        Returns ``(image [B, 64, 4T, 1] float32, total_len [B])``."""
        cfg = self.model.cfg
        with tracing.span("gen.spacer"):
            counts = self._counts(label, style)
        det = self.deterministic_spacing
        with tracing.span("gen.insert_spaces"):
            spacing_rng = torch.Generator(self.device).manual_seed(seed)
            spaced, total = insert_spaces(
                label, lens, counts, spacing_rng, max_len=spaced_len,
                count_std=0.0 if det else cfg.count_std,
                dup_std=0.0 if det else cfg.dup_std,
                count_duplicates=cfg.spacer.count_duplicates)
        if tracing.enabled():
            # positions the lines fill, against the positions rendered
            tracing.count("gen.spaced_used", total.clamp(max=spaced_len))
            tracing.count("gen.spaced_slots", spaced.numel())
        with tracing.span("gen.generator"):
            noise_rng = torch.Generator(self.device).manual_seed(seed + 1)
            img = self.model.generate_spaced(spaced, style,
                                             generator=noise_rng)
        return img, total

    def _counts(self, label, style):
        # the spacer reads the global style: a packed char-style row is
        # unpacked first (the JAX session passes the packed row, which the
        # spacer's input width rejects)
        return self.model.spacer(
            onehot(label, self.model.cfg.num_class),
            _flat_style(self.model._style_tuple(style)))

    def encode_texts(self, texts: Sequence[str],
                     label_len: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Texts -> ``(labels [B, L], lens [B])`` int64 on the device
        (:meth:`Charset.encode_batch`).  Counts the characters read
        (``gen.prepare_chars``) and those that reach no label, unknown to
        the charset or past ``label_len`` (``gen.prepare_dropped``)."""
        out, lens = self.charset.encode_batch(texts, label_len)
        if tracing.enabled():
            n = sum(map(len, texts))
            tracing.count("gen.prepare_chars", n)
            tracing.count("gen.prepare_dropped", n - int(lens.sum()))
        return (torch.from_numpy(out).to(self.device),
                torch.from_numpy(lens).to(self.device))

    def render(self, texts: Sequence[str], styles: np.ndarray,
               seed: int = 0, spaced_len: Optional[int] = None,
               label_len: Optional[int] = None) -> np.ndarray:
        """texts + styles ``[B, D]`` -> images ``[B, 64, 4*T, 1]``."""
        return self.render_tensor(texts, styles, seed, spaced_len,
                                  label_len).cpu().numpy()

    def render_tensor(self, texts: Sequence[str], styles: np.ndarray,
                      seed: int = 0, spaced_len: Optional[int] = None,
                      label_len: Optional[int] = None) -> torch.Tensor:
        """:meth:`render`, the images left on the device."""
        with tracing.span("gen.request"):
            with tracing.span("gen.prepare"):
                label, lens = self.encode_texts(texts, label_len)
                style = torch.as_tensor(np.asarray(styles, np.float32),
                                        device=self.device)
            if spaced_len is None:
                # spacer mean init ~2 blanks + ~1 dup per char; 6x
                # headroom, rounded up to a multiple of 8
                spaced_len = -(-int(label.shape[1] * 6) // 8) * 8
            img, _ = self.forward(label, lens, style, spaced_len=spaced_len,
                                  seed=seed)
        return img

    # -- modes ---------------------------------------------------------

    def interpolate(self, text: str, style_a: np.ndarray,
                    style_b: np.ndarray, steps: int = 21,
                    seed: int = 0) -> np.ndarray:
        """Style interpolation sweep, mix 0..1."""
        mix = np.linspace(0.0, 1.0, steps)[:, None]
        styles = style_a[None] * (1 - mix) + style_b[None] * mix
        return self.render([text] * steps, styles, seed)

    def random_interpolated(self, texts: Sequence[str], bank: np.ndarray,
                            mix_range: Tuple[float, float] = (-0.5, 1.5),
                            seed: int = 0) -> np.ndarray:
        """Random-pair interpolation of bank styles."""
        rng = np.random.default_rng(seed)
        idx = rng.integers(0, len(bank), size=(len(texts), 2))
        mix = rng.uniform(*mix_range, size=(len(texts), 1))
        styles = bank[idx[:, 0]] * mix + bank[idx[:, 1]] * (1 - mix)
        return self.render(texts, styles, seed)

    @torch.inference_mode()
    def stretch_sweep(self, text: str, style: np.ndarray,
                      factors: Sequence[float] = (0.9, 0.95, 1.0, 1.05, 1.1),
                      seed: int = 0) -> List[np.ndarray]:
        """Horizontal stretch by scaling the predicted blank/dup counts
        before the scatter (one-hots stay exact)."""
        label, lens = self.encode_texts([text])
        cfg = self.model.cfg
        style_t = torch.as_tensor(np.asarray(style, np.float32)[None],
                                  device=self.device)
        counts = self._counts(label, style_t)
        base_len = -(-int(label.shape[1] * 8) // 8) * 8
        outs = []
        for f in factors:
            spaced, _ = insert_spaces(
                label, lens, counts * f, max_len=base_len, count_std=0.0,
                dup_std=0.0, count_duplicates=cfg.spacer.count_duplicates)
            rng = torch.Generator(self.device).manual_seed(seed)
            img = self.model.generate_spaced(spaced, style_t, generator=rng)
            outs.append(img.cpu().numpy())
        return outs

    def style_math(self, text: str, a: np.ndarray, b: np.ndarray,
                   c: np.ndarray, seed: int = 0) -> np.ndarray:
        """Vector arithmetic: render with ``a - b + c``."""
        return self.render([text], (a - b + c)[None], seed)

    def author_samples(self, texts: Sequence[str],
                       by_author: Dict[str, np.ndarray],
                       author: str, seed: int = 0) -> np.ndarray:
        """Random styles of one author."""
        rng = np.random.default_rng(seed)
        bank = by_author[author]
        styles = bank[rng.integers(0, len(bank), size=len(texts))]
        return self.render(texts, styles, seed)

    def mturk_batch(self, texts: Sequence[str], bank: np.ndarray,
                    seed: int = 0) -> List[np.ndarray]:
        """One random-style render per text, returned per line."""
        imgs = self.random_interpolated(texts, bank, seed=seed)
        return [imgs[i] for i in range(len(texts))]


def to_uint8(img: np.ndarray) -> np.ndarray:
    """tanh-range generated image -> display grayscale (ink dark)."""
    return ((1.0 - img[..., 0]) * 127.5).clip(0, 255).astype(np.uint8)


def cast_params_bf16(model: nn.Module) -> nn.Module:
    """Whole-network bfloat16 inference: every float32 parameter and buffer
    becomes bfloat16, norm scales and the spacer's mean/std included (as
    the JAX package's cast of the whole param tree).  Casts in place and
    returns the module."""
    return model.to(torch.bfloat16)
