"""Synthetic handwriting-like line renderer: a copy of
``handwriting_line_generation_tpu/data/synthetic.py`` with its OpenCV calls
replaced by the numpy ones of :mod:`.imageops` (the random draws are
consumed in the same order, so the corpus records are bit-equal and the
renders agree with the JAX package's as far as the image ops do).  The
strokes are drawn through the module-level ``_draw_line`` and
``_draw_polyline``.

The reference requires the (licensed) IAM/RIMES corpora on disk; this module
provides a self-contained stand-in with the same batch contract so the whole
training/eval stack runs end-to-end without them: every character gets a
deterministic pseudo-glyph (seeded stroke set) and every "author" a
deterministic style (slant, stroke width, jitter, spacing).  HWR can reach
low CER on it and the style extractor has real writer signal to separate,
which is what the framework tests and benches need.

Images follow the reference normalization ``1 - px/128`` => background -1,
ink ~ +1 (``datasets/hw_dataset.py:156-157``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from handwriting_line_generation_tpu_torch.charset import Charset, IAM_CHARSET
from handwriting_line_generation_tpu_torch.data.imageops import (
    draw_line_aa, draw_polyline_aa, gaussian_blur_f32, remap_linear_u8,
    resize_linear_f32,
)

_draw_line = draw_line_aa
_draw_polyline = draw_polyline_aa


def _char_strokes(char_idx: int, n_strokes: int = 4) -> np.ndarray:
    """Deterministic stroke set for a char: [n, 4] of (x0,y0,x1,y1) in [0,1]."""
    rng = np.random.default_rng(1000 + char_idx)
    pts = rng.uniform(0.05, 0.95, size=(n_strokes + 1, 2))
    segs = np.concatenate([pts[:-1], pts[1:]], axis=1)
    return segs


@dataclasses.dataclass
class AuthorStyle:
    slant: float          # shear in x per y
    thickness: int
    width_scale: float
    jitter: float
    spacing: float

    @staticmethod
    def for_author(author_id: int) -> "AuthorStyle":
        rng = np.random.default_rng(7000 + author_id)
        return AuthorStyle(
            slant=float(rng.uniform(-0.35, 0.35)),
            thickness=int(rng.integers(1, 4)),
            width_scale=float(rng.uniform(0.7, 1.3)),
            jitter=float(rng.uniform(0.0, 1.5)),
            spacing=float(rng.uniform(0.5, 2.0)),
        )


def render_line(text: str, charset: Charset, author_id: int = 0,
                img_height: int = 64, seed: int = 0,
                max_width: Optional[int] = None) -> np.ndarray:
    """Render a text line as uint8 grayscale (255 = paper, 0 = ink)."""
    style = AuthorStyle.for_author(author_id)
    rng = np.random.default_rng(seed)
    glyph_h = int(img_height * 0.6)
    glyph_w = int(img_height * 0.45 * style.width_scale)
    space_w = max(2, int(glyph_w * 0.6))
    gap = max(1, int(2 * style.spacing))

    width = sum((space_w if c == " " else glyph_w) + gap for c in text) + 16
    img = np.full((img_height, max(width, 32)), 255, np.uint8)
    y_top = (img_height - glyph_h) // 2
    x = 8
    for c in text:
        idx = charset.char_to_idx.get(c)
        if c == " " or idx is None:
            x += space_w + gap
            continue
        segs = _char_strokes(idx)
        jx = rng.normal(0, style.jitter)
        jy = rng.normal(0, style.jitter)
        for x0, y0, x1, y1 in segs:
            ax = x + x0 * glyph_w + (1 - y0) * style.slant * glyph_h + jx
            bx = x + x1 * glyph_w + (1 - y1) * style.slant * glyph_h + jx
            ay = y_top + y0 * glyph_h + jy
            by = y_top + y1 * glyph_h + jy
            _draw_line(img, (int(round(ax)), int(round(ay))),
                       (int(round(bx)), int(round(by))), 0, style.thickness)
        x += glyph_w + gap
    if max_width is not None and img.shape[1] > max_width:
        img = img[:, :max_width]
    return img


# ---------------------------------------------------------------------------
# v3 "hard" renderer — distribution breadth so a frozen reader lands at
# CER 0.05-0.15 on held-out lines instead of saturating at 0.0 (which makes
# gen-CER stop discriminating generator quality).  Adds per-author allograph
# variants + glyph deformation, curved strokes, baseline wobble, ink-level
# and per-stroke thickness variation, character overlap, and post-render
# elastic warp / brightness / blur / noise at the reference augmentation
# strengths (``utils/grid_distortion.py:11-66`` std 1.5 interval 12,
# ``utils/augmentation.py:5-31`` fg/bg brightness shifts).
# ---------------------------------------------------------------------------

N_ALLOGRAPHS = 4


def _char_strokes_hard(char_idx: int, variant: int,
                       author_id: int) -> np.ndarray:
    """Allograph variant + per-author deformation of a char's strokes."""
    base = _char_strokes(char_idx, n_strokes=5)
    vr = np.random.default_rng(50_000 + char_idx * 131 + variant)
    segs = base + vr.normal(0.0, 0.10, base.shape)
    ar = np.random.default_rng((author_id + 1) * 1_000_003 + char_idx)
    segs = segs + ar.normal(0.0, 0.05, segs.shape)
    return np.clip(segs, 0.0, 1.0)


@dataclasses.dataclass
class HardAuthorStyle:
    slant: float
    thickness: int
    width_scale: float
    jitter: float
    spacing: float
    allograph: np.ndarray   # [n_class] per-char variant choice
    wobble_amp: float       # baseline wobble, fraction of glyph height
    wobble_freq: float      # radians per pixel of x
    wobble_phase: float
    ink: float              # ink gray level (0 = black)
    overlap: float          # fraction of glyph width consumed by overlap
    size_jitter: float      # per-char scale jitter std
    curve: float            # stroke curvature magnitude (fraction of glyph)

    @staticmethod
    def for_author(author_id: int, n_class: int) -> "HardAuthorStyle":
        rng = np.random.default_rng(9_700_000 + author_id)
        return HardAuthorStyle(
            slant=float(rng.uniform(-0.5, 0.5)),
            thickness=int(rng.integers(1, 4)),
            width_scale=float(rng.uniform(0.6, 1.35)),
            jitter=float(rng.uniform(0.0, 1.2)),
            spacing=float(rng.uniform(0.3, 2.0)),
            allograph=rng.integers(0, N_ALLOGRAPHS, size=n_class),
            wobble_amp=float(rng.uniform(0.0, 0.12)),
            wobble_freq=float(rng.uniform(0.01, 0.06)),
            wobble_phase=float(rng.uniform(0, 2 * np.pi)),
            ink=float(rng.uniform(0.0, 80.0)),
            overlap=float(rng.uniform(0.0, 0.18)),
            size_jitter=float(rng.uniform(0.02, 0.10)),
            curve=float(rng.uniform(0.04, 0.16)),
        )


def _bezier_points(p0, p1, ctrl, n: int = 7) -> np.ndarray:
    t = np.linspace(0.0, 1.0, n)[:, None]
    return ((1 - t) ** 2 * p0 + 2 * t * (1 - t) * ctrl + t ** 2 * p1)


def _elastic_warp(img: np.ndarray, rng: np.random.Generator,
                  std: float = 1.5, interval: int = 12) -> np.ndarray:
    H, W = img.shape
    gh, gw = max(2, H // interval), max(2, W // interval)
    dy = resize_linear_f32(rng.normal(0, std, (gh, gw)).astype(np.float32),
                           (W, H))
    dx = resize_linear_f32(rng.normal(0, std, (gh, gw)).astype(np.float32),
                           (W, H))
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    return remap_linear_u8(img, xs + dx, ys + dy, border=255)


def degrade_image(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """The v3 post-render degradation stack: elastic warp + Tensmeyer-ish
    fg/bg brightness shifts + Gaussian blur + sensor noise (strengths from
    the reference augmentations, ``utils/grid_distortion.py:11-66`` and
    ``utils/augmentation.py:5-31``).

    Factored out of :func:`render_line_hard` (identical RNG consumption
    order, so memoized renders are unchanged) so the quality harness can
    apply the SAME degradation domain to generator output before reading it
    back — real v3 lines carry these post-ops while raw generated lines do
    not, which otherwise makes gen-CER land *below* real-line CER.
    """
    img = _elastic_warp(img, rng)
    f = img.astype(np.float32)
    fg_shift = rng.normal(0, 18)         # Tensmeyer-ish fg/bg shifts
    bg_shift = rng.normal(0, 8)
    w = np.clip((f - 100.0) / 110.0, 0.0, 1.0)   # 1 at paper, 0 at ink
    f = f + fg_shift * (1 - w) + bg_shift * w
    sigma = float(rng.uniform(0.0, 0.9))
    if sigma > 0.05:
        f = gaussian_blur_f32(f, sigma)
    f = f + rng.normal(0, rng.uniform(0.0, 5.0), f.shape)
    return np.clip(f, 0, 255).astype(np.uint8)


def render_line_hard(text: str, charset: Charset, author_id: int = 0,
                     img_height: int = 64, seed: int = 0,
                     max_width: Optional[int] = None) -> np.ndarray:
    """Hard-mode line render: uint8 grayscale (255 = paper, ~ink = dark)."""
    style = HardAuthorStyle.for_author(author_id, charset.num_class)
    rng = np.random.default_rng(seed)
    glyph_h = int(img_height * 0.6)
    glyph_w = int(img_height * 0.45 * style.width_scale)
    space_w = max(2, int(glyph_w * 0.6))
    gap = max(1, int(2 * style.spacing))
    adv = max(2, int(glyph_w * (1.0 - style.overlap)) + gap)

    width = sum((space_w + gap if c == " " else adv) for c in text) + 24
    img = np.full((img_height, max(width, 32)), 255, np.uint8)
    y_mid = img_height // 2
    x = 10
    for c in text:
        idx = charset.char_to_idx.get(c)
        if c == " " or idx is None:
            x += space_w + gap
            continue
        segs = _char_strokes_hard(idx, int(style.allograph[idx]), author_id)
        scale = float(np.clip(1.0 + rng.normal(0, style.size_jitter),
                              0.75, 1.3))
        gh, gw = glyph_h * scale, glyph_w * scale
        wob = style.wobble_amp * glyph_h * np.sin(
            style.wobble_freq * x + style.wobble_phase)
        jx = rng.normal(0, style.jitter)
        jy = rng.normal(0, style.jitter) + wob
        y_top = y_mid - gh / 2
        ink = int(np.clip(style.ink + rng.normal(0, 10), 0, 120))
        for x0, y0, x1, y1 in segs:
            p0 = np.array([x + x0 * gw + (1 - y0) * style.slant * gh + jx,
                           y_top + y0 * gh + jy])
            p1 = np.array([x + x1 * gw + (1 - y1) * style.slant * gh + jx,
                           y_top + y1 * gh + jy])
            mid = (p0 + p1) / 2
            d = p1 - p0
            perp = np.array([-d[1], d[0]])
            n = np.linalg.norm(perp)
            if n > 1e-6:
                perp = perp / n
            ctrl = mid + perp * rng.normal(0, style.curve) * gh
            pts = _bezier_points(p0, p1, ctrl).round().astype(np.int32)
            th = max(1, style.thickness + int(rng.integers(-1, 2)))
            _draw_polyline(img, pts, ink, th)
        x += adv
    # post-render: elastic warp + brightness + blur + noise
    img = degrade_image(img, rng)
    if max_width is not None and img.shape[1] > max_width:
        img = img[:, :max_width]
    return img


def normalize_image(img_u8: np.ndarray) -> np.ndarray:
    """uint8 -> float32, reference normalization ``1 - px/128``."""
    return (1.0 - img_u8.astype(np.float32) / 128.0)


def random_text(rng: np.random.Generator, charset: Charset,
                min_len: int = 4, max_len: int = 12) -> str:
    n = int(rng.integers(min_len, max_len + 1))
    chars = list(charset.chars.replace(" ", ""))
    out = []
    for i in range(n):
        if i > 0 and rng.random() < 0.15:
            out.append(" ")
        out.append(str(rng.choice(chars)))
    return "".join(out)[:max_len]


class SyntheticCorpus:
    """Author-grouped synthetic line corpus with a stable line index."""

    def __init__(self, n_authors: int = 8, lines_per_author: int = 24,
                 charset: Charset = IAM_CHARSET, img_height: int = 64,
                 seed: int = 0, min_len: int = 4, max_len: int = 12,
                 version: int = 2, author_offset: int = 0):
        self.charset = charset
        self.img_height = img_height
        self.version = version
        rng = np.random.default_rng(seed)
        self.records: List[Tuple[int, str, int]] = []  # author, text, seed
        for a in range(n_authors):
            for i in range(lines_per_author):
                text = random_text(rng, charset, min_len, max_len)
                self.records.append((a + author_offset, text,
                                     int(rng.integers(1 << 30))))
        # renders are deterministic per record (text+author+seed), so memoize
        # the uint8 render: the v3 renderer costs ~18 ms/line and the
        # batchers re-load every epoch — uncached, the 1-core host starves
        # the chip.  u8 storage keeps a 60x80 corpus under ~200 MB.
        self._cache: Dict[int, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.records)

    def get(self, i: int) -> Tuple[np.ndarray, str, str]:
        author, text, seed = self.records[i]
        img = self._cache.get(i)
        if img is None:
            render = render_line_hard if self.version >= 3 else render_line
            img = render(text, self.charset, author, self.img_height, seed)
            self._cache[i] = img
        return normalize_image(img), text, f"synth{author:05d}"
