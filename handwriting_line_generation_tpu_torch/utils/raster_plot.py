"""A small RGB raster canvas for the port's plots, on numpy alone.

The JAX package draws its training curves and style maps with matplotlib,
which the port does not use.  :class:`Canvas` draws what those plots need
on a ``[H, W, 3]`` uint8 image: an axis frame with ticks at "nice" steps
and numeric labels, anti-aliased polylines and filled dots (OpenCV's
``LINE_AA`` rasterizers of ``data/imageops.py``, blended by coverage),
grey thumbnails pasted at data positions (area-averaged to their zoom), a
legend in the corner that covers the least data, and text in a built-in
bitmap font.

The geometry follows matplotlib's defaults, and is the contract (no pixel
of matplotlib's own rendering is): the axes occupy the figure fraction
``[0.125, 0.9] x [0.11, 0.88]`` (its default subplot parameters); the
limits are the data's with a 5% margin on each side (:func:`data_limits`);
and a data point ``(x, y)`` lies at pixel ``(round(x0 + (x - xmin) (x1 -
x0) / (xmax - xmin)), round(y1 - (y - ymin) (y1 - y0) / (ymax - ymin)))``,
``x0, x1`` the axes' left and right pixel columns and ``y0, y1`` its top
and bottom rows (:meth:`Canvas.transform`).

The font: the 95 printable ASCII characters in cells of 11 x 13 pixels,
the Hershey "plain" glyphs rasterized at 0.85 scale, one pixel wide,
centred in their cell (:data:`FONT`, ``bool [95, 13, 11]``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from handwriting_line_generation_tpu_torch.data.imageops import (
    _ONE, _as_buffer, _disc_aa, draw_polyline_aa,
)
from handwriting_line_generation_tpu_torch.utils.png import write_png_rgb

# matplotlib's default subplot parameters: the axes' figure fractions
AXES_RECT = (0.125, 0.11, 0.9, 0.88)           # left, bottom, right, top
MARGIN = 0.05                                  # axes.xmargin / ymargin
GLYPH_H, GLYPH_W = 13, 11
_FONT_HEX = (
    "000000000000000000000000000000000000000",
    "030030030030030030030030070070000000000",
    "0f80f80f8058000000000000000000000000000",
    "06c06c1fe1fe0dc0d83fe3fe0d80d8000000000",
    "1f81fc39c3c01f00fc01c38c3fc1fc070060000",
    "3ce7ce6dc6f87f01fe0fe1f63be31e00c000000",
    "1f03f03303f01ec3ec77c73c7fc3fe0c0000000",
    "070070070020000000000000000000000000000",
    "0700e00e00c00c00c00c00e00e0060078038000",
    "0700300300300300300300300300700f00e0000",
    "0f81f81f80f00f0000000000000000000000000",
    "0000000600600603fe3fe060060060000000000",
    "000000000000000000000000030070070060000",
    "0000000000000001f81f8000000000000000000",
    "000000000000000000000000070070000000000",
    "01c0180380300700600e00e00c01c0180180000",
    "0f81fc3bc3bc3fc3ec3ec3dc1fc1f8060000000",
    "0701f01f01f00700700700701fc1fc000000000",
    "0f81fc19c19c03c0780f01e03fc3fc000000000",
    "1fc1fc0380700f80fc01c38c3fc1fc060000000",
    "0380780780f81d83983fe3fe018018000000000",
    "1fc1fc1801f01fc1dc00c38c3fc1f8060000000",
    "0300700e01f81fc3dc38c38c1fc1f8060000000",
    "1fc1fc01c0380380300700700e00e0000000000",
    "1f81fc18c1dc1fc1fc38c38c3fc1fc060000000",
    "1f81fc39c38c39c1fc0f80700700e0000000000",
    "000000000070070030000000070070000000000",
    "000000000030030030000000030030070020000",
    "0000080380781f01c01e00f8038018000000000",
    "0000000000fc1fc0000001fc0fc000000000000",
    "0000801c00f007803c03c0f81e01c0000000000",
    "0fc1fc1cc19c03c038030030070070000000000",
    "0781fe3cf37f7fb6db6db7ff3ff3a63fe0fc000",
    "0e00f01f01f01b83b83f87fc70c60e000000000",
    "3f83fc31c31c3f83fc31c31c3fc3f8000000000",
    "0fc1fe18e38638038038618e1fe1fc030000000",
    "3f83fc31c31c30c30c30c31c3fc3f8000000000",
    "1fc1fc1801801fc1fc1801801fc1fc000000000",
    "1fc1fc1801801fc1fc180180180180000000000",
    "0fc1fe18e3863be3be38618e1fe0fc030000000",
    "30c30c30c30c3fc3fc30c30c30c30c000000000",
    "060060060060060060060060060060000000000",
    "1fc1fc00c00c00c00c30c39c3fc1f8060000000",
    "3383783f03e03c03c03e03f037833c000000000",
    "1801801801801801801801801fc1fc000000000",
    "30638e38e3de3de3fe376376306306000000000",
    "30c38c3cc3cc3ec37c37c33c33c31c000000000",
    "0fc1fe1ce38e38638638e18e1fe1fc030000000",
    "3f83fc31c31c33c3f83f0300300300000000000",
    "0fc1fe1ce38e38638638e18e1fc1fe03e000000",
    "3f83f831c31c3fc3f83f033831c31c000000000",
    "1f81fc39c3c01f00fc01c38e3fc1fc070000000",
    "3fc3fc060060060060060060060060000000000",
    "30c30c30c30c30c30c30c31c3fc1f8060000000",
    "30638e38e18c1dc0dc0f80f8078070000000000",
    "7037077773773763fe3de3de1de1cc000000000",
    "38e39e1dc0f80f00f00f81dc3dc38e000000000",
    "38e38e1dc1dc0f8070070070070070000000000",
    "3fc3fc03c0380700f01e01c03fc3fc000000000",
    "0f00c00c00c00c00c00c00c00c00c00c00f00f0",
    "1c00c00e00e006007003003803801801c00c000",
    "0f00300300300300300300300300300300f00f0",
    "0f01f8000000000000000000000000000000000",
    "0000000000000000000000000007fe7fe000000",
    "0f0070000000000000000000000000000000000",
    "0000000780fc0cc07c0fc1cc1fc1fc060000000",
    "1801801f01f81dc18c18c18c1fc1f8030000000",
    "0000000f01f83dc39838039c1f81f8060000000",
    "01c01c0fc1fc3bc39c39c39c3fc1fc060000000",
    "0000000f01f83983fc3fc3801f81f8060000000",
    "0f80e01f81f80e00e00e00e00e00e0000000000",
    "0000000fc1fc3bc39c39c39c3fc1fc3dc3f81f8",
    "1801801f01f81fc19c18c18c18c18c000000000",
    "070070030030030030030030030030000000000",
    "030030030030030030030030030030030070060",
    "1801801981f81f01e01e01f01f81b8000000000",
    "060060060060060060060060060060000000000",
    "0000007de7ff7f7667663663663663000000000",
    "0000001f01f81fc19c18c18c18c18c000000000",
    "0000000f01f83fc39c39c39c1f81f8060000000",
    "0000001f01f81dc18c18c18c1fc1f81b0180180",
    "0000000fc1fc3fc39c39c39c3fc1fc07c01c01c",
    "0000000f80f80e00c00c00c00c00c0000000000",
    "0000000f00fc1dc1f00fc03c1dc1fc070000000",
    "0c00c01f01f00c00c00c00e00f0078000000000",
    "00000018c38c38c38c38c39c1fc1fc060000000",
    "00000030c39c3981b81f80f00f00e0000000000",
    "00000063367377737f3fe3de1de1dc000000000",
    "0000003183b81f81f00f01f03f839c000000000",
    "00000030c39c3981b81f80f00f00e00e00c00c0",
    "0000001fc1fc03c0780700e01fc1fc000000000",
    "0780700600600e00e00e0060060070078038018",
    "060060060060060060060060060060060060060",
    "0f00700300300380380380300300300700e00c0",
    "0000000000000001fc1fc000000000000000000",)
FONT = np.array([[[(int(row[3 * r:3 * r + 3], 16) >> (GLYPH_W - 1 - c)) & 1
                   for c in range(GLYPH_W)] for r in range(GLYPH_H)]
                 for row in _FONT_HEX], bool)
BLACK = (0, 0, 0)
GREY = (204, 204, 204)


def data_limits(values: Sequence[float], margin: float = MARGIN
                ) -> Tuple[float, float]:
    """``(lo, hi)``: the values' range widened by ``margin`` of its span
    on each side (a single value, or none, by 0.5 either way, then the
    margin)."""
    v = np.asarray(values, np.float64).ravel()
    v = v[np.isfinite(v)]
    lo, hi = (float(v.min()), float(v.max())) if v.size else (0.0, 0.0)
    if hi == lo:
        lo, hi = lo - 0.5, hi + 0.5
    pad = (hi - lo) * margin
    return lo - pad, hi + pad


def nice_ticks(lo: float, hi: float, max_ticks: int = 9) -> List[float]:
    """Tick values inside ``[lo, hi]`` at the smallest step of the form
    ``{1, 2, 2.5, 5} x 10^k`` that gives at most ``max_ticks`` of them."""
    span = hi - lo
    base = 10.0 ** math.floor(math.log10(span / max_ticks))
    for mult in (1, 2, 2.5, 5, 10, 20):
        step = mult * base
        first = math.ceil(lo / step - 1e-9)
        last = math.floor(hi / step + 1e-9)
        if last - first + 1 <= max_ticks:
            break
    return [round(k * step, 12) for k in range(first, last + 1)]


def tick_label(value: float, ticks: Sequence[float]) -> str:
    """``value`` with as many decimals as the ticks' step needs."""
    step = abs(ticks[1] - ticks[0]) if len(ticks) > 1 else 1.0
    decimals = 0
    while decimals < 10 and abs(round(step, decimals) - step) > 1e-9 * step:
        decimals += 1
    text = f"{value:.{decimals}f}"
    return "0" if float(text) == 0 else text


def area_resize(img: np.ndarray, zoom: float) -> np.ndarray:
    """``[H, W]`` uint8 scaled by ``zoom`` (<= 1): each output pixel the
    mean of the input area it covers, fractional edges weighted."""
    H, W = img.shape
    h, w = max(1, round(H * zoom)), max(1, round(W * zoom))

    def weights(n_out, n_in):
        edges = np.arange(n_out + 1) * (n_in / n_out)
        lo, hi = edges[:-1, None], edges[1:, None]
        px = np.arange(n_in)[None, :]
        m = np.clip(np.minimum(hi, px + 1) - np.maximum(lo, px), 0, None)
        return m / m.sum(1, keepdims=True)
    out = weights(h, H) @ img.astype(np.float64) @ weights(w, W).T
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


class Canvas:
    """A white ``height x width`` RGB image with axes mapping
    ``xlim`` x ``ylim`` (see the module's transform)."""

    def __init__(self, width: int, height: int, xlim: Tuple[float, float],
                 ylim: Tuple[float, float]):
        self.img = np.full((height, width, 3), 255, np.uint8)
        left, bottom, right, top = AXES_RECT
        self.x0, self.x1 = round(left * width), round(right * width)
        self.y0, self.y1 = (round((1 - top) * height),
                            round((1 - bottom) * height))
        self.xlim, self.ylim = tuple(map(float, xlim)), tuple(map(float, ylim))

    # -- geometry ----------------------------------------------------------

    def transform(self, x, y) -> Tuple[np.ndarray, np.ndarray]:
        """Pixel columns and rows of the data points ``(x, y)``."""
        (xa, xb), (ya, yb) = self.xlim, self.ylim
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        px = self.x0 + (x - xa) * (self.x1 - self.x0) / (xb - xa)
        py = self.y1 - (y - ya) * (self.y1 - self.y0) / (yb - ya)
        return np.rint(px).astype(np.int64), np.rint(py).astype(np.int64)

    # -- drawing -----------------------------------------------------------

    def _blend(self, coverage: np.ndarray, color) -> None:
        """Lay ``color`` over the image with ``coverage`` (u8, 255 = all)."""
        a = coverage[..., None].astype(np.float32) / 255.0
        mixed = self.img * (1 - a) + np.asarray(color, np.float32) * a
        self.img[:] = np.rint(mixed).astype(np.uint8)

    def _mask(self) -> np.ndarray:
        return np.zeros(self.img.shape[:2], np.uint8)

    def polyline(self, x, y, color, thickness: int = 1) -> None:
        """An anti-aliased polyline through the data points; a single
        point as a dot of 1.5 pixels' radius (matplotlib draws nothing for
        a one-point line without markers, which would hide the sample)."""
        if len(x) == 1:
            self.scatter(x, y, color, radius=1.5)
            return
        px, py = self.transform(x, y)
        m = self._mask()
        draw_polyline_aa(m, np.stack([px, py], 1), 255, thickness)
        self._blend(m, color)

    def scatter(self, x, y, color, radius: float = 2.9) -> None:
        """A filled anti-aliased dot of ``radius`` pixels at each point."""
        px, py = self.transform(x, y)
        m = self._mask()
        H, W = m.shape
        buf = _as_buffer(m)
        for cx, cy in zip(px.tolist(), py.tolist()):
            _disc_aa(buf, W, H, (cx * _ONE, cy * _ONE),
                     round(radius * _ONE), 255)
        self._blend(m, color)

    def rect_px(self, c0: int, r0: int, c1: int, r1: int, color,
                fill=None) -> None:
        """An axis-aligned rectangle (inclusive pixel corners), its outline
        in ``color`` and inside in ``fill`` when given."""
        H, W = self.img.shape[:2]
        c0, c1 = max(c0, 0), min(c1, W - 1)
        r0, r1 = max(r0, 0), min(r1, H - 1)
        if fill is not None:
            self.img[r0:r1 + 1, c0:c1 + 1] = fill
        self.img[r0, c0:c1 + 1] = self.img[r1, c0:c1 + 1] = color
        self.img[r0:r1 + 1, c0] = self.img[r0:r1 + 1, c1] = color

    def image(self, gray: np.ndarray, x: float, y: float,
              zoom: float = 1.0) -> None:
        """``gray`` (``[h, w]`` uint8) scaled by ``zoom`` (area average)
        and pasted centred on the data point ``(x, y)``, clipped to the
        canvas."""
        g = area_resize(np.asarray(gray, np.uint8), zoom) if zoom != 1 \
            else np.asarray(gray, np.uint8)
        px, py = self.transform([x], [y])
        h, w = g.shape
        r0, c0 = int(py[0]) - h // 2, int(px[0]) - w // 2
        H, W = self.img.shape[:2]
        rs, cs = max(r0, 0), max(c0, 0)
        re, ce = min(r0 + h, H), min(c0 + w, W)
        if rs < re and cs < ce:
            self.img[rs:re, cs:ce] = g[rs - r0:re - r0, cs - c0:ce - c0,
                                       None]

    def text(self, col: int, row: int, s: str, color=BLACK,
             anchor: str = "lt") -> None:
        """``s`` in the bitmap font; ``anchor``: horizontal ``l``/``c``/
        ``r`` and vertical ``t``/``m``/``b`` of the box at ``(col, row)``.
        Characters outside printable ASCII print as ``?``."""
        w, h = GLYPH_W * len(s), GLYPH_H
        col -= {"l": 0, "c": w // 2, "r": w}[anchor[0]]
        row -= {"t": 0, "m": h // 2, "b": h}[anchor[1]]
        H, W = self.img.shape[:2]
        for i, ch in enumerate(s):
            code = ord(ch) - 32 if 32 <= ord(ch) < 127 else ord("?") - 32
            g = FONT[code]
            c = col + i * GLYPH_W
            rs, cs = max(row, 0), max(c, 0)
            re, ce = min(row + GLYPH_H, H), min(c + GLYPH_W, W)
            if rs >= re or cs >= ce:
                continue
            on = g[rs - row:re - row, cs - c:ce - c]
            self.img[rs:re, cs:ce][on] = color

    def frame(self, xlabel: Optional[str] = None,
              ylabel: Optional[str] = None) -> None:
        """The axes' box, outward ticks at :func:`nice_ticks` of each axis
        with their labels, and the axis labels."""
        x0, x1, y0, y1 = self.x0, self.x1, self.y0, self.y1
        self.rect_px(x0, y0, x1, y1, BLACK)
        tick = 5
        xt = nice_ticks(*self.xlim)
        for v, c in zip(xt, self.transform(xt, [self.ylim[0]] * len(xt))[0]):
            self.img[y1:y1 + tick, c] = BLACK
            self.text(int(c), y1 + tick + 2, tick_label(v, xt), anchor="ct")
        yt = nice_ticks(*self.ylim)
        for v, r in zip(yt, self.transform([self.xlim[0]] * len(yt), yt)[1]):
            self.img[r, x0 - tick + 1:x0 + 1] = BLACK
            self.text(x0 - tick - 3, int(r), tick_label(v, yt), anchor="rm")
        if xlabel:
            self.text((x0 + x1) // 2, y1 + tick + GLYPH_H + 8, xlabel,
                      anchor="ct")
        if ylabel:
            self.text(x0, y0 - 4, ylabel, anchor="lb")

    def legend(self, entries: Sequence[Tuple[str, tuple, str]],
               avoid: Optional[Tuple[np.ndarray, np.ndarray]] = None
               ) -> Tuple[int, int, int, int]:
        """A legend, one row a ``(label, color, kind)`` (``kind``
        ``"line"`` or ``"dot"``), in the axes corner that covers the fewest
        of the pixels ``avoid`` (``(cols, rows)``; ties, and no ``avoid``,
        in the order upper right, upper left, lower left, lower right), as
        matplotlib's ``loc="best"`` keeps clear of the data; returns its
        box ``(col0, row0, col1, row1)``."""
        if not entries:
            return (0, 0, 0, 0)
        sw, pad, gap = 20, 5, 4
        width = sw + gap + GLYPH_W * max(len(e[0]) for e in entries) + 2 * pad
        height = len(entries) * (GLYPH_H + 2) + 2 * pad
        left, right = self.x0 + 6, self.x1 - 6 - width
        top, bottom = self.y0 + 6, self.y1 - 6 - height
        boxes = [(c, r, c + width, r + height) for c, r in (
            (right, top), (left, top), (left, bottom), (right, bottom))]
        if avoid is not None:
            cols, rows = (np.asarray(a) for a in avoid)
            inside = lambda b: int(((cols >= b[0]) & (cols <= b[2])
                                    & (rows >= b[1]) & (rows <= b[3])).sum())
            boxes.sort(key=inside)
        c0, r0, c1, r1 = boxes[0]
        self.rect_px(c0, r0, c1, r1, GREY, fill=(255, 255, 255))
        for i, (label, color, kind) in enumerate(entries):
            mid = r0 + pad + i * (GLYPH_H + 2) + GLYPH_H // 2
            if kind == "dot":
                m = self._mask()
                _disc_aa(_as_buffer(m), m.shape[1], m.shape[0],
                         ((c0 + pad + sw // 2) * _ONE, mid * _ONE),
                         round(2.9 * _ONE), 255)
                self._blend(m, color)
            else:
                self.img[mid - 1:mid + 1, c0 + pad:c0 + pad + sw] = color
            self.text(c0 + pad + sw + gap, mid, label, anchor="lm")
        return c0, r0, c1, r1

    def save(self, path: str) -> None:
        write_png_rgb(path, self.img)
