"""Numpy counterparts of the OpenCV calls of the JAX record sources.

The JAX package decodes, resizes, warps, blurs and draws its lines with
OpenCV (``data/datasets.py``, ``data/synthetic.py``); the port uses neither
OpenCV nor PIL, so each call it needs is here, written after OpenCV's own
conventions:

- :func:`resize_cubic_u8` — ``cv2.resize(img, (0, 0), fx=pct, fy=pct,
  interpolation=INTER_CUBIC)`` on u8: output size ``round(w * pct)``,
  source step ``1 / pct``, cubic weights with a = -0.75 in float32 (OpenCV
  5's; OpenCV 4 rounds them to 11-bit fixed point), edge pixels replicated;
- :func:`resize_linear_f32` — ``cv2.resize(grid, (W, H))`` (``INTER_LINEAR``)
  on float32;
- :func:`remap_linear_u8` — ``cv2.remap(img, xs, ys, INTER_LINEAR,
  borderMode=BORDER_CONSTANT, borderValue=border)`` on u8: float32
  bilinear weights (OpenCV 5's; OpenCV 4 rounds the map to 1/32 pixel and
  weights the taps in fixed point, at most a level apart);
- :func:`gaussian_blur_f32` — ``cv2.GaussianBlur(img, (0, 0), sigma)`` on
  float32: kernel size ``round(8 sigma + 1) | 1``, reflect-101 border;
- :func:`draw_line_aa` / :func:`draw_polyline_aa` — ``cv2.line`` /
  ``cv2.polylines`` with ``LINE_AA`` on a one-channel u8 image: OpenCV's
  anti-aliased line (16-bit sub-pixel coordinates, its filter and slope
  tables, each tap blended twice into the pixel under it, as OpenCV's
  one-channel path does), and for thickness > 1
  its filled quadrilateral with anti-aliased edges and a filled polygonal
  cap at each joint, a thick segment first clipped to the image grown by
  its thickness.  The strokes come out bit-equal to OpenCV 5's in the
  tests; as its source is not at hand, they are held to OpenCV loosely
  (mean and ink-mass bounds), everything else tightly.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Resizing and remapping
# ---------------------------------------------------------------------------



def _cubic_weights(f: np.ndarray) -> np.ndarray:
    """OpenCV's ``interpolateCubic`` (a = -0.75) in float32, ``[n, 4]``."""
    A = np.float32(-0.75)
    x = f.astype(np.float32)
    one = np.float32(1.0)
    c0 = ((A * (x + one) - 5 * A) * (x + one) + 8 * A) * (x + one) - 4 * A
    c1 = ((A + 2) * x - (A + 3)) * x * x + one
    c2 = ((A + 2) * (one - x) - (A + 3)) * (one - x) * (one - x) + one
    c3 = one - c0 - c1 - c2
    return np.stack([c0, c1, c2, c3], axis=1)


def _cubic_taps(n_dst: int, n_src: int, scale: float
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Source indices ``[n_dst, 4]`` (clamped: replicated border) and
    float32 weights ``[n_dst, 4]`` of one axis."""
    f = ((np.arange(n_dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    w = _cubic_weights(f - s.astype(np.float32))
    idx = np.clip(s[:, None] + np.arange(-1, 3), 0, n_src - 1)
    return idx, w


def resize_cubic_u8(img: np.ndarray, pct: float) -> np.ndarray:
    """``cv2.resize(img, (0, 0), fx=pct, fy=pct, INTER_CUBIC)`` of a u8
    ``[H, W]`` image: rows, then columns, in float32, rounded to
    nearest."""
    H, W = img.shape
    dh, dw = int(round(H * pct)), int(round(W * pct))
    if (dh, dw) == (H, W):
        return img.copy()
    yi, wy = _cubic_taps(dh, H, 1.0 / pct)
    xi, wx = _cubic_taps(dw, W, 1.0 / pct)
    src = img.astype(np.float32)
    rows = sum(src[:, xi[:, k]] * wx[:, k] for k in range(4))   # [H, dw]
    out = sum(rows[yi[:, k]] * wy[:, k:k + 1] for k in range(4))
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def resize_cubic_to_u8(img: np.ndarray, size: Tuple[int, int]
                       ) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=INTER_CUBIC)`` of a u8
    ``[H, W]`` image to ``size = (w, h)``: each axis at OpenCV's own scale
    ``src / dst``, columns first, in float32, rounded to nearest."""
    H, W = img.shape
    dw, dh = size
    if (dh, dw) == (H, W):
        return img.copy()
    yi, wy = _cubic_taps(dh, H, H / dh)
    xi, wx = _cubic_taps(dw, W, W / dw)
    src = img.astype(np.float32)
    rows = sum(src[:, xi[:, k]] * wx[:, k] for k in range(4))   # [H, dw]
    out = sum(rows[yi[:, k]] * wy[:, k:k + 1] for k in range(4))
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _linear_taps(n_dst: int, n_src: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Left index, right index and float32 weights ``[n_dst, 2]`` of one
    axis of an ``INTER_LINEAR`` resize to ``n_dst``."""
    scale = n_src / n_dst
    f = ((np.arange(n_dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    low = s < 0
    f[low], s[low] = 0, 0
    high = s >= n_src - 1
    f[high], s[high] = 0, n_src - 1
    w = np.stack([np.float32(1) - f, f], axis=1).astype(np.float32)
    return s, np.minimum(s + 1, n_src - 1), w


def resize_linear_f32(grid: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(grid, (W, H))`` (bilinear) of a float32 ``[h, w]``."""
    W, H = size
    h, w = grid.shape
    g = grid.astype(np.float32)
    x0, x1, wx = _linear_taps(W, w)
    y0, y1, wy = _linear_taps(H, h)
    rows = g[:, x0] * wx[:, 0] + g[:, x1] * wx[:, 1]     # [h, W]
    return (rows[y0] * wy[:, :1] + rows[y1] * wy[:, 1:]).astype(np.float32)


def remap_linear_u8(img: np.ndarray, xs: np.ndarray, ys: np.ndarray,
                    border: int = 255) -> np.ndarray:
    """``cv2.remap(img, xs, ys, INTER_LINEAR, BORDER_CONSTANT, border)`` of
    a u8 ``[H, W]`` image through float32 maps ``[H', W']``: float32
    bilinear weights from each map value's fraction, rows blended first,
    rounded to nearest.  A tap outside the image reads ``border``."""
    H, W = img.shape
    xs, ys = xs.astype(np.float32), ys.astype(np.float32)
    x0, y0 = np.floor(xs), np.floor(ys)
    fx, fy = xs - x0, ys - y0
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    padded = np.full((H + 2, W + 2), border, np.float32)
    padded[1:-1, 1:-1] = img

    def tap(dy, dx):
        return padded[np.clip(y0 + dy, -1, H) + 1, np.clip(x0 + dx, -1, W) + 1]

    one = np.float32(1)
    top = tap(0, 0) * (one - fx) + tap(0, 1) * fx
    bottom = tap(1, 0) * (one - fx) + tap(1, 1) * fx
    out = np.rint(top * (one - fy) + bottom * fy)
    return np.clip(out, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Gaussian blur
# ---------------------------------------------------------------------------


def gaussian_kernel(sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(round(8 sigma + 1) | 1, sigma)`` (the size
    ``GaussianBlur`` picks for a float image), float32."""
    n = int(round(sigma * 8 + 1)) | 1
    x = np.arange(n) - (n - 1) * 0.5
    k = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (k / k.sum()).astype(np.float32)


def _reflect101(n: int, r: int) -> np.ndarray:
    """Indices of ``[-r, n + r)`` folded into ``[0, n)``, OpenCV's
    ``BORDER_REFLECT_101`` (``gfedcb|abcdefgh|gfedcba``)."""
    idx = np.arange(-r, n + r)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * n - 2
    idx = np.mod(idx, period)
    return np.where(idx >= n, period - idx, idx)


def gaussian_blur_f32(img: np.ndarray, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (0, 0), sigma)`` of a float32 ``[H, W]``:
    the separable kernel along rows, then columns, reflect-101 border."""
    k = gaussian_kernel(sigma)
    r = len(k) // 2
    H, W = img.shape
    src = img.astype(np.float32)
    xi = _reflect101(W, r)
    rows = np.zeros((H, W), np.float32)
    for t in range(len(k)):
        rows += src[:, xi[t:t + W]] * k[t]
    yi = _reflect101(H, r)
    out = np.zeros((H, W), np.float32)
    for t in range(len(k)):
        out += rows[yi[t:t + H]] * k[t]
    return out


# ---------------------------------------------------------------------------
# Anti-aliased strokes (OpenCV's drawing.cpp conventions)
# ---------------------------------------------------------------------------

_SHIFT = 16                        # XY_SHIFT: sub-pixel bits
_ONE = 1 << _SHIFT
_SLOPE_CORR = (
    181, 181, 181, 182, 182, 183, 184, 185, 187, 188, 190, 192, 194, 196,
    198, 201, 203, 206, 209, 211, 214, 218, 221, 224, 227, 231, 235, 238,
    242, 246, 250, 254)
_FILTER = (
    168, 177, 185, 194, 202, 210, 218, 224, 231, 236, 241, 246, 249, 252,
    254, 254, 254, 254, 252, 249, 246, 241, 236, 231, 224, 218, 210, 202,
    194, 185, 177, 168, 158, 149, 140, 131, 122, 114, 105, 97, 89, 82, 75,
    68, 62, 56, 50, 45, 40, 36, 32, 28, 25, 22, 19, 16, 14, 12, 11, 9, 8,
    7, 5, 5)


def _cdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(W: int, H: int, p1, p2, shift: int = _SHIFT,
               margin: int = 0):
    """OpenCV's ``clipLine``: the segment clipped to the image grown by
    ``margin`` pixels on each side, coordinates in units of 2^-``shift``
    pixels; None when it misses."""
    lo = -margin << shift
    right = ((W + margin) << shift) - 1
    bottom = ((H + margin) << shift) - 1
    x1, y1 = p1
    x2, y2 = p2
    c1 = (x1 < lo) + (x1 > right) * 2 + (y1 < lo) * 4 + (y1 > bottom) * 8
    c2 = (x2 < lo) + (x2 > right) * 2 + (y2 < lo) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = lo if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < lo) + (x1 > right) * 2
        if c2 & 12:
            a = lo if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < lo) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = lo if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = lo if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return (x1, y1), (x2, y2)


def _line_aa(buf, W: int, H: int, p1, p2, color: int) -> None:
    """OpenCV's ``LineAA`` on a one-channel u8 buffer (``buf[y * W + x]``),
    end points in 16-bit sub-pixel units."""
    clipped = _clip_line(W, H, p1, p2)
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:                                     # x-major
        if dx < 0:
            x1, x2, y1, y2, dy = x2, x1, y2, y1, -dy
        step = _cdiv(dy << _SHIFT, ax | 1)
        x2 += _ONE
        ecount = (x2 >> _SHIFT) - (x1 >> _SHIFT)
        j = -(x1 & (_ONE - 1))
        y1 += ((step * j) >> _SHIFT) + (_ONE >> 1)
        i0 = (x1 >> (_SHIFT - 7)) & 0x78
        j0 = (x2 >> (_SHIFT - 7)) & 0x78
        major, minor = x1 >> _SHIFT, y1
    else:                                           # y-major
        if dy < 0:
            x1, x2, y1, y2, dx = x2, x1, y2, y1, -dx
        step = _cdiv(dx << _SHIFT, ay | 1)
        y2 += _ONE
        ecount = (y2 >> _SHIFT) - (y1 >> _SHIFT)
        j = -(y1 & (_ONE - 1))
        x1 += ((step * j) >> _SHIFT) + (_ONE >> 1)
        i0 = (y1 >> (_SHIFT - 7)) & 0x78
        j0 = (y2 >> (_SHIFT - 7)) & 0x78
        major, minor = y1 >> _SHIFT, x1
    slope = (step >> (_SHIFT - 5)) & 0x3F
    slope ^= 0x3F if step < 0 else 0
    slope = 0x100 if slope & 0x20 else _SLOPE_CORR[slope]
    t0 = slope << 7
    t1 = ((0x78 - i0) | 4) * slope
    t2 = (j0 | 4) * slope
    ep = [0] * 9
    ep[8] = slope
    ep[1] = ep[3] = ((((j0 - i0) & 0x78) | 4) * slope >> 8) & 0x1FF
    ep[2] = (t1 >> 8) & 0x1FF
    ep[4] = ((((j0 - i0) + 0x80) | 4) * slope >> 8) & 0x1FF
    ep[5] = ((t1 + t0) >> 8) & 0x1FF
    ep[6] = (t2 >> 8) & 0x1FF
    ep[7] = ((t2 + t0) >> 8) & 0x1FF
    x_major = ax > ay
    n_major, n_minor = (W, H) if x_major else (H, W)
    scount = 0
    while ecount >= 0:
        if 0 <= major < n_major:
            m = (minor >> _SHIFT) - 1
            corr = ep[(((scount >= 2) + 1) & (scount | 2)) * 3
                      + (((ecount >= 2) + 1) & (ecount | 2))]
            dist = (minor >> (_SHIFT - 5)) & 31
            for k, f in ((0, _FILTER[dist + 32]), (1, _FILTER[dist]),
                         (2, _FILTER[63 - dist])):
                if 0 <= m + k < n_minor:
                    a = (corr * f >> 8) & 0xFF
                    idx = ((m + k) * W + major if x_major
                           else major * W + m + k)
                    v = buf[idx]
                    v += ((color - v) * a + 127) >> 8
                    buf[idx] = v + (((color - v) * a + 127) >> 8)
        major += 1
        minor += step
        scount += 1
        ecount -= 1


def _fill_convex_aa(buf, W: int, H: int, pts, color: int) -> None:
    """OpenCV's ``FillConvexPoly`` with ``LINE_AA`` (points in 16-bit
    sub-pixel units): the edges as anti-aliased lines, then each scanline
    between the edges filled solid."""
    n = len(pts)
    delta = _ONE >> 1
    p0 = pts[-1]
    ymin = ymax = pts[0][1]
    xmin = xmax = pts[0][0]
    imin = 0
    for i, p in enumerate(pts):
        if p[1] < ymin:
            ymin, imin = p[1], i
        ymax = max(ymax, p[1])
        xmax = max(xmax, p[0])
        xmin = min(xmin, p[0])
        _line_aa(buf, W, H, p0, p, color)
        p0 = p
    xmin, xmax = (xmin + delta) >> _SHIFT, (xmax + delta) >> _SHIFT
    ymin, ymax = (ymin + delta) >> _SHIFT, (ymax + delta) >> _SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= W or ymin >= H:
        return
    ymax = min(ymax, H - 1)
    e_idx, e_di = [imin, imin], [1, n - 1]
    e_x, e_dx = [-_ONE, -_ONE], [0, 0]
    e_ye = [ymin, ymin]
    y = ymin
    edges = n
    while True:
        if y < ymax or y == ymin:
            for i in (0, 1):
                if y >= e_ye[i]:
                    idx0 = e_idx[i]
                    idx = idx0 + e_di[i]
                    if idx >= n:
                        idx -= n
                    while edges > 0:
                        edges -= 1
                        ty = (pts[idx][1] + delta) >> _SHIFT
                        if ty > y:
                            xs, xe = pts[idx0][0], pts[idx][0]
                            e_ye[i] = ty
                            e_dx[i] = _cdiv((xe - xs) * 2 + (ty - y),
                                            2 * (ty - y))
                            e_x[i] = xs
                            e_idx[i] = idx
                            break
                        idx0 = idx
                        idx += e_di[i]
                        if idx >= n:
                            idx -= n
                    else:
                        edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if e_x[0] > e_x[1] else (0, 1)
            xx1 = (e_x[left] + _ONE - 1) >> _SHIFT
            xx2 = e_x[right] >> _SHIFT
            if xx2 >= 0 and xx1 < W:
                xx1, xx2 = max(xx1, 0), min(xx2, W - 1)
                if xx2 >= xx1:
                    buf[y * W + xx1:y * W + xx2 + 1] = bytes(
                        [color]) * (xx2 - xx1 + 1)
        e_x[0] += e_dx[0]
        e_x[1] += e_dx[1]
        y += 1
        if y > ymax:
            break


def _disc_aa(buf, W: int, H: int, center, radius: int, color: int) -> None:
    """OpenCV's filled ``EllipseEx`` of a circle (radius in sub-pixel
    units): a polygon with a vertex every 90/30/18/5 degrees by size (90,
    a diamond, up to a radius of 2.5 pixels)."""
    r_px = (radius + (_ONE >> 1)) >> _SHIFT
    step = 90 if r_px < 3 else 30 if r_px < 10 else 18 if r_px < 15 else 5
    cx, cy = center
    pts = []
    for deg in range(0, 360 + step, step):
        rad = math.radians(min(deg, 360))
        pt = (round(cx + radius * math.cos(rad)),
              round(cy + radius * math.sin(rad)))
        if not pts or pts[-1] != pt:
            pts.append(pt)
    if len(pts) == 1:
        pts = [center, center]
    _fill_convex_aa(buf, W, H, pts, color)


def _thick_line(buf, W: int, H: int, p0, p1, color: int, thickness: int,
                caps: int) -> None:
    """OpenCV's ``ThickLine`` with ``LINE_AA`` (end points in whole
    pixels); ``caps`` bit 1 caps ``p0``, bit 2 caps ``p1``.  A thick
    segment is first clipped, in whole pixels, to the image grown by its
    thickness."""
    if thickness > 1:
        clipped = _clip_line(W, H, p0, p1, shift=0, margin=thickness)
        if clipped is None:
            return
        p0, p1 = clipped
    p0 = (p0[0] << _SHIFT, p0[1] << _SHIFT)
    p1 = (p1[0] << _SHIFT, p1[1] << _SHIFT)
    if thickness <= 1:
        _line_aa(buf, W, H, p0, p1, color)
        return
    dx = (p0[0] - p1[0]) / _ONE
    dy = (p1[1] - p0[1]) / _ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    half = thickness << (_SHIFT - 1)
    if abs(r) > 2.220446049250313e-16:
        r = (half + odd * _ONE * 0.5) / math.sqrt(r)
        ox, oy = round(dy * r), round(dx * r)
        _fill_convex_aa(buf, W, H, [
            (p0[0] + ox, p0[1] + oy), (p0[0] - ox, p0[1] - oy),
            (p1[0] - ox, p1[1] - oy), (p1[0] + ox, p1[1] + oy)], color)
    for bit, p in ((1, p0), (2, p1)):
        if caps & bit:
            _disc_aa(buf, W, H, p, half, color)


def _as_buffer(img: np.ndarray):
    if img.dtype != np.uint8 or img.ndim != 2 or not img.flags.c_contiguous:
        raise ValueError("expected a C-contiguous [H, W] uint8 image")
    return memoryview(img).cast("B")


def draw_line_aa(img: np.ndarray, p0: Sequence[int], p1: Sequence[int],
                 value: int, thickness: int = 1) -> np.ndarray:
    """``cv2.line(img, p0, p1, value, thickness, LINE_AA)`` in place on a
    u8 ``[H, W]`` image (points ``(x, y)`` in whole pixels)."""
    H, W = img.shape
    _thick_line(_as_buffer(img), W, H, (int(p0[0]), int(p0[1])),
                (int(p1[0]), int(p1[1])), int(value), int(thickness), 3)
    return img


def draw_polyline_aa(img: np.ndarray, pts: np.ndarray, value: int,
                     thickness: int = 1) -> np.ndarray:
    """``cv2.polylines(img, [pts], False, value, thickness, LINE_AA)`` in
    place on a u8 ``[H, W]`` image (``pts`` ``[n, 2]`` of ``(x, y)``): each
    segment a thick line, the first capped at both ends, the rest at
    their end."""
    H, W = img.shape
    buf = _as_buffer(img)
    pts = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    caps = 3
    for a, b in zip(pts[:-1], pts[1:]):
        _thick_line(buf, W, H, a, b, int(value), int(thickness), caps)
        caps = 2
    return img
