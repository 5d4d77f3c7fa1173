"""PNG on ``zlib``: an 8-bit grayscale writer for the GAN's sample strips,
and a reader that decodes any PNG, interlaced (Adam7) or not, to 8-bit
grey as ``cv2.imread(path, 0)`` does (the port uses neither OpenCV nor
PIL)."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}      # colour type -> samples
# libpng's ``png_set_rgb_to_gray(png, 1, 0.299, 0.587)``, the call OpenCV's
# grayscale decode makes: 15-bit fixed-point weights, blue the remainder
_RED, _GREEN = 29900 * 32768 // 100000, 58700 * 32768 // 100000
_BLUE = 32768 - _RED - _GREEN
# Adam7's seven passes: (first row, first column, row step, column step)
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png_gray(path: str, img: np.ndarray) -> None:
    """Write ``img`` (``[H, W]`` uint8) as a grayscale PNG: one IDAT chunk,
    every row unfiltered (filter byte 0), through a temporary file and an
    atomic replace."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 2:
        raise ValueError(f"expected [H, W] uint8, got shape {img.shape}")
    H, W = img.shape
    raw = np.concatenate([np.zeros((H, 1), np.uint8), img], axis=1)
    data = (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))
    with open(path + ".tmp", "wb") as f:
        f.write(data)
    os.replace(path + ".tmp", path)


def _unfilter_rows(raw: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """Rows of filter types None, Sub and Up only (``raw`` ``[H, n, bpp]``
    uint8): one vectorized pass a row.  Pages written with every row Sub,
    as the mini-IAM fixture's are, decode here ~16x faster than by
    :func:`_unfilter_wavefront`."""
    out = np.empty_like(raw)
    prior = np.zeros_like(raw[0])
    for r, ft in enumerate(filters):
        row = raw[r]
        if ft == 1:
            row = np.cumsum(row, axis=0, dtype=np.uint8)
        elif ft == 2:
            row = row + prior
        out[r] = prior = row
    return out


def _unfilter_wavefront(raw: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """Any mix of the five filter types: a byte depends on its left, upper
    and upper-left neighbours (``bpp`` bytes apart, so each of the ``bpp``
    byte lanes is independent), so the image is decoded one anti-diagonal
    of (row, pixel) at a time, vectorized along the diagonal."""
    H, n, bpp = raw.shape
    x = np.zeros((H + 1, n + 1, bpp), np.int32)   # zero row and column
    raw32 = raw.astype(np.int32)
    ft_all = filters.astype(np.int32)
    for d in range(H + n - 1):
        r = np.arange(max(0, d - n + 1), min(H, d + 1))
        j = d - r
        a, b, c = x[r + 1, j], x[r, j + 1], x[r, j]
        ft = ft_all[r][:, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = np.choose(ft, [0 * a, a, b, (a + b) >> 1, paeth])
        x[r + 1, j + 1] = (raw32[r, j] + pred) & 0xFF
    return x[1:, 1:].astype(np.uint8)


def _unpack_bits(rows: np.ndarray, depth: int, samples: int) -> np.ndarray:
    """``[H, bytes]`` of packed ``depth``-bit samples (MSB first) ->
    ``[H, samples]`` values."""
    bits = np.unpackbits(rows, axis=1)[:, :samples * depth]
    bits = bits.reshape(rows.shape[0], samples, depth).astype(np.uint8)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)


def _pass_samples(flat: np.ndarray, pos: int, W: int, H: int, depth: int,
                  ch: int, path: str):
    """Unfilter one (sub-)image of ``H`` rows of ``W`` pixels starting at
    byte ``pos`` of the inflated stream: ``([H, W, ch]`` int64 samples,
    the position after it)."""
    bits = depth * ch
    row_bytes = (W * bits + 7) // 8
    bpp = max(1, bits // 8)
    end = pos + H * (row_bytes + 1)
    if end > flat.size:
        raise ValueError(f"{path}: image data is short")
    block = flat[pos:end].reshape(H, row_bytes + 1)
    filters = block[:, 0]
    if filters.max(initial=0) > 4:
        raise ValueError(f"{path}: bad filter type {filters.max()}")
    raw = block[:, 1:].reshape(H, row_bytes // bpp, bpp)
    unfilter = (_unfilter_rows if filters.max(initial=0) <= 2
                else _unfilter_wavefront)
    rows = unfilter(raw, filters).reshape(H, row_bytes)
    if depth == 16:
        px = rows.view(">u2").astype(np.int64).reshape(H, W, ch)
    elif depth == 8:
        px = rows.astype(np.int64).reshape(H, W, ch)
    else:
        px = _unpack_bits(rows, depth, W * ch).astype(np.int64)
        px = px.reshape(H, W, ch)
    return px, end


def read_png_gray(path: str) -> np.ndarray:
    """The pixels ``[H, W]`` uint8 of a PNG, as ``cv2.imread(path, 0)``
    gives them: every filter type, bit depths 1-16, colour types 0/2/3/4/6
    and Adam7 interlacing (each pass unfiltered on its own, then scattered
    into place); alpha dropped (not composited); 1/2/4-bit grey scaled to
    0..255; colour to grey with libpng's fixed-point 0.299/0.587 weights (a
    grey pixel, R = G = B, kept as it is; 8-bit rounds down, 16-bit rounds
    to nearest); 16 bits to 8 by the high byte, after the grey
    conversion."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path} is not a PNG")
    pos, idat, header, palette = 8, [], None, None
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, color, _, _, interlace = header
    if color not in _CHANNELS:
        raise ValueError(f"{path}: unknown colour type {color}")
    if interlace not in (0, 1):
        raise ValueError(f"{path}: unknown interlace method {interlace}")
    ch = _CHANNELS[color]
    flat = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if interlace == 0:
        px, _ = _pass_samples(flat, 0, W, H, depth, ch, path)
    else:
        px, at = np.zeros((H, W, ch), np.int64), 0
        for y0, x0, dy, dx in _ADAM7:
            h, w = -(-(H - y0) // dy), -(-(W - x0) // dx)
            if h > 0 and w > 0:              # an empty pass has no bytes
                sub, at = _pass_samples(flat, at, w, h, depth, ch, path)
                px[y0::dy, x0::dx] = sub

    if color == 3:
        if palette is None:
            raise ValueError(f"{path}: palette image without PLTE")
        px = palette.astype(np.int64)[px[..., 0]]          # -> RGB, 8 bit
        depth = 8
    elif color == 0 and depth < 8:
        px = px * (255 // ((1 << depth) - 1))
    if px.shape[-1] in (2, 4):                              # drop alpha
        px = px[..., :-1]
    if px.shape[-1] == 3:
        r, g, b = px[..., 0], px[..., 1], px[..., 2]
        mix = _RED * r + _GREEN * g + _BLUE * b
        if depth == 16:
            mix = mix + (1 << 14)
        gray = np.where((r == g) & (r == b), r, mix >> 15)
    else:
        gray = px[..., 0]
    if depth == 16:
        gray = gray >> 8
    return np.ascontiguousarray(gray, np.uint8)
