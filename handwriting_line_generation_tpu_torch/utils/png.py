"""An 8-bit grayscale PNG writer on ``zlib``, for the GAN's sample strips
(the JAX package writes them with ``cv2.imwrite``; the port uses neither
OpenCV nor PIL)."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


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
    data = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))
    with open(path + ".tmp", "wb") as f:
        f.write(data)
    os.replace(path + ".tmp", path)
