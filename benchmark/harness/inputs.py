"""Seeded inputs: glyph lines and texts.

:func:`glyph_lines` is the program's ``trace_train.batch`` generator,
copied: u8 lines of ``64 x W`` on paper of 240-255, ``widths`` uniform in
``[W/2, W]``, labels of 24 to ``L`` characters, and one dark bar a label
over each line's width, its height set by the character.
:func:`texts` draws lines of text over a charset's characters.
"""

from __future__ import annotations

from typing import List

import numpy as np


def glyph_lines(rng: np.random.Generator, n: int, W: int = 1024,
                L: int = 72, num_class: int = 80):
    """``(image [n, 64, W, 1] u8, label [n, L] int32, lens [n] int32,
    width [n] int32)`` as numpy arrays."""
    width = rng.integers(W // 2, W + 1, n).astype(np.int32)
    lens = rng.integers(24, L + 1, n).astype(np.int32)
    label = np.zeros((n, L), np.int32)
    image = rng.integers(240, 256, (n, 64, W, 1)).astype(np.uint8)
    for b in range(n):
        label[b, :lens[b]] = rng.integers(1, num_class, lens[b])
        step = width[b] / lens[b]
        for j, c in enumerate(label[b, :lens[b]]):
            x0 = int(j * step)
            h = 8 + int(c) % 24
            image[b, 32 - h // 2:32 + h // 2, x0:x0 + max(2, int(step) // 2),
                  0] = rng.integers(0, 60)
    return image, label, lens, width


def texts(rng: np.random.Generator, chars: str, n: int, low: int,
          high: int) -> List[str]:
    """``n`` texts of ``low`` to ``high`` characters drawn from ``chars``
    (spaces between words included); the first is ``high`` long, so every
    batch of them has the same longest text."""
    pool = np.array(list(chars))
    lens = rng.integers(low, high + 1, n)
    lens[0] = high
    out = []
    for k in lens:
        s = "".join(pool[rng.integers(0, len(pool), int(k))])
        # no leading, trailing or doubled space: a space a word apart
        s = "".join(c if c != " " or (0 < i < k - 1 and s[i - 1] != " ")
                    else "a" for i, c in enumerate(s))
        out.append(s)
    return out
