"""Levenshtein distance in numpy: the fallback path of
``handwriting_line_generation_tpu/utils/error_rates.py`` (the JAX package
also binds a native C version; the port does not need one)."""

from __future__ import annotations

from typing import Hashable, Sequence

import numpy as np


def levenshtein(a: Sequence[Hashable], b: Sequence[Hashable]) -> int:
    """Edit distance by the two-row DP, the inner loop vectorized."""
    if len(a) < len(b):
        a, b = b, a
    if len(b) == 0:
        return len(a)
    vocab = {}
    enc_a = np.array([vocab.setdefault(t, len(vocab)) for t in a])
    enc_b = np.array([vocab.setdefault(t, len(vocab)) for t in b])
    prev = np.arange(len(enc_b) + 1)
    for i, ca in enumerate(enc_a):
        cur = np.empty_like(prev)
        cur[0] = i + 1
        sub = prev[:-1] + (enc_b != ca)
        dele = prev[1:] + 1
        # insertion chains in closed form:
        #   cur[j] = min_{k<=j}(cand[k] + (j-k)) = (running min of cand[k]-k) + j
        cand = np.minimum(sub, dele)
        offsets = np.arange(len(cand))
        run = np.minimum.accumulate(cand - offsets)
        cur[1:] = run + offsets
        prev = cur
    return int(prev[-1])
