"""Corpus text sampler for generation-only lessons.

A copy of ``handwriting_line_generation_tpu/data/text_data.py``: random
substrings of a flattened text corpus (or the built-in pangram text when no
corpus is given), an optional word mode and character-balance mode (force a
goal character to appear).  Its draws come from
``numpy.random.default_rng(seed)`` in the same order, so a seed gives the
same label batches as the JAX package's sampler.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from handwriting_line_generation_tpu_torch.charset import Charset

_LOREM = (
    "the quick brown fox jumps over the lazy dog while seven wizards "
    "toast big jugs of black quartz wine and every sphinx of onyx "
    "quietly judges my vow both fickle dwarves jinx zippy clowns "
)


class TextSampler:
    def __init__(self, charset: Charset, batch_size: int,
                 corpus_path: Optional[str] = None, max_len: int = 20,
                 min_len: int = 3, words: bool = False,
                 character_balance: bool = False, seed: int = 0):
        self.charset = charset
        self.batch_size = batch_size
        self.max_len = max_len
        self.min_len = min(min_len, max_len)
        self.words = words
        self.character_balance = character_balance
        self.rng = np.random.default_rng(seed)
        if corpus_path:
            with open(corpus_path, encoding="utf-8", errors="ignore") as f:
                text = f.read()
        else:
            text = _LOREM * 50
        # flatten whitespace, keep only charset characters
        text = " ".join(text.split())
        keep = set(charset.chars)
        self.text = "".join(c for c in text if c in keep)
        if len(self.text) < 2 * max_len:
            self.text = (self.text or _LOREM) * (
                (2 * max_len) // max(len(self.text), 1) + 1)
        self.word_list: List[str] = self.text.split() if words else []
        self.chars = charset.chars.replace(" ", "")

    def _sample_text(self) -> str:
        if self.words:
            w = self.word_list[int(self.rng.integers(0, len(self.word_list)))]
            return w[: self.max_len]
        length = int(self.rng.integers(self.min_len, self.max_len + 1))
        idx = int(self.rng.integers(0, len(self.text) - length))
        text = self.text[idx:idx + length]
        if self.character_balance:
            goal = str(self.rng.choice(list(self.chars)))
            if goal not in text:
                r = int(self.rng.integers(0, len(text)))
                text = text[:r] + goal + text[r + 1:]
        if text == " ":
            text = self.text[idx + 1]
        return text

    def get_batch(self, label_len: Optional[int] = None) -> Dict:
        """``{"label" [B, L] int32, "label_lengths" [B], "gt", "image":
        None}``; ``L`` is ``label_len`` or the longest sample."""
        gts, labels = [], []
        for _ in range(self.batch_size):
            t = self._sample_text()
            gts.append(t)
            labels.append(self.charset.encode(t))
        L = label_len or max(max(len(l) for l in labels), 1)
        out = np.zeros((self.batch_size, L), np.int32)
        lens = np.zeros(self.batch_size, np.int32)
        for i, l in enumerate(labels):
            n = min(len(l), L)
            out[i, :n] = l[:n]
            lens[i] = n
        return {"label": out, "label_lengths": lens, "gt": gts, "image": None}
