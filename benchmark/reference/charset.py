"""Character sets, label <-> string codecs and greedy CTC decoding.

A copy of ``handwriting_line_generation_tpu/charset.py``'s ``Charset``
(with ``load`` and ``save``), ``IAM_CHARSET``, ``RIMES_CHARSET`` and greedy
decoders (the port imports nothing of the JAX package).  Index 0 is the CTC blank; characters are
indexed from 1, so ``num_class == len(chars) + 1``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Sequence

import numpy as np

# The 79 IAM characters in reference index order (index 1..79); blank is 0.
IAM_CHARS = (
    " !\"#&'()*+,-./0123456789:;?"
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    "abcdefghijklmnopqrstuvwxyz"
)

RIMES_CHARS = (
    "'-/0123456789"
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    "abcdefghijklmnopqrstuvwxyz"
    "°àâçèéêîôùû "
)

BLANK = 0


@dataclasses.dataclass(frozen=True)
class Charset:
    """Immutable charset with 0 reserved for the CTC blank."""

    chars: str

    @property
    def num_class(self) -> int:
        return len(self.chars) + 1

    @property
    def char_to_idx(self) -> Dict[str, int]:
        return {c: i + 1 for i, c in enumerate(self.chars)}

    @property
    def idx_to_char(self) -> Dict[int, str]:
        return {i + 1: c for i, c in enumerate(self.chars)}

    def encode(self, text: str) -> np.ndarray:
        """String -> int labels, silently dropping unknown characters."""
        table = self.char_to_idx
        return np.array([table[c] for c in text if c in table], dtype=np.int32)

    def decode(self, label: Sequence[int], as_raw: bool = False,
               blank_char: str = "~") -> str:
        """Int labels -> string; stops at the first blank unless ``as_raw``."""
        table = self.idx_to_char
        out: List[str] = []
        for v in label:
            v = int(v)
            if v == BLANK:
                if as_raw:
                    out.append(blank_char)
                else:
                    break
            else:
                out.append(table[v])
        return "".join(out)

    def save(self, path: str) -> None:
        """Write the reference's charset JSON (``char_to_idx`` and
        ``idx_to_char``), byte-equal to the JAX package's file."""
        payload = {
            "char_to_idx": self.char_to_idx,
            "idx_to_char": {str(k): v for k, v in self.idx_to_char.items()},
        }
        with open(path, "w", encoding="utf-8") as f:
            json.dump(payload, f, ensure_ascii=False)

    @staticmethod
    def load(path: str) -> "Charset":
        """Read a charset JSON (``idx_to_char``: index 1..n -> character),
        the reference's schema and the JAX package's."""
        with open(path) as f:
            payload = json.load(f)
        idx_to_char = {int(k): v for k, v in payload["idx_to_char"].items()}
        chars = "".join(idx_to_char[i] for i in range(1, len(idx_to_char) + 1))
        return Charset(chars)


IAM_CHARSET = Charset(IAM_CHARS)
RIMES_CHARSET = Charset(RIMES_CHARS)


def get_charset(name: str) -> Charset:
    """``DataConfig.charset``: ``iam``, ``rimes`` or the path of a charset
    JSON (:meth:`Charset.load`)."""
    if name == "iam":
        return IAM_CHARSET
    if name == "rimes":
        return RIMES_CHARSET
    return Charset.load(name)


def _collapse(ids) -> List[int]:
    """Collapse repeats, then drop blanks."""
    out: List[int] = []
    prev = -1
    for v in ids:
        v = int(v)
        if v != BLANK and v != prev:
            out.append(v)
        prev = v
    return out


def ctc_greedy_decode(logits: np.ndarray) -> List[int]:
    """Greedy CTC decode of a ``[T, num_class]`` log-prob/logit matrix:
    per-frame argmax, repeats collapsed, blanks removed."""
    return _collapse(np.argmax(np.asarray(logits), axis=1))


def ctc_greedy_decode_batch(logits: np.ndarray, charset: Charset
                            ) -> List[str]:
    """Decode a ``[B, T, num_class]`` batch straight to strings."""
    logits = np.asarray(logits)
    return [charset.decode(ctc_greedy_decode(logits[b]))
            for b in range(logits.shape[0])]


def collapse_argmax_batch(argmaxes: np.ndarray, charset: Charset
                          ) -> List[str]:
    """Strings from precomputed per-frame argmax classes ``[B, T]``."""
    return [charset.decode(_collapse(row)) for row in np.asarray(argmaxes)]
