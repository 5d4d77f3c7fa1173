"""Character / word error rates: a copy of
``handwriting_line_generation_tpu/utils/error_rates.py`` over the numpy
Levenshtein.  Host-side, eval only."""

from __future__ import annotations

from typing import List, Sequence

from handwriting_line_generation_tpu_torch.utils._editdistance import \
    levenshtein


def _err(r: Sequence, h: Sequence) -> float:
    dist = levenshtein(r, h)
    if len(r) == 0:
        return float(len(h))
    return float(dist) / float(len(r))


def cer(r: str, h: str, casesensitive: bool = True) -> float:
    """Character error rate, whitespace runs collapsed."""
    if not casesensitive:
        r, h = r.lower(), h.lower()
    r = " ".join(r.split())
    h = " ".join(h.split())
    return _err(r, h)


def wer(r: str, h: str, casesensitive: bool = True) -> float:
    """Word error rate."""
    if not casesensitive:
        r, h = r.lower(), h.lower()
    return _err(r.split(), h.split())


def batch_cer_wer(gts: List[str], preds: List[str],
                  casesensitive: bool = True) -> tuple:
    """Mean CER and WER over aligned lists."""
    n = max(len(gts), 1)
    c = sum(cer(g, p, casesensitive) for g, p in zip(gts, preds)) / n
    w = sum(wer(g, p, casesensitive) for g, p in zip(gts, preds)) / n
    return c, w
