"""Write a text corpus with the synthetic dataset's text distribution.

    python -m handwriting_line_generation_tpu_torch.scripts.make_synthetic_corpus \\
        [OUT] [N] [iam|rimes|CHARSET.json]

Counterpart of ``scripts/make_synthetic_corpus.py``.  The GAN's
generation-only lessons sample ``data.text_data``; for the synthetic
dataset that corpus is ``N`` (default 5000) draws of
:func:`~handwriting_line_generation_tpu_torch.data.synthetic.random_text`
from ``np.random.default_rng(99)``, one a line, so the lessons train on
the text the gen-CER probe reads.  ``OUT`` defaults to
``saved/syn_text.txt``; the file is byte-equal to the JAX script's for the
same arguments.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

import numpy as np

from handwriting_line_generation_tpu_torch.charset import get_charset
from handwriting_line_generation_tpu_torch.data.synthetic import random_text

SEED = 99


def write_corpus(out: str, n: int = 5000, charset: str = "iam") -> str:
    """``n`` lines of ``random_text`` over ``charset`` (``iam``, ``rimes``
    or a charset JSON) to ``out``; returns ``out``."""
    cs = get_charset(charset)
    rng = np.random.default_rng(SEED)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w", encoding="utf-8") as f:
        for _ in range(n):
            f.write(random_text(rng, cs) + "\n")
    return out


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out = argv[0] if argv else "saved/syn_text.txt"
    n = int(argv[1]) if len(argv) > 1 else 5000
    charset = argv[2] if len(argv) > 2 else "iam"
    write_corpus(out, n, charset)
    print(f"wrote {n} lines ({charset} charset) to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
