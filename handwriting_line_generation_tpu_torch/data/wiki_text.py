"""Long-form text source for generation: paragraphs of a local corpus.

Counterpart of ``handwriting_line_generation_tpu/data/wiki_text.py``
(itself after the reference's ``wiki_text.py``): index in, a charset-clean
paragraph out.  Only the local-corpus path is here: a plain-text file
(or, without one, the built-in text) split into paragraphs at blank lines,
cut at the first references-style section header, whitespace collapsed,
characters outside the charset dropped, paragraphs shorter than
``min_paragraph`` skipped.  The JAX package's optional Hugging Face
Wikipedia branch downloads its corpus; this one does not, and
``try_hf=True`` raises rather than try.
"""

from __future__ import annotations

from typing import List, Optional

from handwriting_line_generation_tpu_torch.charset import (
    IAM_CHARSET, Charset,
)

_SECTION_HEADERS = ("References", "External links", "See also", "Sources",
                    "Further reading", "Bibliography", "Notes")


class WikiText:
    def __init__(self, charset: Charset = IAM_CHARSET,
                 corpus_path: Optional[str] = None,
                 min_paragraph: int = 40, try_hf: bool = False):
        if try_hf:
            raise NotImplementedError(
                "WikiText's Hugging Face branch downloads Wikipedia; the "
                "port reads a local corpus only (pass corpus_path)")
        self.charset = charset
        self.min_paragraph = min_paragraph
        self._paragraphs: List[str] = []
        self._load_local(corpus_path)

    def _load_local(self, corpus_path: Optional[str]) -> None:
        if corpus_path:
            with open(corpus_path, encoding="utf-8", errors="ignore") as f:
                text = f.read()
        else:
            from handwriting_line_generation_tpu_torch.data.text_data import \
                _LOREM
            text = (_LOREM + "\n\n") * 64
        self._paragraphs = self._clean_article(text)

    def _clean_article(self, text: str) -> List[str]:
        # everything from the first references-style section header on goes
        for h in _SECTION_HEADERS:
            idx = text.find("\n" + h + "\n")
            if idx >= 0:
                text = text[:idx]
        keep = set(self.charset.chars)
        out = []
        for para in text.split("\n\n"):
            para = " ".join(para.split())
            para = "".join(c for c in para if c in keep)
            if len(para) >= self.min_paragraph:
                out.append(para)
        return out

    def __len__(self) -> int:
        return len(self._paragraphs)

    def __getitem__(self, i: int) -> str:
        return self._paragraphs[i % max(len(self._paragraphs), 1)]
