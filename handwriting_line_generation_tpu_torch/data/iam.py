"""IAM form-XML parsing: a copy of
``handwriting_line_generation_tpu/data/iam.py`` (the port imports nothing of
the JAX package).

Replaces ``utils/parseIAM.py:88-135`` (``getLineBoundaries``): each form XML
lists handwritten lines as words made of components with pixel boxes; the
line box is the component hull, then every line on the page is padded
vertically up to the page's mean line height (centered) and ±meanH/4
horizontally.  Word-level parsing (``parseIAM.py:11-86``) is exposed via
``parse_form_words``.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Dict, List, Tuple
from xml.sax.saxutils import unescape as _unescape


def _clean(s: str) -> str:
    return _unescape(s).replace("&quot;", '"').replace("&apos;", "'")


@dataclass(frozen=True)
class LineBox:
    """Crop bounds [y0, y1, x0, x1) plus transcription."""
    y0: int
    y1: int
    x0: int
    x1: int
    text: str

    @property
    def bounds(self) -> Tuple[int, int, int, int]:
        return (self.y0, self.y1, self.x0, self.x1)


def _pad_to_mean_height(raw: List[Tuple[List[float], str]]
                        ) -> List[LineBox]:
    if not raw:
        return []
    mean_h = sum(1 + b[1] - b[0] for b, _ in raw) / len(raw)
    out = []
    for b, text in raw:
        y0, y1, x0, x1 = b
        diff = mean_h - (y1 - y0)
        if diff > 0:
            y0 -= diff / 2
            y1 += diff / 2
        x0 -= mean_h / 4
        x1 += mean_h / 4
        out.append(LineBox(round(y0), round(y1), round(x0), round(x1), text))
    return out


def parse_form_xml(xml_path: str) -> Tuple[List[LineBox], str]:
    """Parse one IAM form XML -> (padded line boxes, writer id)."""
    root = ET.parse(xml_path).getroot()
    writer = root.attrib["writer-id"]
    raw: List[Tuple[List[float], str]] = []
    for line in root.findall("./handwritten-part/line"):
        text = _clean(line.attrib["text"])
        xs, ys, x2s, y2s = [], [], [], []
        for word in line.findall("word"):
            for cmp_ in word.findall("cmp"):
                x = int(cmp_.attrib["x"])
                y = int(cmp_.attrib["y"])
                w = int(cmp_.attrib["width"])
                h = int(cmp_.attrib["height"])
                xs.append(x)
                ys.append(y)
                x2s.append(x + w)
                y2s.append(y + h)
        if not xs:
            continue
        raw.append(([min(ys), max(y2s) + 1, min(xs), max(x2s) + 1], text))
    return _pad_to_mean_height(raw), writer


def parse_form_words(xml_path: str) -> Tuple[List[LineBox], str]:
    """Word-level boxes (``parseIAM.py:11-86`` lineage), same padding rule."""
    root = ET.parse(xml_path).getroot()
    writer = root.attrib["writer-id"]
    raw: List[Tuple[List[float], str]] = []
    for line in root.findall("./handwritten-part/line"):
        for word in line.findall("word"):
            text = _clean(word.attrib.get("text", ""))
            boxes = [(int(c.attrib["x"]), int(c.attrib["y"]),
                      int(c.attrib["width"]), int(c.attrib["height"]))
                     for c in word.findall("cmp")]
            if not boxes or not text:
                continue
            x0 = min(b[0] for b in boxes)
            y0 = min(b[1] for b in boxes)
            x1 = max(b[0] + b[2] for b in boxes) + 1
            y1 = max(b[1] + b[3] for b in boxes) + 1
            raw.append(([y0, y1, x0, x1], text))
    return _pad_to_mean_height(raw), writer
