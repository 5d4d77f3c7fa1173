"""RIMES lines-XML parsing: a copy of
``handwriting_line_generation_tpu/data/rimes.py``.

Replaces ``utils/parseRIMESlines.py:12-45``: a single XML lists pages
(``SinglePage``) with line boxes (Top/Bottom/Left/Right) and transcriptions;
the same mean-height padding rule as IAM applies per page.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from collections import defaultdict
from typing import Dict, List

from handwriting_line_generation_tpu_torch.data.iam import LineBox, _clean, \
    _pad_to_mean_height


def parse_rimes_lines_xml(xml_path: str) -> Dict[str, List[LineBox]]:
    """-> {image filename: [LineBox, ...]} with per-page height padding."""
    root = ET.parse(xml_path).getroot()
    pages: Dict[str, List[LineBox]] = defaultdict(list)
    for page in root.findall("SinglePage"):
        image = page.attrib["FileName"]
        image = image[image.index("/") + 1:] if "/" in image else image
        raw = []
        for line in page.findall("Paragraph/Line"):
            text = _clean(line.attrib["Value"])
            raw.append(([int(line.attrib["Top"]),
                         int(line.attrib["Bottom"]) + 1,
                         int(line.attrib["Left"]),
                         int(line.attrib["Right"]) + 1], text))
        pages[image] = _pad_to_mean_height(raw)
    return dict(pages)
