"""Style-space statistics: inter- vs intra-author distance distributions.

    python -m handwriting_line_generation_tpu_torch.play_styles \\
        STYLES.npz [--metric l1|l2] [--device cuda]

Counterpart of the repository's root ``play_styles.py``
(``play_styles.py:25-39`` of the reference): the mean and std of the
pairwise style distances between lines of one author (intra) and of
different authors (inter), as JSON on stdout.  ``--heatmap`` is not ported:
its colour map is OpenCV's ``applyColorMap``.  ``--device`` is checked as
every entry point of the port checks it (``cuda`` unless named).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m handwriting_line_generation_tpu_torch.play_styles",
        description="Inter/intra-author style distances.")
    ap.add_argument("styles", help="styles .npz from get_styles")
    ap.add_argument("--metric", default="l2", choices=["l1", "l2"])
    ap.add_argument("--heatmap", default=None, metavar="PNG",
                    help="not ported (needs OpenCV's applyColorMap)")
    ap.add_argument("--max-styles", type=int, default=512,
                    help="subsample cap for the heatmap")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    if args.heatmap:
        raise NotImplementedError(
            "play_styles --heatmap is not ported: it needs OpenCV's "
            "applyColorMap; use the repository's root play_styles.py")
    from handwriting_line_generation_tpu_torch.device import resolve_device
    from handwriting_line_generation_tpu_torch.inference.styles import (
        inter_intra_distances, load_styles,
    )
    resolve_device(args.device)
    data = load_styles(args.styles)
    stats = inter_intra_distances(data, metric=args.metric)
    print(json.dumps({"n": len(data["authors"]), **stats}, indent=2),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
