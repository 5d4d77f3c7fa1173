"""2-D style-space plot of a style bank.

    python -m handwriting_line_generation_tpu_torch.umap_styles \\
        STYLES.npz [-o style_map.png] [--author-mean] [--thumbnails DIR]

Counterpart of the repository's root ``umap_styles.py``: the styles'
embedding (UMAP when the ``umap`` package is installed, else PCA), one dot
a style coloured by author, optionally one an author (``--author-mean``)
and each style's ``<id>.png`` line image placed at its point
(``--thumbnails``), as a 960 x 960 PNG drawn by
``inference.styles.plot_style_map`` on numpy alone.  No model runs.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m handwriting_line_generation_tpu_torch.umap_styles",
        description="2-D style-space plot (UMAP, else PCA).")
    ap.add_argument("styles", help="styles .npz from get_styles")
    ap.add_argument("-o", "--out", default="style_map.png")
    ap.add_argument("--author-mean", action="store_true")
    ap.add_argument("--thumbnails", default=None, metavar="DIR",
                    help="directory of <id>.png line images to place at "
                         "their embedding positions")
    args = ap.parse_args(argv)
    from handwriting_line_generation_tpu_torch.inference.styles import (
        load_styles, plot_style_map,
    )
    plot_style_map(load_styles(args.styles), args.out,
                   author_mean=args.author_mean,
                   thumbnail_dir=args.thumbnails)
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
