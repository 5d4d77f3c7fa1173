"""Style-space statistics: inter- vs intra-author distance distributions.

    python -m handwriting_line_generation_tpu_torch.play_styles \\
        STYLES.npz [--metric l1|l2] [--heatmap PNG [--max-styles N]] \
        [--device cuda]

Counterpart of the repository's root ``play_styles.py``
(``play_styles.py:25-39`` of the reference): the mean and std of the
pairwise style distances between lines of one author (intra) and of
different authors (inter), as JSON on stdout.  ``--heatmap`` writes the
author-sorted (stable) pairwise L1 or L2 distance matrix of the first
``--max-styles`` styles, scaled to ``255 d / max(d.max(), 1e-8)`` and cast
to u8, through OpenCV's VIRIDIS table (``utils/colormap.py``) as an RGB
PNG: the pixels the root script's ``cv2.imwrite`` writes.  ``--device`` is
checked as every entry point of the port checks it (``cuda`` unless
named).
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
                    help="write author-sorted pairwise-distance heatmap")
    ap.add_argument("--max-styles", type=int, default=512,
                    help="subsample cap for the heatmap")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    from handwriting_line_generation_tpu_torch.device import resolve_device
    from handwriting_line_generation_tpu_torch.inference.styles import (
        inter_intra_distances, load_styles,
    )
    resolve_device(args.device)
    data = load_styles(args.styles)
    stats = inter_intra_distances(data, metric=args.metric)
    print(json.dumps({"n": len(data["authors"]), **stats}, indent=2),
          flush=True)
    if args.heatmap:
        d = heatmap(data, args.heatmap, args.metric, args.max_styles)
        print(f"wrote {args.heatmap} ({d.shape[0]}x{d.shape[0]})",
              flush=True)
    return 0


def heatmap(data, path: str, metric: str = "l2", max_styles: int = 512):
    """Write the heatmap PNG of ``data`` (a loaded bank); returns the u8
    distance matrix it coloured."""
    import numpy as np

    from handwriting_line_generation_tpu_torch.utils.colormap import \
        apply_colormap
    from handwriting_line_generation_tpu_torch.utils.png import write_png_rgb
    styles = np.asarray(data["styles"], np.float32)
    authors = np.asarray(data["authors"])
    order = np.argsort(authors, kind="stable")[:max_styles]
    s = styles[order]
    if metric == "l1":
        d = np.abs(s[:, None] - s[None, :]).sum(-1)
    else:
        d = np.linalg.norm(s[:, None] - s[None, :], axis=-1)
    d = (255 * d / max(d.max(), 1e-8)).astype(np.uint8)
    write_png_rgb(path, apply_colormap(d))
    return d


if __name__ == "__main__":
    sys.exit(main())
