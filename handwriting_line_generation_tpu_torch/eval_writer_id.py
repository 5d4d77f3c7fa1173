"""Writer-ID retrieval scoring from a style bank.

    python -m handwriting_line_generation_tpu_torch.eval_writer_id \\
        STYLES.npz [--metric l1|l2] [--device cuda]

Counterpart of the repository's root ``eval_writer_id.py``: pairwise L1 or
L2 distances between the bank's styles, top-1/5/20 same-author retrieval
and the mean rank, and the inter/intra distance statistics, as JSON on
stdout.  The statistics are numpy's on the host; ``--device`` is checked as
every entry point of the port checks it (``cuda`` unless named).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m handwriting_line_generation_tpu_torch.eval_writer_id",
        description="Writer-ID retrieval over a style bank.")
    ap.add_argument("styles", help="styles .npz from get_styles")
    ap.add_argument("--metric", default="l2", choices=["l1", "l2"])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    from handwriting_line_generation_tpu_torch.device import resolve_device
    from handwriting_line_generation_tpu_torch.inference.styles import (
        inter_intra_distances, load_styles, writer_id_retrieval,
    )
    resolve_device(args.device)
    data = load_styles(args.styles)
    out = {"n": len(data["authors"]),
           **writer_id_retrieval(data, args.metric),
           **inter_intra_distances(data)}
    print(json.dumps(out, indent=2), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
