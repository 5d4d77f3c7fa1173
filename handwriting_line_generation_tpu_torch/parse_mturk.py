"""Score a human real-vs-generated study CSV.

    python -m handwriting_line_generation_tpu_torch.parse_mturk CSV \\
        [--reference-csv] [--min-gold X] [--workers] [--device cuda]

Counterpart of the repository's root ``parse_mturk.py``: per-worker
gold-trap and transcription filtering, the fooling rate of generated lines
and worker statistics, as JSON on stdout.  Reads the reference's raw MTurk
export (``--reference-csv``) or the clean schema
``worker,gt,answered_real,transcription_ok``.  ``--device`` is checked as
every entry point of the port checks it (``cuda`` unless named).
"""

from __future__ import annotations

import argparse
import csv
import json
import sys
from typing import List, Optional

_TRUE = ("1", "true", "True")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m handwriting_line_generation_tpu_torch.parse_mturk",
        description="Score a human real-vs-generated study.")
    ap.add_argument("csv_file")
    ap.add_argument("--reference-csv", action="store_true",
                    help="parse the reference's raw MTurk column layout")
    ap.add_argument("--min-gold", type=float, default=1.0)
    ap.add_argument("--workers", action="store_true",
                    help="include per-worker stats")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    from handwriting_line_generation_tpu_torch.analysis.mturk import (
        load_reference_csv, score_study,
    )
    from handwriting_line_generation_tpu_torch.device import resolve_device
    resolve_device(args.device)
    if args.reference_csv:
        records = load_reference_csv(args.csv_file)
    else:
        with open(args.csv_file) as f:
            records = [{"worker": r["worker"], "gt": r["gt"],
                        "answered_real": r["answered_real"] in _TRUE,
                        "transcription_ok": r["transcription_ok"] in _TRUE}
                       for r in csv.DictReader(f)]
    out = score_study(records, args.min_gold)
    if not args.workers:
        out.pop("worker_stats")
    print(json.dumps(out, indent=2), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
