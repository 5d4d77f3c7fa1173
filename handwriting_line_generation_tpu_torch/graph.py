"""Training curves of a run's ``train_log.json``.

    python -m handwriting_line_generation_tpu_torch.graph \\
        RUN_DIR/train_log.json [-o curves.png] [-k KEY ...] [--csv OUT.csv]

Counterpart of the repository's root ``graph.py``: every logged key but
``iteration`` (or the ``-k`` ones) against the iteration, as a 1000 x 600
PNG drawn by ``utils.train_log.TrainLog.plot`` on numpy alone, and with
``--csv`` the entries as CSV.  Reads the logs of either package's
trainers.  No model runs.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m handwriting_line_generation_tpu_torch.graph",
        description="Training-curve plot of a train log.")
    ap.add_argument("log", help="train log .json (TrainLog.save output)")
    ap.add_argument("-o", "--out", default="curves.png")
    ap.add_argument("-k", "--keys", nargs="*", default=None)
    ap.add_argument("--csv", default=None, help="also export CSV here")
    args = ap.parse_args(argv)
    from handwriting_line_generation_tpu_torch.utils.train_log import \
        TrainLog
    log = TrainLog.load(args.log)
    log.plot(args.out, args.keys)
    if args.csv:
        log.export_csv(args.csv)
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
