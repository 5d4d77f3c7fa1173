#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card.

    python3 benchmark/calibrate.py --workload CELL --seeds 1,2,3 \
        [--control] [--fault NAME] [--seconds 1]

For each seed: one run of the cell with a short window (``--seconds``),
then its check; with ``--control``, also the check of the control, the
reference put in the program's place one precision step below the
configuration's (fp8 for bfloat16, bfloat16 for float32), on the same
requests or lessons; with ``--fault``, the run with that fault planted
(``half_batch``, ``unchanged``, ``answer``).  One JSON line a seed and
reading: ``{"seed", "what", "numbers": {name: value}}``.  Every run is in
this one process, so the kernels load once.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import env  # noqa: E402

env.prepare(BENCH.parent)

import run  # noqa: E402


def readings(name: str, seed: int, seconds: float, control: bool,
             fault=None):
    """One run of the cell (``run.run_cell``, untraced) and its check:
    ``([(what, numbers, detail), ...], setup_s, steps)``."""
    import torch
    res = run.run_cell(name, seed, seconds, False, fault=fault,
                       t_start=time.perf_counter(), control=control)
    numbers = {k: c["value"] for k, c in res["checks"].items()}
    out = [("fault:" + fault if fault else "program", numbers,
            res.get("detail"))]
    if control:
        out.append(("control", res["control"], None))
    torch.cuda.empty_cache()
    return out, res["metrics"]["setup_s"]["value"], res["attempted"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    env.require_cards(1)
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        got, setup_s, steps = readings(args.workload, int(s), args.seconds,
                                       args.control, args.fault)
        for what, numbers, detail in got:
            print(json.dumps({"seed": int(s), "what": what,
                              "numbers": numbers, "detail": detail,
                              "setup_s": setup_s,
                              "steps": steps,
                              "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
