"""Summarize quality JSONs from a results pass into a markdown table.

A copy of the repository's root ``scripts/summarize_quality.py``.

Reads every ``quality_*.json`` in the given directory (the output of
``scripts/round5_results.sh``) and prints a table ranking checkpoints per
family by the headline metrics (fid_hwr, writer_id_top1, realism gap) —
the VERDICT r4 #7 check that the new metrics actually discriminate
checkpoints where raw gen-CER saturates.

Usage: python -m handwriting_line_generation_tpu_torch.scripts.summarize_quality \
    docs/results/r5
"""

import glob
import json
import os
import sys

COLS = ["gen_CER", "real_CER", "realism_gap", "gen_CER_degraded",
        "realism_gap_degraded", "fid_hwr", "writer_id_top1",
        "writer_id_top5", "writer_id_top20"]


def main(d="docs/results/r5"):
    rows = []
    for p in sorted(glob.glob(os.path.join(d, "quality_*.json"))):
        try:
            with open(p) as f:
                q = json.load(f)
        except Exception as e:
            print(f"<!-- {p}: unreadable ({e}) -->")
            continue
        name = os.path.basename(p)[len("quality_"):-len(".json")]
        rows.append((name, q))
    if not rows:
        print("no quality JSONs in", d)
        return
    cols = [c for c in COLS if any(c in q for _, q in rows)]
    print("| checkpoint | " + " | ".join(cols) + " |")
    print("|" + "---|" * (len(cols) + 1))
    for name, q in rows:
        cells = [f"{q[c]:.4f}" if isinstance(q.get(c), float)
                 else str(q.get(c, "—")) for c in cols]
        print(f"| {name} | " + " | ".join(cells) + " |")


if __name__ == "__main__":
    main(*sys.argv[1:])
