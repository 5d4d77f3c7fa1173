"""Write a split's transcriptions to a text file, one line each.

    python -m handwriting_line_generation_tpu_torch.scripts.make_IAM_text_list \\
        -c CONFIG [-d SPLIT] [-o OUT]

Counterpart of the repository's root ``make_IAM_text_list.py`` (after the
reference's: test-set line transcriptions as generation input); works for
any configured dataset, through the port's ``load_config`` and
``make_batcher``.  ``SPLIT`` defaults to ``test``, ``OUT`` to
``text_list.txt``.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m handwriting_line_generation_tpu_torch.scripts."
             "make_IAM_text_list",
        description="Dump a split's transcriptions to a text file.")
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-d", "--split", default="test")
    ap.add_argument("-o", "--out", default="text_list.txt")
    args = ap.parse_args(argv)

    from handwriting_line_generation_tpu_torch.config import load_config
    from handwriting_line_generation_tpu_torch.data.datasets import \
        make_batcher
    b = make_batcher(load_config(args.config).data, args.split)
    records = getattr(b, "records", None)
    if records is None:
        records = [r for g in b.groups for r in g]
    with open(args.out, "w", encoding="utf-8") as f:
        for r in records:
            f.write(r.gt + "\n")
    print(f"wrote {len(records)} lines -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
