"""Batch style-extraction CLI of the port.

    python -m handwriting_line_generation_tpu_torch.get_styles -c CONFIG \\
        -k RUN_DIR [-T] [-o OUT_DIR] [-n N] [-S] [-a PATH=VALUE ...] \\
        [--device cuda]

Counterpart of the repository's root ``get_styles.py`` (which stays JAX):
run the style extractor over train and valid (or test with ``-T``) and
write ``{styles, authors, ids}`` to ``<split>_styles_<step>.npz`` beside the
checkpoint (or in ``-o``), ``<step>`` being ``checkpoint-latest``'s.  The
device is ``cuda`` unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m handwriting_line_generation_tpu_torch.get_styles",
        description="Extract the style bank of a trained model.")
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-k", "--checkpoint", required=True,
                    help="run directory holding checkpoint-latest (.pt, or "
                         "the JAX package's .msgpack)")
    ap.add_argument("-T", "--test", action="store_true",
                    help="use the test split instead of train/valid")
    ap.add_argument("-o", "--out-dir", default=None)
    ap.add_argument("-n", "--max-batches", type=int, default=None)
    ap.add_argument("-S", "--through-emb", action="store_true",
                    help="pass styles through the generator's style MLP "
                         "before saving (get_styles.py:184-186)")
    ap.add_argument("-a", "--override", action="append", default=[],
                    metavar="PATH=VALUE",
                    help="nested config override, e.g. "
                         "-a data.data_dir=tests/fixtures/mini_iam")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from handwriting_line_generation_tpu_torch.config import (
        apply_overrides, load_config,
    )
    from handwriting_line_generation_tpu_torch.data.datasets import \
        make_batcher
    from handwriting_line_generation_tpu_torch.inference.load import \
        load_model
    from handwriting_line_generation_tpu_torch.inference.styles import (
        StyleExtractor, save_styles,
    )
    cfg = apply_overrides(load_config(args.config), args.override)
    model, it = load_model(cfg, args.checkpoint, device=args.device)
    ex = StyleExtractor(model, device=args.device)
    out_dir = args.out_dir or args.checkpoint
    for split in (["test"] if args.test else ["train", "valid"]):
        data = ex.extract_dataset(make_batcher(cfg.data, split),
                                  args.max_batches,
                                  through_emb=args.through_emb)
        path = os.path.join(out_dir, f"{split}_styles_{it}.npz")
        save_styles(path, data)
        print(f"wrote {len(data['authors'])} styles -> {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
