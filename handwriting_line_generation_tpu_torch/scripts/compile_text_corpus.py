"""Build a flat text corpus for the generation-text sampler.

    python -m handwriting_line_generation_tpu_torch.scripts.compile_text_corpus \
        SOURCES... -o OUT.txt [--index] [--fraction F] [--charset iam|rimes|JSON]

A copy of the repository's root ``scripts/compile_text_corpus.py``, the
charset from this package.  Counterpart of the reference's ``data/compile_french_new.py``: it sampled a
fraction of newline-listed JSON article files and concatenated their
``text`` fields into ``french_news.txt`` for ``TextData``.  This version
generalizes: accepts JSON article lists, plain ``.txt`` files, or
directories, filters to a charset, and writes one flat corpus file usable
via ``DataConfig.text_corpus`` / ``text_data.py`` semantics.
"""

import argparse
import json
import os
import random
import sys


def iter_sources(paths):
    for p in paths:
        if os.path.isdir(p):
            for root, _, files in os.walk(p):
                for f in sorted(files):
                    yield os.path.join(root, f)
        else:
            yield p


def read_text(path):
    try:
        if path.endswith(".json"):
            with open(path) as f:
                doc = json.load(f)
            return doc.get("text", "") if isinstance(doc, dict) else ""
        with open(path, errors="replace") as f:
            return f.read()
    except OSError as e:
        print(f"skip {path}: {e}", file=sys.stderr)
        return ""


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("sources", nargs="+",
                    help="txt/json files, dirs, or an index file listing "
                         "one source path per line (use --index)")
    ap.add_argument("-o", "--out", required=True)
    ap.add_argument("--index", action="store_true",
                    help="treat each source as a newline-separated list of "
                         "file paths (reference jsons.txt mode)")
    ap.add_argument("--fraction", type=float, default=1.0,
                    help="random fraction of sources to keep "
                         "(reference used 0.2)")
    ap.add_argument("--charset", default=None,
                    help="'iam' | 'rimes' | path to char-set json: drop "
                         "characters outside it")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    paths = list(iter_sources(args.sources))
    if args.index:
        expanded = []
        for p in paths:
            with open(p) as f:
                expanded += [ln.strip() for ln in f if ln.strip()]
        paths = expanded
    if args.fraction < 1.0:
        random.Random(args.seed).shuffle(paths)
        paths = paths[: max(1, int(len(paths) * args.fraction))]

    allowed = None
    if args.charset:
        from handwriting_line_generation_tpu_torch.charset import (
            IAM_CHARSET, RIMES_CHARSET, Charset)
        if args.charset == "iam":
            cs = IAM_CHARSET
        elif args.charset == "rimes":
            cs = RIMES_CHARSET
        else:
            cs = Charset.load(args.charset)
        allowed = set(cs.char_to_idx) | {" ", "\n"}

    n_lines = 0
    with open(args.out, "w") as out:
        for i, p in enumerate(paths):
            text = read_text(p)
            if allowed is not None:
                text = "".join(c for c in text if c in allowed)
            text = "\n".join(ln.strip() for ln in text.splitlines()
                             if ln.strip())
            if text:
                out.write(text + "\n")
                n_lines += text.count("\n") + 1
            if (i + 1) % 100 == 0:
                print(f"{i + 1}/{len(paths)}", file=sys.stderr)
    print(f"wrote {args.out}: {n_lines} lines from {len(paths)} sources")


if __name__ == "__main__":
    main()
