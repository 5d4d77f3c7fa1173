"""Evaluation CLI of the port.

    python -m handwriting_line_generation_tpu_torch.evaluate -c CONFIG \\
        -k RUN_DIR [--ckpt-name NAME] [-d SPLIT] [-n N] [-o OUT_DIR] \\
        [--save-images] [--save-styles] [--save-spaced] [--save-preds] \\
        [--save-nns] [--save-gen] [--quality [--texts F] [--n-gen N]] \\
        [-a PATH=VALUE ...] [--device cuda]

Counterpart of the repository's root ``evaluate.py`` (which stays JAX): run
the model over a split and print the metrics as JSON on stdout — CER/WER
and ``autoLoss`` with the ``--save-*`` side channels (``Evaluator``), or
with ``--quality`` gen-CER, writer-ID retrieval, the style distances, the
HWR-feature FID and the realism gaps (``QualityEvaluator``).
``--ckpt-name`` picks ``checkpoint-latest`` (default),
``checkpoint-iteration<N>``, ``model_best`` or ``<name>-swa`` (the SWA
weights over ``<name>``).  The ``--quality`` texts are ``--texts``, else
the config's ``data.text_data`` (resolved inside the checkout; ``-a
data.text_data=`` unsets it), else the split's transcriptions without
``$UNKOWN$``.  Stage marks go to stderr.  The device is ``cuda`` unless
``--device`` names another.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

_T0 = time.time()


def _mark(msg: str) -> None:
    print(f"[evaluate +{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m handwriting_line_generation_tpu_torch.evaluate",
        description="Evaluate a trained model over a split.")
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-k", "--checkpoint", required=True)
    ap.add_argument("--ckpt-name", default="checkpoint-latest",
                    help="checkpoint file stem in the -k directory: "
                         "checkpoint-latest, checkpoint-iterationN, "
                         "model_best, or any of them + '-swa'")
    ap.add_argument("-d", "--split", default="valid")
    ap.add_argument("-n", "--max-batches", type=int, default=None)
    ap.add_argument("-o", "--out-dir", default=None)
    ap.add_argument("--save-images", action="store_true")
    ap.add_argument("--save-styles", action="store_true")
    ap.add_argument("--save-spaced", action="store_true")
    ap.add_argument("--save-preds", action="store_true",
                    help="per-sample prediction CSV (new_eval save_preds)")
    ap.add_argument("--save-nns", action="store_true",
                    help="style-space nearest-neighbor CSV (new_eval "
                         "save_nns)")
    ap.add_argument("--save-gen", action="store_true",
                    help="dump generated-line images per sample "
                         "(hwdataset_eval.py:267-279 channel)")
    ap.add_argument("--quality", action="store_true",
                    help="generation-quality harness: gen-CER, writer-ID, "
                         "inter/intra style distances, HWR-feature FID")
    ap.add_argument("--texts", default=None,
                    help="text corpus for --quality gen lines (default: the "
                         "config's data.text_data, else split transcripts)")
    ap.add_argument("--n-gen", type=int, default=256,
                    help="number of lines to generate for --quality")
    ap.add_argument("-a", "--override", action="append", default=[],
                    metavar="PATH=VALUE",
                    help="nested config override, e.g. "
                         "-a model.generator.fused_epilogue=true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap


def quality_texts(args, cfg, batcher) -> List[str]:
    """``--texts``, else the config's corpus, else the split's own
    transcriptions (without ``$UNKOWN$``), ``--n-gen`` of them."""
    import numpy as np

    from handwriting_line_generation_tpu_torch.inference.quality import \
        load_texts
    from handwriting_line_generation_tpu_torch.training.gan_trainer import \
        resolve_text_data
    path = args.texts or resolve_text_data(cfg.data.text_data)
    if path:
        return load_texts(path, args.n_gen)
    texts: List[str] = []
    for b in batcher.batches(np.random.default_rng(0), shuffle=False):
        texts.extend(t for t in b["gt"] if t != "$UNKOWN$")
        if len(texts) >= args.n_gen:
            break
    return texts[:args.n_gen]


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from handwriting_line_generation_tpu_torch.config import (
        apply_overrides, load_config,
    )
    from handwriting_line_generation_tpu_torch.data.datasets import (
        get_charset, make_batcher,
    )
    from handwriting_line_generation_tpu_torch.inference.load import \
        load_model
    cfg = apply_overrides(load_config(args.config), args.override)
    model, step = load_model(cfg, args.checkpoint, args.ckpt_name,
                             device=args.device)
    _mark(f"loaded {args.ckpt_name} (step {step})")
    charset = get_charset(cfg.data)
    batcher = make_batcher(cfg.data, args.split)
    if args.quality:
        from handwriting_line_generation_tpu_torch.inference.quality import \
            QualityEvaluator
        texts = quality_texts(args, cfg, batcher)
        qe = QualityEvaluator(model, charset, device=args.device)
        metrics = qe.run(batcher, texts, args.max_batches,
                         out_dir=args.out_dir)
    else:
        from handwriting_line_generation_tpu_torch.inference.eval import \
            Evaluator
        ev = Evaluator(model, charset, device=args.device)
        metrics = ev.run(batcher, args.max_batches, args.out_dir,
                         save_images=args.save_images,
                         save_styles=args.save_styles,
                         save_spaced=args.save_spaced,
                         save_preds=args.save_preds,
                         save_nns=args.save_nns,
                         save_gen=args.save_gen)
    _mark("done")
    print(json.dumps(metrics, indent=2), flush=True)
    return 0


if __name__ == "__main__":
    import faulthandler
    import signal

    # a time limit's SIGTERM dumps every thread's stack, so a hang says
    # where it hung
    faulthandler.register(signal.SIGTERM, chain=True)
    sys.exit(main())
