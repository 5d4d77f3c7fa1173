"""Training CLI of the port: HWR pretraining, perceptual-autoencoder
pretraining or the GAN curriculum, from a config file.

    python -m handwriting_line_generation_tpu_torch.train -c CONFIG.json \\
        [-r] [-i N] [--dataset NAME] [--save-dir DIR] [-a PATH=VALUE ...] \\
        [--device cuda]

Counterpart of the repository's root ``train.py`` (which stays JAX): the
config may be in the repo's own schema or the reference's (auto-detected);
``-a`` applies nested overrides (``-a data.data_dir=tests/fixtures/mini_iam
-a trainer.iterations=100``; ``-a data.text_data=`` selects the GAN's
built-in text); ``trainer.kind`` picks ``HWRTrainer``, ``AutoTrainer`` or
``GanTrainer``.  Batches come from ``make_batcher(cfg.data, "train")``
behind a prefetch thread, epoch-shuffled from ``trainer.seed``; validation
reads ``make_batcher(cfg.data, "valid")``.  Each log entry and validation
is printed as one JSON line.  The run directory is
``<trainer.save_dir>/<name>``: ``-r`` resumes its ``checkpoint-latest``
(and starts fresh when there is none); without ``-r`` a directory that
holds checkpoints is refused.  ``model.generator.fused_epilogue`` is
refused: the epilogue kernel has no backward.  The device is ``cuda``
unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

from handwriting_line_generation_tpu_torch.config import (
    apply_overrides, load_config,
)
from handwriting_line_generation_tpu_torch.data.datasets import (
    Prefetcher, forever, make_batcher,
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m handwriting_line_generation_tpu_torch.train",
        description="Train the recognizer, the perceptual autoencoder or "
                    "the GAN from a config file.")
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-r", "--resume", action="store_true",
                    help="resume from checkpoint-latest if present (a "
                         "fresh start when absent); without -r, a run dir "
                         "that already has checkpoints is refused")
    ap.add_argument("-i", "--iterations", type=int, default=None,
                    help="override the iteration budget")
    ap.add_argument("--dataset", default=None,
                    help="override data.dataset (e.g. 'synthetic')")
    ap.add_argument("--save-dir", default=None)
    ap.add_argument("-a", "--override", action="append", default=[],
                    metavar="PATH=VALUE",
                    help="nested config override, e.g. "
                         "-a trainer.iterations=100")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    return ap


def _trainer_class(kind: str):
    if kind == "hwr":
        from handwriting_line_generation_tpu_torch.training.hwr_trainer \
            import HWRTrainer
        return HWRTrainer
    if kind == "auto":
        from handwriting_line_generation_tpu_torch.training.auto_trainer \
            import AutoTrainer
        return AutoTrainer
    from handwriting_line_generation_tpu_torch.training.gan_trainer import \
        GanTrainer
    return GanTrainer


def log_line(entry: Dict) -> None:
    """One log entry as a JSON line, floats rounded to 5 places."""
    print(json.dumps({k: (round(v, 5) if isinstance(v, float) else v)
                      for k, v in entry.items()}), flush=True)


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    cfg = load_config(args.config)
    apply_overrides(cfg, args.override)
    if cfg.model.generator.fused_epilogue:
        raise ValueError(
            "model.generator.fused_epilogue is inference-only (the "
            "epilogue kernel has no backward): unset it for training")
    if args.dataset:
        cfg.data.dataset = args.dataset
    if args.save_dir:
        cfg.trainer.save_dir = args.save_dir
    if args.iterations:
        cfg.trainer.iterations = args.iterations

    trainer = _trainer_class(cfg.trainer.kind)(cfg, device=args.device)
    train_b = make_batcher(cfg.data, "train")
    valid_b = make_batcher(cfg.data, "valid")
    batches = Prefetcher(forever(train_b, seed=cfg.trainer.seed))
    print(f"training '{cfg.name}' ({cfg.trainer.kind}) for "
          f"{cfg.trainer.iterations} iterations on {trainer.device}",
          flush=True)
    try:
        trainer.train(batches, on_log=log_line, valid=valid_b,
                      resume=args.resume)
    finally:
        batches.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
