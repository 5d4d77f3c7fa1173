"""Precompute the ``spaced_loc`` alignment cache of a GAN config.

    python -m handwriting_line_generation_tpu_torch.scripts.precompute_spaced \\
        CONFIG OUT.npz [SPLITS] [-a PATH=VALUE ...] [--device cuda]

Counterpart of ``scripts/precompute_spaced.py``.  With a frozen recognizer
and no train-time augmentation, each line's forced alignment is a
constant: computed once here and read through ``data.spaced_loc``, it
takes the per-step Viterbi out of the count and auto lessons.  The GAN
trainer is built as training builds it (the config's ``spaced_loc``
cleared; seeded weights, the pretrained recognizer of
``model.pretrained_hwr`` and the encoder of ``trainer.encoder_weights``),
and the evaluator's ``save_spaced`` channel runs over each of ``SPLITS``
(default ``train,valid``: the batcher attaches rows on every split it
serves).  Each batcher's author groups (or records) are padded to a
multiple of the batch size by cycling from the front, since a batcher
drops the tail that does not fill a batch; a record seen twice writes the
same row twice.  A split whose records are not all covered raises
``SystemExit`` naming the first missing ids.  The rows are written with
``np.savez_compressed``, keyed by record id.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np


def pad_to_batches(items: Sequence, batch_size: int) -> List:
    """``items`` made a multiple of ``batch_size`` long by cycling from the
    front (the JAX script's ``_pad``)."""
    items = list(items)
    short = (-len(items)) % batch_size
    if short and items:
        reps = -(-short // len(items))
        items = items + (items * reps)[:short]
    return items


def split_rids(batcher) -> set:
    """Every record id a batcher serves."""
    groups = getattr(batcher, "groups", None)
    if groups is not None:
        return {r.rid for g in groups for r in g}
    return {r.rid for r in batcher.records}


def check_coverage(rows, want: set, split: str) -> None:
    """Raise ``SystemExit`` when ``rows`` (a mapping or the cache's keys)
    lacks any of the ids in ``want``."""
    missing = want - set(rows)
    if missing:
        raise SystemExit(
            f"[{split}] cache covers {len(set(rows))} record ids but the "
            f"split needs {len(want)}; {len(missing)} missing (first: "
            f"{sorted(missing)[:5]}): an incomplete cache fails mid-training")


def spaced_rows(evaluator, batcher) -> Dict[str, np.ndarray]:
    """``Evaluator.run(save_spaced=True)`` over ``batcher`` padded to whole
    batches: its ``spaced.npz`` rows by record id."""
    if hasattr(batcher, "groups"):
        batcher.groups = pad_to_batches(batcher.groups, batcher.batch_size)
    else:
        batcher.records = pad_to_batches(batcher.records,
                                         batcher.batch_size)
    with tempfile.TemporaryDirectory() as tmp:
        evaluator.run(batcher, out_dir=tmp, save_spaced=True)
        with np.load(os.path.join(tmp, "spaced.npz")) as d:
            return {k: d[k] for k in d.files}


def main(config: str, out: str, splits: str = "train,valid",
         device: str = "cuda", overrides: Sequence[str] = ()) -> Dict:
    """Build the cache of ``config`` (with ``overrides``) into ``out``;
    returns the rows, the seconds and the lines each split took."""
    from handwriting_line_generation_tpu_torch.config import (
        apply_overrides, load_config,
    )
    from handwriting_line_generation_tpu_torch.data.datasets import (
        get_charset, make_batcher,
    )
    from handwriting_line_generation_tpu_torch.inference.eval import \
        Evaluator
    from handwriting_line_generation_tpu_torch.training.gan_trainer import \
        GanTrainer

    cfg = apply_overrides(load_config(config), list(overrides))
    cfg.data.spaced_loc = None        # a cache built from a cache echoes it
    trainer = GanTrainer(cfg, device=device)
    trainer.init_state(cfg.trainer.seed)
    ev = Evaluator(trainer.model, get_charset(cfg.data), trainer.device)
    rows: Dict[str, np.ndarray] = {}
    report = {"splits": {}}
    t_all = time.perf_counter()
    for split in splits.split(","):
        batcher = make_batcher(cfg.data, split)
        want = split_rids(batcher)
        t0 = time.perf_counter()
        got = spaced_rows(ev, batcher)
        secs = time.perf_counter() - t0
        rows.update(got)
        check_coverage(rows, want, split)
        report["splits"][split] = {"records": len(want), "seconds": secs}
        print(f"[{split}] {len(want)} records covered in {secs:.1f} s",
              flush=True)
    out_abs = os.path.abspath(out)
    os.makedirs(os.path.dirname(out_abs), exist_ok=True)
    np.savez_compressed(out_abs, **rows)
    report.update(rows=len(rows), seconds=time.perf_counter() - t_all)
    print(f"spaced cache: {len(rows)} records -> {out} in "
          f"{report['seconds']:.1f} s", flush=True)
    return report


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m handwriting_line_generation_tpu_torch.scripts."
             "precompute_spaced",
        description="Precompute a GAN config's spaced_loc alignment cache.")
    ap.add_argument("config")
    ap.add_argument("out")
    ap.add_argument("splits", nargs="?", default="train,valid")
    ap.add_argument("-a", "--override", action="append", default=[],
                    metavar="PATH=VALUE")
    ap.add_argument("--device", default="cuda")
    return ap


def cli(argv: Optional[List[str]] = None) -> int:
    a = build_parser().parse_args(argv)
    main(a.config, a.out, a.splits, a.device, a.override)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
