"""Training CLI of the port: HWR pretraining, perceptual-autoencoder
pretraining or the GAN curriculum, from a config file.

    python -m handwriting_line_generation_tpu_torch.train -c CONFIG.json \\
        [-r] [-i N] [--dataset NAME] [--save-dir DIR] [-a PATH=VALUE ...] \\
        [--device cuda] [--debug] [--profile DIR] \\
        [--distributed] [--mesh N] [--fsdp M] [--dist-backend NAME]

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

Multi-process training: launch one process a rank with ``torchrun``,

    torchrun --nproc_per_node K \\
        -m handwriting_line_generation_tpu_torch.train -c CONFIG.json \\
        --distributed [--fsdp M] [--dist-backend gloo]

``--distributed`` joins the process group from torchrun's variables
(``nccl`` on the card, ``gloo`` on the CPU, or ``--dist-backend``; two
ranks on one card need ``gloo``), each rank on
``cuda:{LOCAL_RANK % device_count()}``.  The ranks form a ``--mesh N`` x
``--fsdp M`` grid (``N`` = world / ``M`` when 0): each data index reads its
share of the records and of every batch, the gradients are averaged over
``data``, and with ``M`` > 1 the Adam state is sharded over ``model``.
Rank 0 builds the CUDA kernels before the others load them, and alone
writes the run directory; every rank prints its log lines (with its
``rank``).  ``--profile DIR`` writes a ``torch.profiler`` Chrome trace of
the run (CUDA activity on the card) to ``DIR/trace_rank<R>.json``;
``--debug`` turns on autograd's anomaly detection.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from typing import Callable, Dict, List, Optional

import torch

from handwriting_line_generation_tpu_torch.config import (
    apply_overrides, load_config,
)
from handwriting_line_generation_tpu_torch.data.datasets import (
    Prefetcher, forever, make_batcher,
)
from handwriting_line_generation_tpu_torch.parallel.mesh import (
    barrier, init_distributed, is_writer, make_mesh, rank_device, shutdown,
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
    ap.add_argument("--debug", action="store_true",
                    help="autograd anomaly detection (the reference's "
                         "debug mode)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace of the run "
                         "into DIR, one file a rank")
    ap.add_argument("--distributed", action="store_true",
                    help="join the torchrun process group (env://)")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="data-parallel size (0: world / fsdp)")
    ap.add_argument("--fsdp", type=int, default=0, metavar="M",
                    help="shard the Adam state over a model axis of M "
                         "ranks (the grid is N x M)")
    ap.add_argument("--dist-backend", default=None,
                    help="process-group backend (default nccl on cuda, "
                         "gloo on the cpu)")
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


def _rank_log(rank: int) -> Callable[[Dict], None]:
    return lambda entry: log_line(dict(entry, rank=rank))


@contextlib.contextmanager
def _profiled(out_dir: Optional[str], device: torch.device, rank: int):
    """A ``torch.profiler`` window over the block (CUDA activity too on the
    card), its Chrome trace written to ``out_dir/trace_rank<rank>.json``;
    nothing without ``out_dir``."""
    if not out_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"trace_rank{rank}.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}", flush=True)


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
    if args.debug:
        torch.autograd.set_detect_anomaly(True)

    device, mesh, on_log = args.device, None, log_line
    if args.distributed or args.mesh or args.fsdp:
        if args.distributed:
            init_distributed(args.dist_backend, args.device)
        device = rank_device(args.device)
        mesh = make_mesh(args.mesh, max(args.fsdp, 1))
        on_log = _rank_log(mesh.rank) if mesh.world > 1 else log_line
        print(f"rank {mesh.rank}: {mesh.data} x {mesh.model} data x model "
              f"grid on {device}" + (" (sharded Adam)" if mesh.model > 1
                                     else ""), flush=True)
        if device.type == "cuda" and mesh.world > 1:
            if is_writer():           # one build, before any rank loads
                from handwriting_line_generation_tpu_torch import kernels
                kernels.build()
            barrier()
    trainer = _trainer_class(cfg.trainer.kind)(cfg, device=device)
    shard = (1, 0) if mesh is None else (mesh.data, mesh.data_index)
    train_b = make_batcher(cfg.data, "train", shard)
    valid_b = make_batcher(cfg.data, "valid", shard)
    batches = Prefetcher(forever(train_b, seed=cfg.trainer.seed))
    print(f"training '{cfg.name}' ({cfg.trainer.kind}) for "
          f"{cfg.trainer.iterations} iterations on {trainer.device}",
          flush=True)
    try:
        with _profiled(args.profile, trainer.device,
                       0 if mesh is None else mesh.rank):
            trainer.train(batches, on_log=on_log, valid=valid_b,
                          resume=args.resume, mesh=mesh,
                          fsdp=args.fsdp > 1)
    finally:
        batches.close()
    shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
