"""The environment of one run: where caches go, which modules may never be
loaded, and the card the cell asks for.

Every build and kernel cache stays inside the checkout, at a fixed path,
so only a checkout's first run builds: the program's CUDA libraries go to
``handwriting_line_generation_tpu_torch/build/`` (the program fixes that
directory itself), and PyTorch's extension and Triton caches, which the
program does not use today, are pointed at ``.bench_cache/`` beside it.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import List

# the JAX package and JAX itself; the port's own name begins with the JAX
# package's, so a loaded module is judged by its whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "handwriting_line_generation_tpu")


def prepare(root: Path) -> None:
    """Set the run's environment before torch is imported."""
    cache = root / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # one process, few host threads: steadier runs
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def forbidden_loaded(modules=None) -> List[str]:
    """Top-level names of loaded modules that the benchmark may not load."""
    modules = sys.modules if modules is None else modules
    tops = {name.split(".")[0] for name in list(modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def require_cards(chips: int) -> str:
    """The name of card 0; raises when there is no card or too few."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the benchmark runs only on the "
                           "card")
    if torch.cuda.device_count() < chips:
        raise RuntimeError(f"the cell asks for {chips} cards, "
                           f"{torch.cuda.device_count()} are visible")
    return torch.cuda.get_device_name(0)


def set_precision(precision: dict) -> None:
    """The configuration's TF32 switches."""
    import torch
    torch.backends.cudnn.allow_tf32 = bool(precision["cudnn_allow_tf32"])
    torch.backends.cuda.matmul.allow_tf32 = bool(
        precision["matmul_allow_tf32"])


def reference_precision(config: dict) -> None:
    """The reference's switches: float32 with the configuration's TF32
    switches where the configuration computes in float32 (it states
    them), float32 without TF32 where it computes in bfloat16 (one step
    above it)."""
    import torch
    p = config["precision"]
    tf32 = p["compute_dtype"] == "float32"
    torch.backends.cudnn.allow_tf32 = tf32 and bool(p["cudnn_allow_tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32 and bool(
        p["matmul_allow_tf32"])
