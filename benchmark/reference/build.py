"""The reference model of a configuration file, with the benchmark's
seeded weights."""

from __future__ import annotations

import copy
from typing import Dict, Optional

import torch

from harness import weights
from reference.config import config_from_dict
from reference.models.hw_with_style import HWWithStyle


def config(cfg_file: Dict, compute_dtype: str = "float32"):
    """The configuration of ``cfg_file`` (a ``benchmark/configs`` file) as
    the reference runs it: the plain epilogue, in ``compute_dtype``."""
    cfg = config_from_dict(copy.deepcopy(cfg_file["config"]))
    cfg.model.generator.fused_epilogue = False
    cfg.model.compute_dtype = compute_dtype
    return cfg


def model(cfg_file: Dict, seed: int, device,
          compute_dtype: str = "float32",
          served: Optional[str] = None) -> HWWithStyle:
    """``HWWithStyle`` on ``device`` in eval mode, the weights drawn from
    ``seed`` by :func:`harness.weights.fill`; ``served`` ("bfloat16")
    rounds them to the type the program serves them in, kept in the
    reference's own type."""
    cfg = config(cfg_file, compute_dtype)
    m = HWWithStyle(cfg.model).to(device)
    weights.fill(m, seed)
    if served == "bfloat16":
        with torch.no_grad():
            for t in list(m.parameters()) + list(m.buffers()):
                if t.is_floating_point():
                    t.copy_(t.to(torch.bfloat16).to(t.dtype))
    return m.eval()
