"""A trained model from a run directory, for inference.

The inference CLIs of the JAX package build a ``GanTrainer`` and initialize
its whole state before they overwrite it from the checkpoint.  The port's
``GanTrainer`` reads the pretrained recognizer and encoder files when it is
built, and inference needs neither, so :func:`load_model` builds only
``HWWithStyle(cfg.model)`` and loads the weights, from any of the three
layouts the port's trainers write:

* ``checkpoint-latest`` / ``checkpoint-iteration<N>``: a trainer's
  ``state_dict()``, the model under ``"model"`` and the step under
  ``"step"``;
* ``model_best``: ``{"model": ...}``, the step in its ``.json`` sidecar;
* ``<name>-swa``: the SWA average, a bare parameter name -> tensor dict,
  laid over the model of ``<name>`` (which supplies the buffers: the
  spectral-norm ``u``'s).

A JAX package's run directory loads the same way: ``<name>.msgpack`` is
read in place of ``<name>.pt`` (``utils/msgpack.py``) and its flax tree
converted (``convert.convert_checkpoint``: the three layouts above, as the
JAX package writes them).  The reader is picked by which file exists; a
name with both files is refused.
"""

from __future__ import annotations

import glob
import os
from typing import Tuple

import torch

from handwriting_line_generation_tpu_torch.config import Config
from handwriting_line_generation_tpu_torch.convert import convert_checkpoint
from handwriting_line_generation_tpu_torch.data.datasets import get_charset
from handwriting_line_generation_tpu_torch.device import resolve_device
from handwriting_line_generation_tpu_torch.models.hw_with_style import \
    HWWithStyle
from handwriting_line_generation_tpu_torch.utils.checkpoint import (
    checkpoint_file, load_checkpoint, load_meta, load_raw_checkpoint,
)

SWA_SUFFIX = "-swa"


def _missing(run_dir: str, name: str) -> FileNotFoundError:
    found = sorted(os.path.splitext(os.path.basename(p))[0]
                   for ext in ("*.pt", "*.msgpack")
                   for p in glob.glob(os.path.join(run_dir, ext)))
    return FileNotFoundError(
        f"no checkpoint {name!r} in {run_dir} (found: "
        f"{', '.join(found) or 'no .pt or .msgpack files'})")


def _step(obj, run_dir: str, name: str) -> int:
    if isinstance(obj, dict) and "step" in obj:
        return int(obj["step"])
    try:
        return int(load_meta(run_dir, name).get("iteration", 0))
    except OSError:
        return 0


def _read(run_dir: str, name: str):
    """``(object, state_dict)`` of ``<name>.pt`` or ``<name>.msgpack``,
    whichever exists (both: refused)."""
    path = checkpoint_file(os.path.join(run_dir, name))
    if not os.path.exists(path):
        raise _missing(run_dir, name)
    if path.endswith(".msgpack"):
        raw = load_raw_checkpoint(run_dir, name)
        return raw, convert_checkpoint(raw)
    obj = load_checkpoint(run_dir, name)
    return obj, (obj["model"] if isinstance(obj, dict) and "model" in obj
                 else obj)


def load_model(cfg: Config, run_dir: str, name: str = "checkpoint-latest",
               device=None) -> Tuple[HWWithStyle, int]:
    """``(model, step)``: ``HWWithStyle(cfg.model)`` with the weights of
    ``<run_dir>/<name>.pt`` or ``.msgpack``, on ``device`` (``cuda``
    unless named) in eval mode.  ``num_class`` follows ``cfg.data``'s
    charset, as the trainers set it.  ``model.generator.fused_epilogue``
    is the config's: the weights are the same either way."""
    device = resolve_device(device)
    base = name[:-len(SWA_SUFFIX)] if name.endswith(SWA_SUFFIX) else name
    obj, state = _read(run_dir, base)
    swa = _read(run_dir, name)[1] if name != base else None
    cfg.model.num_class = get_charset(cfg.data).num_class
    model = HWWithStyle(cfg.model)
    model.load_state_dict(state)
    if swa is not None:
        params = dict(model.named_parameters())
        unknown = sorted(set(swa) - set(params))
        if unknown:
            raise ValueError(f"{name}: entries the model does not have: "
                             f"{unknown[:5]}")
        with torch.no_grad():
            for k, v in swa.items():
                params[k].copy_(v)
    return model.to(device).eval(), _step(obj, run_dir, base)
