"""Two loads of one checkpoint, rendered alike: whether, and where, they
part.

    python -m handwriting_line_generation_tpu_torch.trace_load [--device cuda]

The paper model (``configs/iam_gan_paper.json``'s, f32, seeded weights and
conv biases, the fused epilogue as the inference CLIs run it) is saved as
a ``checkpoint-latest`` and loaded twice by ``load_model`` (A and B).
Then, with TF32 off:

1. the two state_dicts (parameters and buffers: the spectral-norm
   ``u``'s), compared bit for bit;
2. ``GenerationSession.render`` of the same texts, styles and seed by A,
   by A again and by B: the largest differences, with the cuDNN defaults,
   with ``cudnn.deterministic``, and through the plain epilogue path;
3. a bisection: forward hooks on every generator module record their
   outputs in A's and B's renders (and A's second one); the first module
   whose output differs.

Prints one JSON line of the results.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Dict, List, Optional

import numpy as np
import torch

from handwriting_line_generation_tpu_torch.config import (
    apply_overrides, load_config,
)
from handwriting_line_generation_tpu_torch.data.datasets import get_charset
from handwriting_line_generation_tpu_torch.inference.generate import \
    GenerationSession
from handwriting_line_generation_tpu_torch.inference.load import load_model
from handwriting_line_generation_tpu_torch.init import (
    init_model, seed_conv_biases,
)
from handwriting_line_generation_tpu_torch.utils.checkpoint import \
    save_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "iam_gan_paper.json")
TEXTS = ["the quick brown fox", "jumps over the lazy", "dog 1234567",
         "Handwriting lines"]


def _max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def _recorded(session: GenerationSession, styles: np.ndarray
              ) -> List[tuple]:
    """``(module name, output)`` of every generator module in one render,
    in call order."""
    seen: List[tuple] = []
    hooks = []
    for name, mod in session.model.generator.named_modules():
        def hook(m, inp, out, name=name):
            t = out[0] if isinstance(out, (tuple, list)) else out
            if isinstance(t, torch.Tensor):
                seen.append((name or "generator", t.detach().clone()))
        hooks.append(mod.register_forward_hook(hook))
    try:
        session.render_tensor(TEXTS, styles, seed=0)
    finally:
        for h in hooks:
            h.remove()
    return seen


def _first_divergence(a: List[tuple], b: List[tuple]) -> Optional[Dict]:
    for (name, x), (_, y) in zip(a, b):
        if x.shape != y.shape or not torch.equal(x, y):
            return {"module": name, "max_abs_diff": _max_diff(x, y)}
    return None


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m handwriting_line_generation_tpu_torch.trace_load")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = apply_overrides(load_config(CONFIG), [
        "model.generator.fused_epilogue=true"])
    cfg.model.num_class = get_charset(cfg.data).num_class
    model = init_model(cfg.model, seed=0)
    seed_conv_biases(model.generator, seed=1)
    styles = np.random.default_rng(1).standard_normal(
        (len(TEXTS), cfg.model.packed_style_dim())).astype(np.float32)
    out: Dict = {}
    with tempfile.TemporaryDirectory() as run:
        save_checkpoint(run, "checkpoint-latest",
                        {"model": model.state_dict(), "step": 0})
        a, _ = load_model(cfg, run, device=args.device)
        b, _ = load_model(cfg, run, device=args.device)
    sa, sb = a.state_dict(), b.state_dict()
    unequal = [k for k in sa if not torch.equal(sa[k], sb[k])]
    saved = model.state_dict()
    out["state_entries"] = len(sa)
    out["state_unequal_a_b"] = unequal
    out["state_unequal_a_saved"] = [
        k for k in sa if not torch.equal(sa[k].cpu(), saved[k])]
    sess_a = GenerationSession(a, get_charset(cfg.data), device=args.device)
    sess_b = GenerationSession(b, get_charset(cfg.data), device=args.device)
    renders = {}
    for arm, det, fused in (("default", False, True),
                            ("cudnn_deterministic", True, True),
                            ("plain_epilogue", False, False)):
        torch.backends.cudnn.deterministic = det
        a.generator.fused_epilogue = b.generator.fused_epilogue = fused
        ra = sess_a.render_tensor(TEXTS, styles, seed=0)
        ra2 = sess_a.render_tensor(TEXTS, styles, seed=0)
        rb = sess_b.render_tensor(TEXTS, styles, seed=0)
        renders[arm] = {"a_vs_a_again": _max_diff(ra, ra2),
                        "a_vs_b": _max_diff(ra, rb)}
    torch.backends.cudnn.deterministic = False
    a.generator.fused_epilogue = b.generator.fused_epilogue = True
    out["renders"] = renders
    rec_a = _recorded(sess_a, styles)
    rec_a2 = _recorded(sess_a, styles)
    rec_b = _recorded(sess_b, styles)
    out["modules_recorded"] = len(rec_a)
    out["first_divergence_a_b"] = _first_divergence(rec_a, rec_b)
    out["first_divergence_a_a_again"] = _first_divergence(rec_a, rec_a2)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
