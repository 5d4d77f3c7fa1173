"""Lower precision for the controls: the reference computed one step below
the precision a configuration states.

:func:`fp8` runs every convolution and linear layer of the reference on
float8 (e4m3) operands: each input and each weight is scaled per tensor so
its largest magnitude is e4m3's 448, rounded to float8, and scaled back;
the product accumulates in float32, as a float8 tensor-core GEMM does.
The control of a bfloat16 configuration.  (A float32 configuration's
control, bfloat16, is the reference built with ``compute_dtype``
bfloat16: its own path.)
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
_NAMES = ("conv1d", "conv2d", "conv_transpose2d", "linear")


def to_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 under a per-tensor scale, back in float32."""
    x = t.float()
    amax = x.abs().max().clamp(min=1e-30)
    scale = E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


@contextmanager
def fp8():
    """Inside: ``F.conv1d``, ``F.conv2d``, ``F.conv_transpose2d`` and
    ``F.linear`` take float8-rounded operands (``nn.Conv*`` and
    ``nn.Linear`` call these)."""
    saved = {n: getattr(F, n) for n in _NAMES}

    def wrap(fn):
        def run(x, w, *args, **kwargs):
            dt = x.dtype
            return fn(to_fp8(x), to_fp8(w), *args, **kwargs).to(dt)
        return run
    try:
        for n, fn in saved.items():
            setattr(F, n, wrap(fn))
        yield
    finally:
        for n, fn in saved.items():
            setattr(F, n, fn)
