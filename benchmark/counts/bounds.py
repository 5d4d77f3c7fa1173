"""The least time of the program's two hand-written kernels, from their
shapes, and the card's datasheet peaks.

The formulas are the program's own bring-up bounds (``chip_smoke.py``),
frozen here.  A kernel's least time is the larger of its bytes over the
memory rate and its float operations over the float32 rate, each input
byte read once and each output byte written once.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at the
700 W power limit: HBM 3.35 TB/s; 989 TFLOP/s bfloat16, 495 TF32, 67
float32 outside the tensor cores.
"""

from __future__ import annotations

from typing import List, Tuple

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}

# float operations a pixel-channel of the epilogue: the bias add and its
# rounding (2), the separable blur (3 row sums of 4 ops, 1 column sum of 4,
# 1 rounding), noise (2), leaky_relu (2), statistics (3), normalize and
# affine (4)
EPILOGUE_OPS = {True: 30, False: 13}
# float operations a cell of the CTC lattice, forward + backward and
# forward only
CTC_OPS = {True: 40, False: 20}


def epilogue_calls(dim: int = 256, t: int = 192
                   ) -> List[Tuple[int, int, int, int, bool]]:
    """``(block, C, H, W, blur)`` of the nine epilogue calls of a
    generator forward at ``t`` spaced positions: the blur in the first
    call of the upsampling blocks 1-4, a second call in blocks 0-3 (the
    last block's second normalization folds into the output conv)."""
    shapes = [(dim, 4, t), (dim // 2, 8, t), (dim // 4, 16, t),
              (dim // 8, 32, 2 * t), (dim // 16, 64, 4 * t)]
    calls = []
    for i, (c, h, w) in enumerate(shapes):
        calls.append((i, c, h, w, i > 0))
        if i < 4:
            calls.append((i, c, h, w, False))
    return calls


def epilogue_call_s(b: int, c: int, h: int, w: int, blur: bool,
                    esize: int) -> float:
    """Least seconds of one epilogue call on ``[b, h, w, c]``: reads z,
    the noise plane, the noise weight, bias, gamma and beta, writes out."""
    n = b * h * w
    nbytes = (2 * n * c + n + 3 * c + 2 * b * c) * esize
    return max(nbytes / HBM_BYTES_PER_S,
               n * c * EPILOGUE_OPS[blur] / F32_OPS_PER_S)


def epilogue_forward_s(b: int, t: int, dim: int = 256,
                       esize: int = 2) -> float:
    """Least seconds of one generator forward's nine epilogue calls."""
    return sum(epilogue_call_s(b, c, h, w, blur, esize)
               for _, c, h, w, blur in epilogue_calls(dim, t))


def ctc_launch_s(b: int, t: int, l: int, c: int, cells: int,
                 grad: bool = True) -> float:
    """Least seconds of one CTC launch on ``log_probs [b, t, c]`` float32
    with labels padded to ``l``: reads the log-probs (and writes their
    gradient), the labels and both length vectors; ``cells`` lattice cells
    (``sum_b t * (2 len_b + 1)``)."""
    nbytes = b * t * c * 4 * (2 if grad else 1) + b * l * 4 + b * 4 + b * 4
    return max(nbytes / HBM_BYTES_PER_S, cells * CTC_OPS[grad]
               / F32_OPS_PER_S)
