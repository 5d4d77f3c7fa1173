"""Float operations of what a function runs, in ``torch.utils.flop_counter``'s
own convention.

A ``TorchDispatchMode`` that applies ``torch.utils.flop_counter``'s
formulas to every aten op the counted function runs, forward and backward:
a convolution counts ``2 x (output positions) x (kernel taps) x (input
channels per group) x (output channels)``, a transposed convolution over
its input positions, so the zeros a stride would insert never count, and
its backward the input and weight gradients it really computes.  Matrix
products count ``2 x M x N x K``; ``mv`` and ``dot`` are added here in the
same way.  Nothing else counts: elementwise work, reductions, the CTC
recursion and the epilogue's blur are not contractions, and the
hand-written kernels launched through ``ctypes`` are not aten ops.

The program's own counter (``flops.py``) replaced the convolution
formulas with XLA's direct convolution, which counts inserted zeros; this
frozen copy keeps PyTorch's.  A dispatch mode of its own rather than
``FlopCounterMode``, whose module tracker refuses ``torch.autograd.grad``
of a leaf (the GAN steps' cotangents).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry, shape_wrapper

aten = torch.ops.aten


def _mv_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * a_shape[0] * a_shape[1]


def _dot_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * a_shape[0]


FORMULAS = {**flop_registry,
            aten.mv: shape_wrapper(_mv_flop),
            aten.dot: shape_wrapper(_dot_flop)}

# tensor metadata queries, which the mode passes on
_METADATA = {getattr(aten, n).default for n in (
    "sym_is_contiguous", "is_contiguous", "is_non_overlapping_and_dense",
    "is_strides_like_format", "size", "sym_size", "stride", "sym_stride",
    "storage_offset", "sym_storage_offset", "numel", "sym_numel", "dim")
    if hasattr(aten, n)} | {aten.is_contiguous.memory_format,
                            torch.ops.prim.layout.default}


class Counter(TorchDispatchMode):
    """FLOPs of what runs inside it, in total and by op."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.by_op: Dict[str, int] = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return NotImplemented
        # a composite op (conv2d, linear, einsum) is counted by the ops it
        # decomposes into, as FlopCounterMode counts it
        if func is not torch.ops.prim.device.default:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        formula = FORMULAS.get(func.overloadpacket)
        if formula is not None:
            n = int(formula(*args, **kwargs, out_val=out))
            self.flops += n
            self.by_op[str(func.overloadpacket)] += n
        return out


def count(fn: Callable, *args, **kwargs):
    """``(fn(*args, **kwargs), flops)``."""
    with Counter() as c:
        out = fn(*args, **kwargs)
    return out, float(c.flops)
