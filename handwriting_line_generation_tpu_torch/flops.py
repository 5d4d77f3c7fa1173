"""The port's one convention for counting a step's float operations and
bytes, and the card's datasheet peaks they are measured against.

FLOPs: ``torch.utils.flop_counter``'s formulas over whatever the counted
function runs (a forward, or a forward and the backward the step really
runs), with the convolutions' replaced by XLA's: every convolution counts
``2 x (output elements) x (kernel taps) x (input channels per group)`` of
the direct convolution XLA would run, over padded taps.  A transposed
convolution is the direct convolution of its stride-dilated, padded input,
so the zeros the dilation inserts count, as they do in a JAX
``conv_general_dilated`` with ``lhs_dilation``; a convolution's backward
counts its input gradient as the direct convolution that produces the
input (a stride-dilated one for a strided convolution, as JAX's transpose
rule writes it) and its weight gradient as the forward.  Matrix products
(``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``dot``) count ``2 x M x
N x K``.  Nothing else counts: elementwise work, reductions, the CTC
recursion and the epilogue's blur are not contractions, so a kernel and
its plain version count alike and the count does not depend on the
device.  Against cuDNN, which reads no inserted zeros, the transposed
convolutions and the strided input gradients are overcounted (``PERF.md``
section 7).

Bytes: for every aten op that is not a view, the bytes of its distinct
input tensors and of its output tensors.  That is unfused traffic: each op
reads its operands from memory and writes its result back.  It bounds what
reaches HBM from above (a fused or cached op moves less), and it sees no
tensor a hand kernel touches inside its launch (the card's count of a path
through a kernel is smaller than the CPU's of its plain version).
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry, shape_wrapper

aten = torch.ops.aten

# H100 SXM5 datasheet dense peaks, TFLOP/s, by the precision a step runs
PEAK_TFLOPS = {"bfloat16": 989.0, "tf32": 495.0, "float32": 67.0}


def peak_tflops(compute_dtype: str, tf32: bool) -> Tuple[float, str]:
    """The datasheet peak for a step in ``compute_dtype`` (``"float32"``
    convolutions in TF32 when ``tf32``) and its name."""
    if compute_dtype == "bfloat16":
        return PEAK_TFLOPS["bfloat16"], "bfloat16"
    key = "tf32" if tf32 else "float32"
    return PEAK_TFLOPS[key], key


def _conv_flop(x_shape, w_shape, _bias, _stride, _padding, _dilation,
               transposed, _output_padding=None, groups=1, *args,
               out_shape=None, **kwargs) -> int:
    """XLA's direct convolution: ``2 x out x taps x (in channels / g)``.
    ``w_shape`` is ``[out, in/g, k...]``, or ``[in, out/g, k...]`` when
    transposed."""
    taps = math.prod(w_shape[2:])
    cin = w_shape[0] // groups if transposed else w_shape[1]
    return 2 * math.prod(out_shape) * taps * cin


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, _stride,
                        _padding, _dilation, transposed, _output_padding,
                        groups, output_mask, out_shape=None,
                        **kwargs) -> int:
    """The input gradient as the direct convolution producing ``x`` (each
    input element against the taps and the other side's channels per
    group), the weight gradient as the forward."""
    taps = math.prod(w_shape[2:])
    flop = 0
    if output_mask[0]:
        other = w_shape[1] if transposed else w_shape[0] // groups
        flop += 2 * math.prod(x_shape) * taps * other
    if output_mask[1]:
        cin = w_shape[0] // groups if transposed else w_shape[1]
        flop += 2 * math.prod(grad_out_shape) * taps * cin
    return flop


def _mv_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * a_shape[0] * a_shape[1]


def _dot_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * a_shape[0]


FORMULAS = {
    **flop_registry,
    **{op: shape_wrapper(f) for op, f in (
        (aten.convolution, _conv_flop), (aten._convolution, _conv_flop),
        (aten.convolution_overrideable, _conv_flop),
        (aten.convolution_backward, _conv_backward_flop),
        (aten.mv, _mv_flop), (aten.dot, _dot_flop))},
}


# tensor metadata queries, which a dispatch mode passes on (the names this
# torch has)
_METADATA = {getattr(aten, n).default for n in (
    "sym_is_contiguous", "is_contiguous", "is_non_overlapping_and_dense",
    "is_strides_like_format", "size", "sym_size", "stride", "sym_stride",
    "storage_offset", "sym_storage_offset", "numel", "sym_numel", "dim")
    if hasattr(aten, n)} | {aten.is_contiguous.memory_format,
                            torch.ops.prim.layout.default}


class Counter(TorchDispatchMode):
    """FLOPs (``torch.utils.flop_counter``'s formulas, the convolutions'
    replaced as above) and unfused bytes (every non-view aten op's distinct inputs and
    its outputs) of what runs inside it, in total and by op.  A dispatch
    mode of its own rather than ``FlopCounterMode``, whose module tracker
    refuses ``torch.autograd.grad`` of a leaf (the GAN steps' cotangents)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.flops_by_op: Dict[str, int] = defaultdict(int)
        self.bytes_by_op: Dict[str, int] = defaultdict(int)

    @staticmethod
    def _bytes(tree) -> int:
        seen, n = set(), 0
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor) and id(t) not in seen:
                seen.add(id(t))
                n += t.numel() * t.element_size()
        return n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return NotImplemented
        # a composite op (conv2d, linear, einsum under no_grad) is counted
        # by the ops it decomposes into, as FlopCounterMode counts it
        if func is not torch.ops.prim.device.default:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        name = str(func.overloadpacket)
        formula = FORMULAS.get(func.overloadpacket)
        if formula is not None:
            n = int(formula(*args, **kwargs, out_val=out))
            self.flops += n
            self.flops_by_op[name] += n
        if not func.is_view:
            n = self._bytes((args, kwargs)) + self._bytes(out)
            self.bytes += n
            self.bytes_by_op[name] += n
        return out


def count(fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)`` counted: ``(result, flops, bytes)``."""
    with Counter() as c:
        out = fn(*args, **kwargs)
    return out, float(c.flops), float(c.bytes)
