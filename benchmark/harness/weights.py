"""Seeded weights, made on the model's device in one draw.

The benchmark makes the weights and gives the same to the program and to
the reference; the rule depends only on each tensor's name, shape and the
class of the module that holds it, which the program and its reference
share:

* an equal-LR weight (``EqualConv``, ``FusedUpsample``): N(0, 1);
* every other weight of two or more axes (not a per-class norm's
  scales): N(0, 1 / fan_in), the fan-in
  being the product of the axes a unit sums over (``BankConv1d``'s
  ``[N, out, in, k]`` sums ``in x k``, ``BankDense``'s ``[N, in, out]``
  sums ``in``);
* the styled generator blocks' conv biases: N(0, 0.05^2), so that a bias
  an epilogue drops or adds twice shows;
* every other bias of a ``Conv1d``, ``Conv2d`` or ``Linear``: 0, except
  AdaIN's, which keeps gamma = 1, beta = 0;
* every other tensor keeps the constant its constructor gives it
  (norm scales 1 and shifts 0, the noise weights 0.01, the spacer's mean
  and std);
* a spectral norm's ``u`` buffer: a random unit vector.

All normal draws come from one ``torch.randn`` of their total size on the
device, with a ``torch.Generator`` seeded by ``seed``, in float32, and are
rounded to each tensor's type when they are copied in.
"""

from __future__ import annotations

import math
import re
from typing import List, Tuple

import torch
from torch import nn

EQUAL_LR = ("EqualConv", "FusedUpsample")
STYLED_BIAS = re.compile(r"(^|\.)generator\.blocks\.\d+\.conv[12]\.bias$")
STYLED_BIAS_STD = 0.05
# modules whose many-axis weights are norm scales: kept
KEEP = ("BankGroupNorm",)


def _fan_in(owner: str, t: torch.Tensor) -> int:
    if owner == "BankConv1d":
        return t.shape[2] * t.shape[3]
    if owner == "BankDense":
        return t.shape[1]
    return t.numel() // t.shape[0]


def plan(model: nn.Module) -> Tuple[List[Tuple[torch.Tensor, float, str]],
                                    List[torch.Tensor], List[torch.Tensor]]:
    """``(drawn, zeroed, units)``: the tensors drawn with their std and
    name, those set to 0, and the ``u`` buffers."""
    drawn, zeroed, units = [], [], []
    for mname, mod in model.named_modules():
        owner = type(mod).__name__
        for pname, p in mod.named_parameters(recurse=False):
            full = f"{mname}.{pname}" if mname else pname
            if STYLED_BIAS.search(full):
                drawn.append((p, STYLED_BIAS_STD, full))
            elif (pname.startswith("weight") and p.ndim >= 2
                  and owner not in KEEP):
                std = 1.0 if owner in EQUAL_LR else \
                    1.0 / math.sqrt(_fan_in(owner, p))
                drawn.append((p, std, full))
            elif (pname == "bias" and isinstance(
                    mod, (nn.Conv1d, nn.Conv2d, nn.Linear))
                  and not mname.endswith("adain1.linear")
                  and not mname.endswith("adain2.linear")):
                zeroed.append(p)
        for bname, b in mod.named_buffers(recurse=False):
            if bname == "u":
                units.append(b)
    return drawn, zeroed, units


@torch.no_grad()
def fill(model: nn.Module, seed: int) -> int:
    """Set ``model``'s weights from ``seed`` in place, on its device.
    Returns the number of values drawn."""
    drawn, zeroed, units = plan(model)
    dev = next(model.parameters()).device
    total = sum(p.numel() for p, _, _ in drawn) + sum(u.numel()
                                                     for u in units)
    g = torch.Generator(dev).manual_seed(int(seed) % (2 ** 63))
    z = torch.randn(total, generator=g, device=dev)
    at = 0
    for p, std, _ in drawn:
        n = p.numel()
        p.copy_((z[at:at + n] * std).view(p.shape))
        at += n
    for u in units:
        n = u.numel()
        v = z[at:at + n]
        u.copy_(v / torch.linalg.vector_norm(v))
        at += n
    for p in zeroed:
        p.zero_()
    return total
