"""Random draws of one global batch, shared by data-parallel ranks.

A data-parallel step splits a batch of ``n * B`` rows over ``n`` ranks,
``B`` each.  Every rank seeds its ``torch.Generator`` alike; a
:class:`RowShard` around it makes each per-row draw (noise planes,
augmentation, dropout masks, ``insert_spaces``' jitter, a style-bank draw,
a VAE's eps) take the whole batch's numbers and keep the rank's own rows.
So ranks never draw equal numbers for different rows, their generators stay
equal, and a run's draws do not depend on the world size: rank ``i``'s rows
are rows ``i*B .. (i+1)*B - 1`` of what one process draws for the
concatenated batch.

The functions below take a ``torch.Generator``, a :class:`RowShard` or None
(torch's default generator) and draw as ``torch.randn``/``rand``/``randint``
do; :func:`plain` unwraps a shard for a draw that has no batch axis.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch


class RowShard:
    """``generator``, shared by ``n`` ranks that hold equal row shares of
    one batch; this rank holds share ``index``."""

    def __init__(self, generator: torch.Generator, n: int, index: int):
        if not 0 <= index < n:
            raise ValueError(f"row share {index} of {n}")
        self.generator = generator
        self.n = n
        self.index = index


MaybeShard = Optional[Union[torch.Generator, RowShard]]


def plain(generator: MaybeShard) -> Optional[torch.Generator]:
    """The generator itself, for a draw that is not per row."""
    return generator.generator if isinstance(generator, RowShard) \
        else generator


def _rows(fn, shape: Sequence[int], generator: MaybeShard, **kw
          ) -> torch.Tensor:
    shape = tuple(shape)
    if not isinstance(generator, RowShard):
        return fn(shape, generator=generator, **kw)
    b, s = shape[0], generator
    full = fn((s.n * b,) + shape[1:], generator=s.generator, **kw)
    return full[s.index * b:(s.index + 1) * b]


def randn(shape: Sequence[int], generator: MaybeShard, **kw
          ) -> torch.Tensor:
    """``torch.randn(shape)``; its first axis is the batch's."""
    return _rows(torch.randn, shape, generator, **kw)


def rand(shape: Sequence[int], generator: MaybeShard, **kw) -> torch.Tensor:
    """``torch.rand(shape)``; its first axis is the batch's."""
    return _rows(torch.rand, shape, generator, **kw)


def randint(low: int, high: int, shape: Sequence[int], generator: MaybeShard,
            **kw) -> torch.Tensor:
    """``torch.randint(low, high, shape)``; its first axis is the batch's."""
    return _rows(lambda sh, **k: torch.randint(low, high, sh, **k), shape,
                 generator, **kw)
