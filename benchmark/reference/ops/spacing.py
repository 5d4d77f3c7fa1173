"""Spaced-text construction and count supervision.

Counterpart of ``handwriting_line_generation_tpu/ops/spacing.py``:

* :func:`insert_spaces` — sampled counts -> cumulative-sum interval bounds
  -> one ``[B, T, L]`` interval-indicator reduce onto the static grid.
* :func:`counts_from_spaced` — run-length decode of a blank-interleaved
  alignment into ``(blanks_before, duplicates)`` per label position.

``torch.round`` and ``jnp.round`` both round half to even.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from reference.ops import rows


def onehot(labels: torch.Tensor, num_class: int) -> torch.Tensor:
    """``[...]`` int -> ``[..., num_class]`` float32 one-hot (blank = 0)."""
    return F.one_hot(labels.long(), num_class).float()


def insert_spaces(labels: torch.Tensor, label_lengths: torch.Tensor,
                  counts: torch.Tensor,
                  generator: Optional[torch.Generator] = None, *,
                  max_len: int, count_std: float = 0.1,
                  dup_std: float = 0.03, count_duplicates: bool = True,
                  normals: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Build spaced class-index maps from per-char blank/duplicate counts.

    Args:
      labels: ``[B, L]`` int labels (0-padded); ``label_lengths``: ``[B]``.
      counts: ``[B, L, 2]`` predicted ``(blanks_before, duplicates)``
        (column 1 ignored when ``count_duplicates=False``).
      generator: draws the two ``N(0, 1)`` jitter planes ``[B, L]``;
        ``normals`` passes them instead (tests inject the JAX draws).  With
        ``count_std == dup_std == 0`` neither is needed.
      max_len: static output length ``T``; characters past it are cut.

    Returns ``spaced [B, T]`` int64 class indices (blank-padded tail) and
    ``total [B]``, each line's pre-clip length.
    """
    B, L = labels.shape
    dev = counts.device
    if normals is None and (count_std or (count_duplicates and dup_std)):
        if generator is None:
            raise ValueError("count jitter needs a torch.Generator or the "
                             "normals")
        normals = (rows.randn((B, L), generator, device=dev),
                   rows.randn((B, L), generator, device=dev))
    c = counts[..., 0].float()
    if normals is not None:
        c = c + count_std * normals[0].float()
    if count_duplicates:
        d = counts[..., 1].float()
        if normals is not None:
            d = d + dup_std * normals[1].float()
    else:
        d = torch.ones((B, L), device=dev)
    # round() then clamp at 0: negative samples mean "no blanks" / "drop char"
    c = torch.clamp(torch.round(c), min=0.0)
    d = torch.clamp(torch.round(d), min=0.0)
    valid = torch.arange(L, device=dev)[None, :] < label_lengths[:, None]
    c = torch.where(valid, c, 0.0).long()
    d = torch.where(valid, d, 0.0).long()

    ends = torch.cumsum(c + d, dim=1)                 # end of char-i block
    starts = ends - d                                 # first duplicated col
    total = ends[:, -1]
    t = torch.arange(max_len, device=dev)[None, :, None]
    hit = (t >= starts[:, None, :]) & (t < ends[:, None, :])      # [B, T, L]
    spaced = torch.where(hit, labels.long()[:, None, :], 0).sum(dim=-1)
    return spaced, total


def counts_from_spaced(spaced: torch.Tensor, num_chars: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode ``(blanks_before, duplicates)`` counts from an alignment.

    ``spaced [B, S]`` is a blank-interleaved class-index sequence.  Returns
    ``(gt [B, num_chars, 2] float32, n_recorded [B])``: position ``l``
    describes the ``l``-th character run, and runs from ``n_recorded`` on
    (the final run, if the sequence ends inside it) are zeroed, as the
    reference's loop never records them.
    """
    prev = F.pad(spaced[:, :-1], (1, 0), value=0)
    is_char = spaced != 0
    run_start = is_char & ((prev == 0) | (prev != spaced))
    starts_cum = torch.cumsum(run_start.long(), dim=1)            # [B, S]
    l_idx = torch.arange(num_chars, device=spaced.device)[None, :, None]
    sc = starts_cum[:, None, :]                                   # [B, 1, S]
    dup = ((sc == l_idx + 1) & is_char[:, None, :]).sum(-1)
    blanks = ((sc == l_idx) & ~is_char[:, None, :]).sum(-1)
    gt = torch.stack([blanks, dup], dim=-1).float()
    n_recorded = starts_cum[:, -1] - is_char[:, -1].long()
    rec = torch.arange(num_chars, device=spaced.device)[None, :] \
        < n_recorded[:, None]
    return torch.where(rec[..., None], gt, 0.0), n_recorded
