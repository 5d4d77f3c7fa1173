"""Alignment of CTC predictions to labels.

Counterpart of ``handwriting_line_generation_tpu/ops/align.py``.  Both
alignments are recursions over the ``T`` frames, run here as a Python loop
of batched ``[B, S]`` tensor steps (no host sync inside either loop):

* :func:`viterbi_align` — CTC forced alignment (the best path through the
  CTC lattice), the default of ``HWWithStyle.autoencode``: output length
  exactly ``T``.  The max-plus form of the CTC alpha recursion, with int8
  backpointers and a backtrace vectorised over the batch.
* :func:`dtw_align` — the reference's banded DTW (cost ``1 - logp``, moves
  up/diag/left with that tie-break order, band ``max(T//2, |T-S|)``), whose
  in-row "left" chains are resolved with a running minimum.

Conventions: ``log_probs [B, T, C]`` (class 0 blank), ``labels [B, L]``.
Outputs are index sequences, batch-major.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

BIG = 1e30


def _extend_labels(labels: torch.Tensor) -> torch.Tensor:
    """[B, L] -> blank-interleaved [B, 2L+1], in the labels' dtype."""
    b, l = labels.shape
    ext = torch.zeros((b, 2 * l + 1), dtype=labels.dtype, device=labels.device)
    ext[:, 1::2] = labels
    return ext


def _emissions(log_probs: torch.Tensor, ext: torch.Tensor) -> torch.Tensor:
    """``[B, T, S]`` log-probs of each extended-label state: a gather, equal
    bit for bit to the JAX package's one-hot contraction."""
    B, T, _ = log_probs.shape
    idx = ext.long()[:, None, :].expand(B, T, ext.shape[1])
    return torch.gather(log_probs, 2, idx)


def _wrap(i: torch.Tensor, n: int) -> torch.Tensor:
    """A JAX dynamic index: negative values count from the end, then the
    index is clamped into ``[0, n)``."""
    return torch.where(i < 0, i + n, i).clamp(0, n - 1)


def viterbi_align(log_probs: torch.Tensor, labels: torch.Tensor,
                  label_lengths: torch.Tensor) -> torch.Tensor:
    """CTC forced alignment: the best lattice path, ``aligned [B, T]`` of
    blank-interleaved label values (in ``labels``' dtype).

    A state's move is 1 (from s-1) only when strictly better than staying,
    and 2 (skip from s-2) only when strictly better than both; the final
    state is the last blank when its score is >= the last label's."""
    return viterbi_backtrace(*viterbi_moves(log_probs, labels,
                                            label_lengths))


def viterbi_moves(log_probs: torch.Tensor, labels: torch.Tensor,
                  label_lengths: torch.Tensor):
    """The max-plus recursion: ``(moves [T-1, B, S] int8, final state [B],
    ext [B, S])``; ``moves[t - 1]`` holds the backpointer deltas at frame
    ``t``.

    Each step is six kernel launches: alpha lives in a buffer behind two
    -BIG columns, so its s-1 and s-2 shifts are views, and the comparisons
    write into preallocated rows.  The JAX recursion also sets the states
    past each label (``s >= 2L + 1``) to -BIG every step; here they run on
    unmasked, which changes no valid state, since a state reads only the
    states before it and the valid ones are a prefix."""
    B, T, _ = log_probs.shape
    ext = _extend_labels(labels)                         # [B, S]
    S = ext.shape[1]
    dev = log_probs.device
    ext_m2 = F.pad(ext[:, :-2], (2, 0), value=0)
    can_skip = (ext != 0) & (ext != ext_m2)
    s_idx = torch.arange(S, device=dev)[None, :]
    lens = label_lengths.to(dev).long()
    valid_s = s_idx < (2 * lens[:, None] + 1)
    emit = _emissions(log_probs, ext)                    # [B, T, S]

    buf = torch.full((B, S + 2), -BIG, dtype=emit.dtype, device=dev)
    alpha, a1, a2 = buf[:, 2:], buf[:, 1:-1], buf[:, :-2]
    alpha.copy_(torch.where(valid_s & (s_idx < 2), emit[:, 0, :], -BIG))
    up = torch.empty((T - 1, B, S), dtype=torch.bool, device=dev)
    skip = torch.empty_like(up)
    for t in range(1, T):
        # a skip from s-2 that the label forbids is a -BIG candidate, as
        # in the JAX recursion (it wins where every real one is below -BIG)
        a2m = torch.where(can_skip, a2, -BIG)
        m01 = torch.maximum(alpha, a1)
        torch.gt(a1, alpha, out=up[t - 1])
        torch.gt(a2m, m01, out=skip[t - 1])
        torch.add(emit[:, t, :], torch.maximum(m01, a2m), out=alpha)
    moves = torch.where(skip, 2, up.to(torch.int8)).to(torch.int8)

    send = 2 * lens                                      # [B]
    slab = torch.clamp(send - 1, min=0)
    a_blank = torch.gather(alpha, 1, send[:, None])[:, 0]
    a_lab = torch.gather(alpha, 1, slab[:, None])[:, 0]
    return moves, torch.where(a_blank >= a_lab, send, slab), ext


def viterbi_backtrace(moves: torch.Tensor, j: torch.Tensor,
                      ext: torch.Tensor) -> torch.Tensor:
    """Follow the backpointers from state ``j`` at the last frame, all
    samples at once; the visited states' label values ``[B, T]``."""
    deltas = moves.long()
    states = [j]
    for t in range(deltas.shape[0] - 1, -1, -1):
        j = j - torch.gather(deltas[t], 1, j[:, None])[:, 0]
        states.append(j)
    return torch.gather(ext, 1, torch.stack(states[::-1], dim=1))


def dtw_align(log_probs: torch.Tensor, labels: torch.Tensor,
              out_len: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Banded DTW alignment with the reference's semantics.

    Returns ``(aligned [B, out_len], lengths [B])``: the path's sequence of
    blank-interleaved label values, zero-padded at the tail.  ``out_len``
    defaults to ``T + S``, the longest possible path; a shorter one trims,
    a longer one pads."""
    B, T, _ = log_probs.shape
    ext = _extend_labels(labels)                         # [B, S]
    S = ext.shape[1]
    dev = log_probs.device
    w = max(T // 2, abs(T - S))
    cost = 1.0 - _emissions(log_probs, ext)              # [B, T, S]
    j_idx = torch.arange(1, S + 1, device=dev)           # dp columns 1..S

    dp = torch.full((B, S + 1), BIG, dtype=torch.float32, device=dev)
    dp[:, 0] = 0.0
    hists = []
    for i in range(1, T + 1):
        in_band = ((j_idx >= max(1, i - w)) & (j_idx <= min(S, i + w)))[None]
        up, diag = dp[:, 1:], dp[:, :-1]                 # dp[i-1, j], [j-1]
        m = torch.where(in_band, torch.minimum(up, diag), BIG)
        # left-move chains: dp[i, j] = Ccum[j] + min_{k<=j}(m[k] - Ccum[k-1])
        ccum = torch.cumsum(cost[:, i - 1], dim=1)
        ccum_m1 = F.pad(ccum[:, :-1], (1, 0))
        row = ccum + torch.cummin(m - ccum_m1, dim=1).values
        row = torch.where(in_band, row, BIG)
        # up beats diag beats left on ties, over the raw candidate cells
        left = F.pad(row[:, :-1], (1, 0), value=BIG)
        upc = torch.where(in_band, up, BIG)
        diagc = torch.where(in_band, diag, BIG)
        best = torch.minimum(torch.minimum(upc, diagc), left)
        hist = torch.where(left <= best, 2, 0)
        hist = torch.where(diagc <= best, 1, hist)
        hists.append(torch.where(upc <= best, 0, hist).to(torch.int8))
        dp = F.pad(row, (1, 0), value=BIG)
    history = torch.stack(hists, dim=1)                  # [B, T, S]

    # backtrace from (T-1, S-1), emitting ext[j] at every visited cell
    max_steps = T + S
    flat = history.reshape(B, T * S)
    i = torch.full((B,), T - 1, dtype=torch.long, device=dev)
    j = torch.full((B,), S - 1, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    vals = [ext[:, S - 1].long()]
    for _ in range(max_steps - 1):
        move = torch.gather(flat, 1, (_wrap(i, T) * S + _wrap(j, S))[:, None]
                            )[:, 0]
        ni = torch.where(move != 2, i - 1, i)
        nj = torch.where(move != 0, j - 1, j)
        done = done | ((i <= 0) & (j <= 0))
        i = torch.where(done, i, ni)
        j = torch.where(done, j, nj)
        v = torch.gather(ext, 1, _wrap(j, S)[:, None])[:, 0].long()
        vals.append(torch.where(done, -1, v))
    vals = torch.stack(vals, dim=1)                      # [B, max_steps]
    n = (vals >= 0).sum(dim=1)                           # path lengths
    # reverse the valid prefix into the head of the output
    k = torch.arange(max_steps, device=dev)[None]
    src = torch.clamp(n[:, None] - 1 - k, 0, max_steps - 1)
    aligned = torch.where(k < n[:, None], torch.gather(vals, 1, src), 0)
    aligned = aligned.to(labels.dtype)
    if out_len is not None and out_len != max_steps:
        if out_len <= max_steps:
            aligned = aligned[:, :out_len]
        else:
            aligned = F.pad(aligned, (0, out_len - max_steps))
    return aligned, n
