"""CTC loss for the reference: ``torch.nn.functional.ctc_loss``.

The program's conventions (batch-major ``log_probs [B, T, C]``, class 0
the blank, 0-padded ``labels [B, L]``, one logit length ``T`` for every
sample, frames past a sample's ink set to blank by
:func:`mask_frames_to_blank`): a per-sample negative log-likelihood, zero
where the alignment is impossible (``nll > 5e29``, which a masked frame's
``-1e30`` gives, or not finite), each divided by ``max(label_length, 1)``,
then averaged.  PyTorch's own CTC stands in for both of the program's
(its plain recursion and its CUDA kernel), so the two are checked against
an implementation that shares no code with either.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30
_BAD_NLL = 0.5 * -NEG_INF


def mask_frames_to_blank(log_probs: torch.Tensor,
                         frame_lengths: torch.Tensor) -> torch.Tensor:
    """Frames at or past each sample's length emit blank with certainty."""
    B, T, C = log_probs.shape
    t_idx = torch.arange(T, device=log_probs.device)[None, :, None]
    in_range = t_idx < frame_lengths.to(log_probs.device)[:, None, None]
    blank_certain = torch.full((C,), NEG_INF, dtype=log_probs.dtype,
                               device=log_probs.device)
    blank_certain[0] = 0.0
    return torch.where(in_range, log_probs, blank_certain[None, None, :])


def ctc_loss_fast(log_probs: torch.Tensor, labels: torch.Tensor,
                  label_lengths: torch.Tensor) -> torch.Tensor:
    """Mean over samples of ``nll / max(label_length, 1)``."""
    B, T, _ = log_probs.shape
    lens = label_lengths.long()
    nll = F.ctc_loss(log_probs.float().transpose(0, 1), labels.long(),
                     torch.full((B,), T, dtype=torch.long,
                                device=log_probs.device),
                     lens, blank=0, reduction="none", zero_infinity=True)
    bad = ~torch.isfinite(nll) | (nll > _BAD_NLL)
    nll = torch.where(bad, torch.zeros_like(nll), nll)
    return (nll / torch.clamp(lens, min=1).to(nll.dtype)).mean()
