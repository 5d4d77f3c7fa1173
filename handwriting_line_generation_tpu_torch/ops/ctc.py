"""CTC loss: the plain PyTorch recursion, the CUDA kernel, and the dispatch.

Counterpart of ``handwriting_line_generation_tpu/ops/ctc.py`` and of
``ops/ctc_pallas.py``.  Conventions, as there (batch-major):

  log_probs: ``[B, T, C]`` log-softmax outputs, class 0 = blank.
  labels:    ``[B, L]`` int labels, 0-padded.
  Per-sample ``label_lengths`` (and ``logit_lengths`` for :func:`ctc_loss`).

* :func:`ctc_loss` — the log-space alpha recursion, op for op as the JAX
  scan, differentiable by autograd.  It is the CPU path and the kernel's
  plain version.
* :func:`ctc_loss_cuda` — the hand-written CUDA kernel ``csrc/ctc.cu``
  (the alpha recursion and, when log_probs requires grad, the beta
  recursion beside it and the gradient, in the same launch) inside a
  ``torch.autograd.Function``.  It needs
  a uniform logit length ``T``: the recognizers emit ``T = W/4`` frames for
  every sample and :func:`mask_frames_to_blank` confines each sample to its
  own frames.
* :func:`ctc_loss_fast` — the kernel for a CUDA tensor, :func:`ctc_loss` for
  a CPU tensor; any other device raises.

Per-sample negative log-likelihood; infinite or impossible losses
(``nll > 5e29``) are zeroed with their gradient; ``reduction='mean'``
divides each sample by ``max(label_length, 1)`` then averages.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from handwriting_line_generation_tpu_torch import kernels

NEG_INF = -1e30
_BAD_NLL = 0.5 * -NEG_INF
_MAX_STATES = 1024                 # 8 warps x 32 lanes x 4 states


def _extend_labels(labels: torch.Tensor) -> torch.Tensor:
    """[B, L] -> blank-interleaved [B, 2L+1]: (0, l1, 0, l2, ..., 0)."""
    b, l = labels.shape
    ext = torch.zeros((b, 2 * l + 1), dtype=torch.long, device=labels.device)
    ext[:, 1::2] = labels.long()
    return ext


def ctc_alpha(log_probs: torch.Tensor, labels: torch.Tensor,
              logit_lengths: torch.Tensor, label_lengths: torch.Tensor):
    """The forward (alpha) recursion.  Returns ``(per_sample_nll, alphas)``
    with ``alphas`` ``[T, B, S]``."""
    B, T, C = log_probs.shape
    ext = _extend_labels(labels)                             # [B, S]
    S = ext.shape[1]
    ext_m2 = F.pad(ext[:, :-2], (2, 0), value=0)
    can_skip = (ext != 0) & (ext != ext_m2)
    s_idx = torch.arange(S, device=log_probs.device)[None, :]
    label_lengths = label_lengths.long()
    valid_s = s_idx < (2 * label_lengths[:, None] + 1)

    emit0 = torch.gather(log_probs[:, 0, :], 1, ext)
    alpha = torch.where(s_idx < 2, emit0, NEG_INF)
    alpha = torch.where(valid_s, alpha, NEG_INF)
    alphas = [alpha]
    for t in range(1, T):
        emit = torch.gather(log_probs[:, t, :], 1, ext)
        a_m1 = F.pad(alpha[:, :-1], (1, 0), value=NEG_INF)
        a_m2 = F.pad(alpha[:, :-2], (2, 0), value=NEG_INF)
        a_m2 = torch.where(can_skip, a_m2, NEG_INF)
        m = torch.maximum(torch.maximum(alpha, a_m1), a_m2)
        m_safe = torch.clamp(m, min=NEG_INF)
        summed = (torch.exp(alpha - m_safe) + torch.exp(a_m1 - m_safe)
                  + torch.exp(a_m2 - m_safe))
        new = emit + m_safe + torch.log(summed)
        alpha = torch.where(valid_s, new, NEG_INF)
        alphas.append(alpha)
    alphas = torch.stack(alphas)                             # [T, B, S]

    t_idx = torch.clamp(logit_lengths.long() - 1, 0, T - 1)
    alpha_T = alphas[t_idx, torch.arange(B, device=alphas.device)]
    send = 2 * label_lengths
    a_blank = torch.gather(alpha_T, 1, send[:, None])[:, 0]
    a_label = torch.gather(alpha_T, 1,
                           torch.clamp(send - 1, min=0)[:, None])[:, 0]
    a_label = torch.where(label_lengths > 0, a_label, NEG_INF)
    m = torch.maximum(a_blank, a_label)
    ll = m + torch.log(torch.exp(a_blank - m) + torch.exp(a_label - m))
    return -ll, alphas


def _reduce(nll, label_lengths, reduction: str, zero_infinity: bool):
    if zero_infinity:
        # the reference's guard: an impossible alignment costs 0
        bad = ~torch.isfinite(nll) | (nll > _BAD_NLL)
        nll = torch.where(bad, 0.0, nll)
    if reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    if reduction == "mean":
        denom = torch.clamp(label_lengths, min=1).to(nll.dtype)
        return (nll / denom).mean()
    raise ValueError(f"unknown reduction {reduction!r}")


def ctc_loss(log_probs: torch.Tensor, labels: torch.Tensor,
             logit_lengths: torch.Tensor, label_lengths: torch.Tensor,
             reduction: str = "mean", zero_infinity: bool = True
             ) -> torch.Tensor:
    """CTC negative log-likelihood, plain PyTorch (see module docstring)."""
    nll, _ = ctc_alpha(log_probs, labels, logit_lengths, label_lengths)
    return _reduce(nll, label_lengths, reduction, zero_infinity)


def mask_frames_to_blank(log_probs: torch.Tensor,
                         frame_lengths: torch.Tensor) -> torch.Tensor:
    """Frames past each sample's length emit blank with certainty:
    ``logp[t >= len] = (0, NEG, NEG, ...)``.  Equivalent to per-sample CTC
    input lengths under the uniform-T contract; no gradient reaches the
    masked entries."""
    B, T, C = log_probs.shape
    t_idx = torch.arange(T, device=log_probs.device)[None, :, None]
    in_range = t_idx < frame_lengths.to(log_probs.device)[:, None, None]
    blank_certain = torch.full((C,), NEG_INF, dtype=log_probs.dtype,
                               device=log_probs.device)
    blank_certain[0] = 0.0
    return torch.where(in_range, log_probs, blank_certain[None, None, :])


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------


def _library() -> ctypes.CDLL:
    lib = kernels.load("ctc")
    fn = lib.ctc_forward_backward
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check(log_probs, labels, label_lengths):
    if log_probs.device.type != "cuda":
        raise ValueError(f"the CTC kernel takes CUDA tensors, got "
                         f"{log_probs.device}")
    if log_probs.dtype != torch.float32:
        raise TypeError(f"log_probs must be float32, got {log_probs.dtype}")
    if log_probs.ndim != 3 or labels.ndim != 2:
        raise ValueError(f"want log_probs [B, T, C] and labels [B, L], got "
                         f"{tuple(log_probs.shape)} and "
                         f"{tuple(labels.shape)}")
    B, T, C = log_probs.shape
    L = labels.shape[1]
    if labels.shape[0] != B or tuple(label_lengths.shape) != (B,):
        raise ValueError(f"labels {tuple(labels.shape)} and label_lengths "
                         f"{tuple(label_lengths.shape)} do not fit batch {B}")
    if 2 * L + 1 > _MAX_STATES:
        raise ValueError(f"labels of {L} > {(_MAX_STATES - 1) // 2} "
                         f"positions are not supported by the CTC kernel")
    for name, t in (("labels", labels), ("label_lengths", label_lengths)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("log_probs", log_probs), ("labels", labels),
                    ("label_lengths", label_lengths)):
        if t.device != log_probs.device:
            raise ValueError(f"{name} is on {t.device}, log_probs on "
                             f"{log_probs.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(log_probs, labels, label_lengths, compute_grad: bool):
    """One launch: per-sample nll ``[B]`` and, if asked, the gradient of
    each sample's nll w.r.t. log_probs ``[B, T, C]`` (else None)."""
    _check(log_probs, labels, label_lengths)
    B, T, C = log_probs.shape
    L = labels.shape[1]
    dev = log_probs.device
    nll = torch.empty(B, dtype=torch.float32, device=dev)
    grad = scratch = None
    if compute_grad:
        grad = torch.empty_like(log_probs)
        # alpha rows, then beta rows
        scratch = torch.empty((2, B, T, 2 * L + 1), dtype=torch.float32,
                              device=dev)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    err = _library().ctc_forward_backward(
        log_probs.data_ptr(), labels.data_ptr(), label_lengths.data_ptr(),
        nll.data_ptr(), ptr(grad), ptr(scratch), B, T, L, C,
        int(compute_grad), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ctc kernel launch failed: CUDA error {err}")
    ctc_loss_cuda.launches += 1
    return nll, grad


class _CTCNLL(torch.autograd.Function):
    """Per-sample nll through the kernel; backward scales the kernel's
    saved gradient, zeroed for bad samples as the JAX VJP does."""

    @staticmethod
    def forward(ctx, log_probs, labels, label_lengths):
        nll, grad = _launch(log_probs, labels, label_lengths,
                            compute_grad=ctx.needs_input_grad[0])
        ctx.save_for_backward(grad, nll)
        return nll

    @staticmethod
    def backward(ctx, g):
        grad, nll = ctx.saved_tensors
        bad = ~torch.isfinite(nll) | (nll > _BAD_NLL)
        grad = torch.where(bad[:, None, None], 0.0, grad)
        return g[:, None, None] * grad, None, None


def ctc_loss_cuda(log_probs: torch.Tensor, labels: torch.Tensor,
                  label_lengths: torch.Tensor,
                  reduction: str = "mean") -> torch.Tensor:
    """CTC through the CUDA kernel, for a uniform logit length ``T``.

    ``log_probs`` float32 and ``labels``/``label_lengths`` int32, all
    contiguous CUDA tensors; labels in ``[1, C)``.  Bad samples always
    cost 0, matching the backward, which zeroes their gradient.
    ``launches`` counts the kernel's launches."""
    nll = _CTCNLL.apply(log_probs, labels, label_lengths)
    return _reduce(nll, label_lengths, reduction, zero_infinity=True)


ctc_loss_cuda.launches = 0


def ctc_loss_fast(log_probs: torch.Tensor, labels: torch.Tensor,
                  label_lengths: torch.Tensor,
                  reduction: str = "mean") -> torch.Tensor:
    """Uniform-logit-length CTC: the kernel for a CUDA tensor, the plain
    recursion for a CPU tensor."""
    B, T, _ = log_probs.shape
    if log_probs.device.type == "cuda":
        return ctc_loss_cuda(log_probs.contiguous(),
                             labels.to(torch.int32).contiguous(),
                             label_lengths.to(torch.int32).contiguous(),
                             reduction)
    if log_probs.device.type != "cpu":
        raise ValueError(f"ctc_loss_fast runs on cuda or cpu, not "
                         f"{log_probs.device}")
    ilens = torch.full((B,), T, dtype=torch.long)
    return ctc_loss(log_probs, labels, ilens, label_lengths, reduction)
