"""Losses of the GAN trainer.

Counterpart of ``handwriting_line_generation_tpu/training/losses.py``: the
adversarial losses (hinge for the discriminator, ``-mean`` for the
generator), which the trainer calls by name as functions, the VAE style KL,
and the registry of losses a config names by string, under the JAX
package's names (``L1Loss``, ``MSELoss``/``MSE``, ``CrossEntropyLoss``,
``HingeLoss``, ``AdaptiveHingeLoss``, ``sigmoid_BCE_loss``, ``styleReg``,
``VAEKL``; the CTC goes through ``ops.ctc.ctc_loss_fast``).  Discriminator
scores arrive in float32.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch


def l1(pred: torch.Tensor, target: torch.Tensor, **_) -> torch.Tensor:
    return (pred - target).abs().mean()


def mse(pred: torch.Tensor, target: torch.Tensor, **_) -> torch.Tensor:
    return ((pred - target) ** 2).mean()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, **_
                  ) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` under the softmax of
    ``logits``, the probabilities clamped at 1e-12 before the log (as the
    JAX loss computes them: no max subtracted)."""
    e = torch.exp(logits)
    logp = torch.log(torch.clamp(e / e.sum(-1, keepdim=True), min=1e-12))
    oh = torch.nn.functional.one_hot(labels.long(), logits.shape[-1])
    return -(oh * logp).sum(-1).mean()


def hinge(pred: torch.Tensor, target: torch.Tensor, threshold: float = 0.0,
          **_) -> torch.Tensor:
    """Dead-zone L1: no penalty within ``threshold``."""
    return torch.relu((pred - target).abs() - threshold).mean()


def adaptive_hinge(pred: torch.Tensor, target: torch.Tensor,
                   low: float = 0.5, high: float = 2.0, **_) -> torch.Tensor:
    """Hinge whose dead zone is a tenth of ``|target|``, clamped to
    ``[low, high]``."""
    thresh = torch.clamp(target.abs() * 0.1, low, high)
    return torch.relu((pred - target).abs() - thresh).mean()


def sigmoid_bce(pred: torch.Tensor, target: torch.Tensor, **_
                ) -> torch.Tensor:
    """Binary cross-entropy of logits ``pred`` against targets above or
    below 0.5, the signed logit clipped to ``[-30, 30]``."""
    p = torch.clamp(torch.where(target > 0.5, pred, -pred), -30, 30)
    return torch.log1p(torch.exp(-p)).mean()


def style_reg(style: torch.Tensor, weight_dummy=None, **_) -> torch.Tensor:
    """L2 magnitude regularizer of style vectors."""
    return (style ** 2).mean()


def vae_kl(mu: torch.Tensor, log_sigma: torch.Tensor, **_) -> torch.Tensor:
    """KL(N(mu, sigma) || N(0, 1)), averaged over entries."""
    return (0.5 * (torch.exp(2 * log_sigma) + mu ** 2 - 1.0
                   - 2 * log_sigma)).mean()


REGISTRY: Dict[str, Callable] = {
    "L1Loss": l1,
    "MSE": mse,
    "MSELoss": mse,
    "CrossEntropyLoss": cross_entropy,
    "HingeLoss": hinge,
    "AdaptiveHingeLoss": adaptive_hinge,
    "sigmoid_BCE_loss": sigmoid_bce,
    "styleReg": style_reg,
    "VAEKL": vae_kl,
}


def get_loss(name: str) -> Callable:
    return REGISTRY[name]


def disc_hinge_loss(real_scores: List[torch.Tensor],
                    fake_scores: List[torch.Tensor]) -> torch.Tensor:
    """Mean over scales of ``mean(relu(1 - real)) + mean(relu(1 + fake))``."""
    total = 0.0
    for r, f in zip(real_scores, fake_scores):
        total = total + torch.relu(1.0 - r).mean() \
            + torch.relu(1.0 + f).mean()
    return total / len(real_scores)


def gen_adv_loss(fake_scores: List[torch.Tensor]) -> torch.Tensor:
    """``-mean(D(fake))``, averaged over scales."""
    total = 0.0
    for f in fake_scores:
        total = total - f.mean()
    return total / len(fake_scores)
