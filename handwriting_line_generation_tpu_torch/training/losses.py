"""Losses of the GAN trainer.

Counterpart of ``handwriting_line_generation_tpu/training/losses.py``: the
adversarial losses (hinge for the discriminator, ``-mean`` for the
generator), which the trainer calls by name as functions, the VAE style KL,
and the registry entries the GAN config names by string (``L1Loss``,
``MSELoss``/``MSE``; the CTC goes through ``ops.ctc.ctc_loss_fast``).
Discriminator scores arrive in float32.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch


def l1(pred: torch.Tensor, target: torch.Tensor, **_) -> torch.Tensor:
    return (pred - target).abs().mean()


def mse(pred: torch.Tensor, target: torch.Tensor, **_) -> torch.Tensor:
    return ((pred - target) ** 2).mean()


def vae_kl(mu: torch.Tensor, log_sigma: torch.Tensor, **_) -> torch.Tensor:
    """KL(N(mu, sigma) || N(0, 1)), averaged over entries."""
    return (0.5 * (torch.exp(2 * log_sigma) + mu ** 2 - 1.0
                   - 2 * log_sigma)).mean()


REGISTRY: Dict[str, Callable] = {
    "L1Loss": l1,
    "MSE": mse,
    "MSELoss": mse,
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
