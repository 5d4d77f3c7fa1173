"""Metric registry: a copy of ``handwriting_line_generation_tpu/training/
metrics.py``.

The reference's metrics module is never enabled by a published config
(each sets ``"metrics": []``); the registry keeps the config surface
(``"metrics": ["class_accuracy", ...]``) with working entries.  CER and
WER, the metrics the trainers report, are in ``utils.error_rates``.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch


def class_accuracy(logits: torch.Tensor, labels: torch.Tensor, **_
                   ) -> torch.Tensor:
    """Top-1 accuracy over the class axis."""
    return (logits.argmax(-1) == labels).float().mean()


def mean_iou(pred_mask: torch.Tensor, gt_mask: torch.Tensor,
             eps: float = 1e-8, **_) -> torch.Tensor:
    """Mean intersection-over-union of binary masks (``> 0.5``) over the
    last two axes."""
    p, g = pred_mask > 0.5, gt_mask > 0.5
    inter = (p & g).sum((-2, -1)).float()
    union = (p | g).sum((-2, -1)).float()
    return (inter / (union + eps)).mean()


METRICS: Dict[str, Callable] = {
    "class_accuracy": class_accuracy,
    "meanIOU": mean_iou,
}


def get_metric(name: str) -> Callable:
    if name not in METRICS:
        raise KeyError(f"unknown metric {name!r}; have {sorted(METRICS)}")
    return METRICS[name]
