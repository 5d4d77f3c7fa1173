"""Learning-rate schedules of ``handwriting_line_generation_tpu/training/
train_state.py`` (``make_lr_schedule``), as functions of the 0-based update
count, which is what optax passes its schedule.  :func:`make_optimizer`
pairs one with ``torch.optim.Adam`` through ``LambdaLR``: optax's Adam and
torch's compute the same update (bias-corrected moments, ``eps`` added to
the square root)."""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import torch

from handwriting_line_generation_tpu_torch.config import OptimConfig


def make_lr_schedule(kind, base_lr: float, total_iters: int,
                     warmup_steps: int = 1000, cycle_size: int = 500,
                     min_lr_mul: float = 0.001, low_lr_mul: float = 0.25
                     ) -> Callable[[int], float]:
    """``step -> lr`` for the reference's schedules: ``none``, ``LR_test``,
    ``cyclic``, ``cyclic-full``, ``1cycle``, ``rampup`` and
    ``warmup``/``detector``."""
    if not kind or kind == "none":
        return lambda step: base_lr
    if kind == "LR_test":
        start = 1e-6
        slope = (1.0 - start) / max(total_iters, 1)
        return lambda step: base_lr * (start + slope * step)
    if kind == "cyclic":
        return lambda step: base_lr * (
            1 - (1 - min_lr_mul) * ((step - 1) % cycle_size)
            / (cycle_size - 1))
    if kind == "cyclic-full":
        def tri(step):
            phase = (step % cycle_size) / (cycle_size - 1)
            rising = (step // cycle_size) % 2 == 0
            frac = (phase * (1 - low_lr_mul) + low_lr_mul if rising
                    else 1 - phase * (1 - low_lr_mul))
            return base_lr * frac
        return tri
    if kind == "1cycle":
        trail = max(total_iters - 2 * cycle_size, 1)

        def one(step):
            up = (step % cycle_size) / (cycle_size - 1)
            if step < cycle_size:
                frac = up * (1 - low_lr_mul) + low_lr_mul
            elif step < 2 * cycle_size:
                frac = 1 - up * (1 - low_lr_mul)
            else:
                t = min(max(step - 2 * cycle_size, 0), trail)
                frac = (low_lr_mul * (trail - t) / trail
                        + min_lr_mul * t / trail)
            return base_lr * frac
        return one
    if kind == "rampup":
        return lambda step: base_lr * min(1.0, (step + 0.001) / warmup_steps)
    if kind in ("detector", "warmup", "True", True):
        return lambda step: base_lr * min(
            (step + 1.0) ** -0.3, (step + 1.0) * warmup_steps ** -1.3)
    raise ValueError(f"unknown lr schedule {kind!r}")


def make_optimizer(params: Iterable[torch.nn.Parameter], cfg: OptimConfig,
                   total_iters: int
                   ) -> Tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]:
    """Adam with ``cfg.betas`` and eps 1e-8, its learning rate following
    :func:`make_lr_schedule` (call the scheduler's ``step`` after each
    optimizer step)."""
    if cfg.kind != "adam" or cfg.weight_decay:
        raise NotImplementedError(f"optimizer {cfg.kind!r} with weight decay "
                                  f"{cfg.weight_decay} is not ported")
    sched = make_lr_schedule(cfg.lr_schedule, cfg.lr, total_iters,
                             cfg.warmup_steps, cfg.cycle_size)
    opt = torch.optim.Adam(params, lr=cfg.lr, betas=tuple(cfg.betas),
                           eps=1e-8)
    return opt, torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: sched(step) / cfg.lr)
