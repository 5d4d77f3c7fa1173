"""The iteration loop the trainers share: in-loop validation, checkpoints,
resume and SIGINT.

Counterpart of the loop in ``HWRTrainer.train`` and ``AutoTrainer.train``
of ``handwriting_line_generation_tpu/training/``.  A run directory is
``<trainer.save_dir>/<name>``.  The loop refuses to start a fresh run over
one that holds checkpoints, resumes from its ``checkpoint-latest`` (and
the ``train_log.json`` entries up to that step), validates every
``val_every`` steps and keeps ``model_best`` by the lowest ``val_CER``,
saves on the config's ``save_step``/``save_step_minor``, and on SIGINT
finishes the step, writes ``checkpoint-latest`` with ``interrupted: true``
and leaves the loop.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from handwriting_line_generation_tpu_torch.ops.augment import \
    quantize_image_u8
from handwriting_line_generation_tpu_torch.utils.checkpoint import (
    CheckpointManager, save_checkpoint,
)
from handwriting_line_generation_tpu_torch.utils.train_log import TrainLog


def validation_batches(valid: Any) -> Iterable[Dict]:
    """A fresh pass over ``valid``: a batcher's ``batches`` from the start,
    unshuffled (as the JAX trainers read their validation batcher), or a
    re-iterable of batch dicts (a list) as it is."""
    if hasattr(valid, "batches"):
        return valid.batches(np.random.default_rng(0), shuffle=False)
    return valid


class CheckpointedTrainer:
    """State and loop of a trainer that has ``cfg``, ``model``,
    ``optimizer``, ``scheduler``, ``generator`` (its random draws), ``step``,
    ``init_state(seed)``, ``validate(batches, max_batches)`` and
    ``_step_metrics(batch, log_step)``."""

    model: Optional[torch.nn.Module] = None

    def state_dict(self) -> Dict[str, Any]:
        """Everything a resumed run needs to continue exactly."""
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(),
                "step": self.step,
                "generator": self.generator.get_state()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.step = int(state["step"])
        self.generator.set_state(state["generator"])

    VAL_BATCHES = 10                  # validation batches, as in JAX

    def _step_metrics(self, batch: Dict, log_step: bool) -> Dict:
        """One train step on ``batch``; its metrics to log (``log_step``:
        the step is one that ``log_every`` records)."""
        raise NotImplementedError

    def train(self, batches: Iterable[Dict],
              iterations: Optional[int] = None,
              log_every: Optional[int] = None,
              on_log: Optional[Callable[[Dict], None]] = None,
              val_every: Optional[int] = None, valid: Any = None,
              val_batches: Optional[int] = None,
              resume: bool = True) -> TrainLog:
        """Steps ``self.step + 1 .. iterations`` over ``batches`` (stops
        early when they run out), logging each step's metrics, averaged over
        ``log_every`` steps; every ``val_every`` steps (the config's
        ``val_step`` by default) :meth:`validate` on up to ``val_batches``
        (``VAL_BATCHES`` by default) of ``valid`` (a batcher or a list of
        batch dicts), ``model_best`` kept by ``val_CER``.  Float images are
        quantized to u8 first when the config's ``u8_transfer`` says so.  A
        resumed run continues from ``checkpoint-latest``'s step, and
        ``batches`` should continue from there too."""
        c = self.cfg
        if self.model is None:
            self.init_state(c.trainer.seed)
        iterations = iterations or c.trainer.iterations
        log_every = log_every or c.trainer.log_step
        val_every = c.trainer.val_step if val_every is None else val_every
        val_batches = val_batches or self.VAL_BATCHES
        log = TrainLog(window=log_every)
        ckpt = CheckpointManager(os.path.join(c.trainer.save_dir, c.name),
                                 c.trainer.save_step,
                                 c.trainer.save_step_minor)
        log_path = os.path.join(ckpt.directory, "train_log.json")
        ckpt.refuse_clobber(resume)
        if ckpt.has_latest():
            self.load_state_dict(ckpt.latest())
            log.resume_from(log_path, self.step)
        stop = threading.Event()
        # a handler can be set from the main thread only
        main = threading.current_thread() is threading.main_thread()
        old = (signal.signal(signal.SIGINT, lambda *_: stop.set())
               if main else None)
        meta = {"name": c.name}
        it = iter(batches)
        try:
            for i in range(self.step + 1, iterations + 1):
                batch = next(it, None)
                if batch is None:
                    break
                image = batch["image"]
                if (c.data.u8_transfer and isinstance(image, np.ndarray)
                        and image.dtype != np.uint8):
                    batch = dict(batch, image=quantize_image_u8(image))
                log.step(self._step_metrics(batch, i % log_every == 0))
                if i % log_every == 0:
                    entry = log.record(i)
                    if on_log:
                        on_log(entry)
                monitor = None
                if val_every and valid is not None and i % val_every == 0:
                    val = self.validate(validation_batches(valid),
                                        val_batches)
                    log.record(i, val)
                    if on_log:
                        on_log(val)
                    monitor = val.get("val_CER")
                ckpt.maybe_save(i, self.state_dict, meta,
                                monitor_value=monitor,
                                best=lambda: {"model":
                                              self.model.state_dict()})
                if stop.is_set():
                    save_checkpoint(ckpt.directory, "checkpoint-latest",
                                    self.state_dict(),
                                    dict(meta, iteration=i, interrupted=True))
                    break
        finally:
            if main:
                signal.signal(signal.SIGINT, old)
            log.save(log_path)
        return log
