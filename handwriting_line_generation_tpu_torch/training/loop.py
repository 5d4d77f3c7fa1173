"""The iteration loop the trainers share: in-loop validation, checkpoints,
resume and SIGINT.

Counterpart of the loops in ``HWRTrainer.train``, ``AutoTrainer.train`` and
``GanTrainer.train`` of ``handwriting_line_generation_tpu/training/``.  A
run directory is ``<trainer.save_dir>/<name>``.  The loop refuses to start a
fresh run over one that holds checkpoints, resumes from its
``checkpoint-latest`` (and the ``train_log.json`` entries up to that step),
validates every ``val_every`` steps and keeps ``model_best`` by the
trainer's monitored key (``val_CER`` for the recognizer and the
autoencoder), saves on the config's ``save_step``/``save_step_minor``, and
on SIGINT finishes the step, writes ``checkpoint-latest`` with
``interrupted: true`` and leaves the loop.

Under a mesh (``train(..., mesh=, fsdp=)``, see ``parallel/mesh.py``) every
rank runs the loop on its share of each batch; the steps average their
gradients over the mesh's ``data`` axis, so the ranks' states stay equal.
Rank 0 alone writes the run directory (checkpoints, ``train_log.json``,
samples) and a barrier follows each full checkpoint; the ranks agree on a
SIGINT each step (any rank's stops all at the same step) and wait for rank
0 at the end.

A step takes the batch *iterator*: each trainer pulls what its step needs
(a GAN lesson on generated text pulls none).  The hooks below are how the
GAN adds its per-log CER, its SWA validation, SWA steps, sample dumps and
the SWA weights saved beside each checkpoint; they do nothing by default.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from handwriting_line_generation_tpu_torch.data.datasets import pad_batch
from handwriting_line_generation_tpu_torch.ops.augment import \
    quantize_image_u8
from handwriting_line_generation_tpu_torch.parallel.mesh import (
    Mesh, barrier, end_of_train_sync,
)
from handwriting_line_generation_tpu_torch.utils.checkpoint import \
    CheckpointManager
from handwriting_line_generation_tpu_torch.utils.train_log import TrainLog


def validation_batches(valid: Any, seed: int = 0) -> Iterable[Dict]:
    """A fresh pass over ``valid``: a batcher's ``batches`` from the start,
    unshuffled, its side caches drawn from ``default_rng(seed)`` (as the
    JAX trainers read their validation batcher), or a re-iterable of batch
    dicts (a list) as it is."""
    if hasattr(valid, "batches"):
        return valid.batches(np.random.default_rng(seed), shuffle=False)
    return valid


class CheckpointedTrainer:
    """State and loop of a trainer that has ``cfg``, ``model``,
    ``optimizer``, ``scheduler``, ``generator`` (its random draws), ``step``,
    ``init_state(seed)``, ``validate(batches, max_batches)`` and
    ``_step_metrics(batch, log_step)`` (or its own :meth:`_train_step`)."""

    model: Optional[torch.nn.Module] = None
    VAL_BATCHES = 10                  # validation batches, as in JAX
    LOG_AT_VALIDATION = False         # write train_log.json at each one
    mesh: Optional[Mesh] = None       # data-parallel grid (use_mesh)
    fsdp = False                      # Adam state over the mesh's model axis

    def use_mesh(self, mesh: Optional[Mesh], fsdp: bool = False) -> None:
        """Train on this rank's share of each batch of ``mesh``'s ``data``
        axis, the gradients averaged over it, and with ``fsdp`` the Adam
        state sharded over its ``model`` axis.  Call before the state is
        built."""
        if self.model is not None:
            raise ValueError("use_mesh must come before init_state")
        self.mesh, self.fsdp = mesh, fsdp

    @property
    def _shard(self) -> Optional[Mesh]:
        """The mesh that shards the optimizers' state, if any."""
        m = self.mesh
        return m if self.fsdp and m is not None and m.model > 1 else None

    def _rows(self, generator):
        """``generator`` drawing this rank's rows of the global batch."""
        return generator if self.mesh is None else self.mesh.rows(generator)

    def _common(self, batch: Dict) -> Dict:
        """``batch`` padded to the widest image and the longest labels any
        rank holds at this step (the batchers bucket each rank's lines on
        their own), so the ranks step on the rows of one global batch and
        draw equal shapes."""
        m = self.mesh
        if m is None or m.data == 1:
            return batch
        sp = batch.get("spaced_label")
        return pad_batch(batch, *m.max_ints(
            [batch["image"].shape[2], batch["label"].shape[1],
             0 if sp is None else sp.shape[1]]))

    def _average(self, tensors) -> None:
        """Average ``tensors`` over the mesh's ``data`` axis, in place."""
        if self.mesh is not None:
            self.mesh.all_reduce_mean(tensors)

    def _global_means(self, totals: Dict[str, float], n: int
                      ) -> Dict[str, float]:
        """``totals / n``, the sums and the batch count taken over the
        mesh's ``data`` axis first (ranks may hold different numbers of
        validation batches), so every rank gets the global means."""
        if self.mesh is None or self.mesh.data == 1:
            return {k: v / max(n, 1) for k, v in totals.items()}
        keys = sorted(totals)
        t = torch.tensor([totals[k] for k in keys] + [float(n)],
                         dtype=torch.float64, device=self.device)
        self.mesh.all_reduce_mean([t])
        t = t.tolist()
        return {k: v / max(t[-1], 1e-30) for k, v in zip(keys, t[:-1])}

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

    def monitor(self) -> Tuple[Optional[str], str]:
        """The validation key ``model_best`` follows, and ``min``/``max``."""
        return "val_CER", "min"

    def _step_metrics(self, batch: Dict, log_step: bool) -> Dict:
        """One train step on ``batch``; its metrics to log (``log_step``:
        the step is one that ``log_every`` records)."""
        raise NotImplementedError

    def _train_step(self, batches: Iterator[Dict], iteration: int,
                    log_step: bool) -> Optional[Dict]:
        """Step ``iteration`` (1-based), pulling its batch from
        ``batches``; None when they have run out.  Float images are
        quantized to u8 first when the config's ``u8_transfer`` says so;
        under a mesh, padded to the ranks' common shapes first."""
        batch = next(batches, None)
        if batch is None:
            return None
        batch = self._common(batch)
        image = batch["image"]
        if (self.cfg.data.u8_transfer and isinstance(image, np.ndarray)
                and image.dtype != np.uint8):
            batch = dict(batch, image=quantize_image_u8(image))
        return self._step_metrics(batch, log_step)

    # -- hooks -------------------------------------------------------------

    def _log_extra(self) -> Dict:
        """Values recorded as they are (not averaged) at each log step."""
        return {}

    def _validation(self, valid: Any, val_batches: int) -> Dict:
        return self.validate(validation_batches(valid), val_batches)

    def _after_step(self, iteration: int, run_dir: str, valid: Any) -> None:
        """Work after a step's validation and before its checkpoints."""

    def _side_checkpoints(self) -> Tuple[Dict[str, Any], Dict]:
        """Objects saved beside each checkpoint as ``<name>-<key>``, and
        metadata added to every checkpoint's."""
        return {}, {}

    def _resume_side(self, run_dir: str) -> None:
        """Load the side objects of ``checkpoint-latest`` on resume."""

    # -- loop --------------------------------------------------------------

    def train(self, batches: Iterable[Dict],
              iterations: Optional[int] = None,
              log_every: Optional[int] = None,
              on_log: Optional[Callable[[Dict], None]] = None,
              val_every: Optional[int] = None, valid: Any = None,
              val_batches: Optional[int] = None,
              resume: bool = True, mesh: Optional[Mesh] = None,
              fsdp: bool = False) -> TrainLog:
        """Steps ``self.step + 1 .. iterations`` over ``batches`` (stops
        early when they run out), logging each step's metrics, averaged over
        ``log_every`` steps; every ``val_every`` steps (the config's
        ``val_step`` by default) validation on up to ``val_batches``
        (``VAL_BATCHES`` by default) of ``valid`` (a batcher or a list of
        batch dicts), ``model_best`` kept by :meth:`monitor`.  A resumed run
        continues from ``checkpoint-latest``'s step, and ``batches`` should
        continue from there too.  ``mesh``/``fsdp``: as :meth:`use_mesh`;
        under a mesh ``batches`` holds this rank's shares and must not run
        out (``forever`` does not)."""
        c = self.cfg
        if mesh is not None:
            self.use_mesh(mesh, fsdp)
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
            self._resume_side(ckpt.directory)
            log.resume_from(log_path, self.step)
        key, mode = self.monitor()
        sign = -1.0 if mode == "max" else 1.0
        stop = threading.Event()
        # a handler can be set from the main thread only
        main = threading.current_thread() is threading.main_thread()
        old = (signal.signal(signal.SIGINT, lambda *_: stop.set())
               if main else None)
        meta = {"name": c.name}
        it = iter(batches)
        try:
            for i in range(self.step + 1, iterations + 1):
                metrics = self._train_step(it, i, i % log_every == 0)
                if metrics is None:
                    break
                log.step(metrics)
                if i % log_every == 0:
                    entry = log.record(i, self._log_extra())
                    if on_log:
                        on_log(entry)
                monitor = None
                if val_every and valid is not None and i % val_every == 0:
                    val = self._validation(valid, val_batches)
                    log.record(i, val)
                    if on_log:
                        on_log(val)
                    if key in val:
                        monitor = sign * val[key]
                    if self.LOG_AT_VALIDATION:
                        log.save(log_path)
                self._after_step(i, ckpt.directory, valid)
                side, side_meta = self._side_checkpoints()
                ckpt.maybe_save(i, self.state_dict, dict(meta, **side_meta),
                                monitor_value=monitor,
                                best=lambda: {"model":
                                              self.model.state_dict()},
                                extra=side)
                if (stop.is_set() if self.mesh is None
                        else self.mesh.any(stop.is_set())):
                    ckpt.save("checkpoint-latest", self.state_dict(),
                              dict(meta, **side_meta, iteration=i,
                                   interrupted=True), side)
                    barrier()
                    break
        finally:
            if main:
                signal.signal(signal.SIGINT, old)
            log.save(log_path)
        end_of_train_sync()
        return log
