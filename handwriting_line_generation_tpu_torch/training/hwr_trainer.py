"""HWR (CTC recognizer) trainer: phase 1 of the system, HWR pretraining.

Counterpart of ``handwriting_line_generation_tpu/training/hwr_trainer.py``:
u8 batch -> dequantize -> device-side augmentation -> ``CNNOnlyHWR`` ->
frames past each sample's (stretched) ink width masked to blank -> CTC
(the CUDA kernel on the card) -> Adam, with CER/WER from greedy decoding.

The trainer takes any iterator of batch dicts (``image`` u8 ``[B, H, W, 1]``
or normalized float, ``label`` ``[B, L]``, ``label_lengths`` ``[B]``,
``width`` ``[B]``, ``gt`` strings).  The JAX trainer splits ``state.rng``
each step; this one draws its augmentation from one device
``torch.Generator`` seeded in :meth:`HWRTrainer.init_state`.
:meth:`HWRTrainer.train` runs the loop of ``training/loop.py``: in-loop
validation, checkpoints, resume and SIGINT.  The training CLI
(``handwriting_line_generation_tpu_torch.train``) feeds it
``make_batcher``'s batches through a ``Prefetcher``.  Under a mesh
(``use_mesh``, or ``train(..., mesh=, fsdp=)``) each rank steps on its
share of the batch, its augmentation the rows of the global batch's draws
(``ops.rows``), the gradients and the loss averaged over the ``data`` axis
in one bucket before Adam (sharded over ``model`` with ``fsdp``); the CER
of a log step decodes the rank's own rows, and validation's means are
taken over every rank's batches.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterable, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from handwriting_line_generation_tpu_torch.charset import (
    ctc_greedy_decode_batch, get_charset,
)
from handwriting_line_generation_tpu_torch.config import Config
from handwriting_line_generation_tpu_torch.convert import convert_hwr_params
from handwriting_line_generation_tpu_torch.device import resolve_device
from handwriting_line_generation_tpu_torch.init import init_hwr
from handwriting_line_generation_tpu_torch.ops.augment import (
    apply_augmentation, dequantize_image,
)
from handwriting_line_generation_tpu_torch.ops.ctc import (
    ctc_loss_fast, mask_frames_to_blank,
)
from handwriting_line_generation_tpu_torch.training.loop import \
    CheckpointedTrainer
from handwriting_line_generation_tpu_torch.training.train_state import \
    make_optimizer
from handwriting_line_generation_tpu_torch.utils.error_rates import \
    batch_cer_wer

ArrayLike = Union[np.ndarray, torch.Tensor]


class HWRTrainer(CheckpointedTrainer):
    """``HWRTrainer(cfg, device=None)``: ``cuda`` unless ``device`` names
    another; call :meth:`init_state` before stepping."""

    def __init__(self, cfg: Config, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.charset = get_charset(cfg.data.charset)
        self.augmentation = cfg.data.augmentation
        self.model = None

    # -- state ---------------------------------------------------------

    def init_state(self, seed: int = 0,
                   params: Optional[Mapping] = None) -> None:
        """Seeded weights (or a flax ``CNNOnlyHWR`` tree ``params``), Adam
        with its schedule, and the augmentation generator (seed + 1)."""
        c = self.cfg
        dtype = c.model.torch_compute_dtype()
        model = init_hwr(c.model.hwr, self.charset.num_class, seed,
                         dtype=dtype)
        if params is not None:
            model.load_state_dict(convert_hwr_params(params))
        self.model = model.to(self.device)
        self.optimizer, self.scheduler = make_optimizer(
            self.model.parameters(), c.optimizer, c.trainer.iterations,
            self._shard)
        self.generator = torch.Generator(self.device).manual_seed(seed + 1)
        self.step = 0

    def _tensor(self, x: ArrayLike) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device, non_blocking=True)

    # -- steps ---------------------------------------------------------

    def loss(self, image: ArrayLike, label: ArrayLike,
             label_lengths: ArrayLike, width: ArrayLike
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The training loss of a batch, differentiable w.r.t. the model:
        the mean CTC loss and the masked log-probs ``[B, T, C]``."""
        image, label, label_lengths, width = map(
            self._tensor, (image, label, label_lengths, width))
        self.model.train()
        img, _, wscale = apply_augmentation(
            self.augmentation, dequantize_image(image, width), None,
            self._rows(self.generator))
        logp = self.model(img)
        # confine emissions to each sample's true (stretched) ink width
        frames = torch.ceil(width.float() * wscale / 4.0).to(torch.int32)
        frames = torch.clamp(frames, 1, logp.shape[1])
        logp = mask_frames_to_blank(logp, frames)
        return ctc_loss_fast(logp, label, label_lengths), logp

    def train_step(self, image: ArrayLike, label: ArrayLike,
                   label_lengths: ArrayLike, width: ArrayLike
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One Adam step on a batch; returns the (detached) mean CTC loss
        (over the global batch under a mesh) and the masked log-probs
        ``[B, T, C]``."""
        loss, logp = self.loss(image, label, label_lengths, width)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        loss = loss.detach().clone()
        self._average([p.grad for p in self.model.parameters()
                       if p.grad is not None] + [loss])
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1
        return loss, logp.detach()

    @torch.no_grad()
    def eval_step(self, image: ArrayLike, label: ArrayLike,
                  label_lengths: ArrayLike, width: ArrayLike
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Loss and masked log-probs without augmentation or update.  A
        float image is used as it is, as the JAX eval step does; a u8 one
        is dequantized first."""
        image, label, label_lengths, width = map(
            self._tensor, (image, label, label_lengths, width))
        self.model.eval()
        logp = self.model(dequantize_image(image, width))
        frames = torch.clamp((width + 3) // 4, 1, logp.shape[1])
        logp = mask_frames_to_blank(logp, frames)
        return ctc_loss_fast(logp, label, label_lengths), logp

    # -- loops ---------------------------------------------------------

    def validate(self, batches: Iterable[Dict],
                 max_batches: Optional[int] = None) -> Dict[str, float]:
        """Mean loss, CER and WER over ``batches`` (over every rank's
        batches under a mesh)."""
        totals = {"val_loss": 0.0, "val_CER": 0.0, "val_WER": 0.0}
        n = 0
        for batch in itertools.islice(batches, max_batches):
            loss, logp = self.eval_step(batch["image"], batch["label"],
                                        batch["label_lengths"],
                                        batch["width"])
            preds = ctc_greedy_decode_batch(logp.cpu().numpy(), self.charset)
            cer, wer = batch_cer_wer(batch["gt"], preds,
                                     self.cfg.trainer.casesensitive)
            totals["val_loss"] += float(loss)
            totals["val_CER"] += cer
            totals["val_WER"] += wer
            n += 1
        return self._global_means(totals, n)

    def _step_metrics(self, batch: Dict, log_step: bool) -> Dict:
        """The step's loss, and on a log step the CER/WER of its batch."""
        loss, logp = self.train_step(batch["image"], batch["label"],
                                     batch["label_lengths"], batch["width"])
        metrics = {"loss": loss}
        if log_step:
            preds = ctc_greedy_decode_batch(logp.cpu().numpy(), self.charset)
            cer, wer = batch_cer_wer(batch["gt"], preds,
                                     self.cfg.trainer.casesensitive)
            metrics.update(CER=cer, WER=wer)
        return metrics
