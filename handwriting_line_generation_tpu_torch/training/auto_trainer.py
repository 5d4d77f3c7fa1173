"""Perceptual-autoencoder pretrainer: phase 2 of the system.

Counterpart of ``handwriting_line_generation_tpu/training/auto_trainer.py``
(the ``cf_IAM_auto_2tight_newCTC`` recipe): u8 batch -> dequantize ->
``Autoencoder`` -> L1 reconstruction loss + CTC (the CUDA kernel on the
card) on the ``EHWR`` head's ``T = W/8`` frames -> Adam.  Dropout runs in
every train step, its masks drawn from one device ``torch.Generator``
seeded in :meth:`AutoTrainer.init_state` (the JAX trainer splits
``state.rng``); eval steps are deterministic.

The trainer takes any iterator of batch dicts (``image`` u8 ``[B, H, W, 1]``
or normalized float, ``label`` ``[B, L]``, ``label_lengths`` ``[B]``,
``width`` ``[B]``, ``gt`` strings), as ``HWRTrainer`` does, and
its ``train`` is the loop of ``training/loop.py``.  Under a mesh it
steps as ``HWRTrainer`` does: the rows of the global batch's dropout masks,
the gradients and losses averaged over ``data`` in one bucket before Adam.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, Mapping, Optional, Tuple

import torch

from handwriting_line_generation_tpu_torch.charset import (
    ctc_greedy_decode_batch, get_charset,
)
from handwriting_line_generation_tpu_torch.config import Config
from handwriting_line_generation_tpu_torch.convert import \
    convert_autoencoder_params
from handwriting_line_generation_tpu_torch.device import resolve_device
from handwriting_line_generation_tpu_torch.init import init_autoencoder
from handwriting_line_generation_tpu_torch.ops.augment import \
    dequantize_image
from handwriting_line_generation_tpu_torch.ops.ctc import ctc_loss_fast
from handwriting_line_generation_tpu_torch.training.loop import \
    CheckpointedTrainer
from handwriting_line_generation_tpu_torch.training.train_state import \
    make_optimizer
from handwriting_line_generation_tpu_torch.utils.error_rates import \
    batch_cer_wer


class AutoTrainer(CheckpointedTrainer):
    """``AutoTrainer(cfg, device=None)``: ``cuda`` unless ``device`` names
    another; call :meth:`init_state` before stepping."""

    VAL_BATCHES = 5

    def __init__(self, cfg: Config, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.charset = get_charset(cfg.data.charset)
        ae = cfg.autoencoder
        self.kind = ae.kind if ae else "2tight"
        self.hwr_classes = ae.hwr_classes if ae else self.charset.num_class
        self.w_auto = cfg.trainer.loss_weights.get("auto", 1.0)
        self.w_recog = cfg.trainer.loss_weights.get("recog", 1.0)
        self.model = None

    # -- state ---------------------------------------------------------

    def init_state(self, seed: int = 0,
                   params: Optional[Mapping] = None) -> None:
        """Seeded weights (or a flax ``Autoencoder`` tree ``params``),
        Adam, and the dropout generator (seed + 1)."""
        c = self.cfg
        model = init_autoencoder(self.kind, self.hwr_classes, seed,
                                 dtype=c.model.torch_compute_dtype())
        if params is not None:
            model.load_state_dict(convert_autoencoder_params(params))
        self.model = model.to(self.device)
        # the JAX trainer's optax.adam runs at a constant learning rate
        self.optimizer, self.scheduler = make_optimizer(
            self.model.parameters(),
            dataclasses.replace(c.optimizer, lr_schedule="none"),
            c.trainer.iterations, self._shard)
        self.generator = torch.Generator(self.device).manual_seed(seed + 1)
        self.step = 0

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device, non_blocking=True)

    # -- steps ---------------------------------------------------------

    def loss(self, image, label, label_lengths, width=None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training loss of a batch, differentiable w.r.t. the model,
        with dropout: ``(loss, {"autoLoss", "recogLoss", "logp"})``.  The
        CTC runs over all ``T = W/8`` frames, unmasked, as in the JAX
        trainer."""
        image, label, label_lengths = map(self._tensor,
                                          (image, label, label_lengths))
        width = None if width is None else self._tensor(width)
        self.model.train()
        image = dequantize_image(image, width)
        recon, logp = self.model(image, self._rows(self.generator))
        auto = (recon - image).abs().mean()
        recog = ctc_loss_fast(logp, label, label_lengths)
        loss = self.w_auto * auto + self.w_recog * recog
        return loss, {"autoLoss": auto, "recogLoss": recog, "logp": logp}

    def train_step(self, image, label, label_lengths, width=None
                   ) -> Dict[str, torch.Tensor]:
        """One Adam step on a batch; returns the (detached) ``loss``,
        ``autoLoss``, ``recogLoss`` (over the global batch under a mesh)
        and ``logp`` ``[B, T, C]``."""
        loss, aux = self.loss(image, label, label_lengths, width)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        out = {"loss": loss.detach().clone(),
               **{k: v.detach().clone() for k, v in aux.items()
                  if k != "logp"}}
        self._average([p.grad for p in self.model.parameters()
                       if p.grad is not None] + list(out.values()))
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1
        return dict(out, logp=aux["logp"].detach())

    @torch.no_grad()
    def eval_step(self, image, label, label_lengths, width=None
                  ) -> Dict[str, torch.Tensor]:
        """Deterministic losses, reconstruction and log-probs.  A float
        image is used as it is, as the JAX eval step does; a u8 one is
        dequantized first."""
        image, label, label_lengths = map(self._tensor,
                                          (image, label, label_lengths))
        width = None if width is None else self._tensor(width)
        self.model.eval()
        image = dequantize_image(image, width)
        recon, logp = self.model(image)
        return {"val_autoLoss": (recon - image).abs().mean(),
                "val_recogLoss": ctc_loss_fast(logp, label, label_lengths),
                "recon": recon, "logp": logp}

    # -- loops ---------------------------------------------------------

    def validate(self, batches: Iterable[Dict],
                 max_batches: Optional[int] = None) -> Dict[str, float]:
        """``val_autoLoss``, ``val_recogLoss`` and ``val_CER`` (greedy
        decoding): each batch's mean, averaged over the batches (every
        rank's, under a mesh)."""
        totals = {"val_autoLoss": 0.0, "val_recogLoss": 0.0, "val_CER": 0.0}
        n = 0
        for batch in itertools.islice(batches, max_batches):
            out = self.eval_step(batch["image"], batch["label"],
                                 batch["label_lengths"], batch.get("width"))
            preds = ctc_greedy_decode_batch(out["logp"].cpu().numpy(),
                                            self.charset)
            cer, _ = batch_cer_wer(batch["gt"], preds)
            totals["val_autoLoss"] += float(out["val_autoLoss"])
            totals["val_recogLoss"] += float(out["val_recogLoss"])
            totals["val_CER"] += cer
            n += 1
        return self._global_means(totals, n)

    def _step_metrics(self, batch: Dict, log_step: bool) -> Dict:
        """The step's ``loss``, ``autoLoss`` and ``recogLoss``."""
        out = self.train_step(batch["image"], batch["label"],
                              batch["label_lengths"], batch["width"])
        return {k: v for k, v in out.items() if k != "logp"}
