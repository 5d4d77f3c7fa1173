"""Where the time of one HWR train step goes on the card.

Builds the ``configs/iam_hwr.json`` trainer (full-width ``CNNOnlyHWR``,
group norm, warp augmentation, f32, seeded weights) on a seeded batch of
16 u8 lines of 64 x 1024 and prints, with TF32 off:

* per layer, by CUDA events after warm-up: augmentation (dequantize +
  brightness + warp), the conv trunk forward, the 1-D stack and head
  forward (whole forward minus trunk), forward + backward of the loss, the
  CTC kernel alone (forward + backward), the Adam step, and the whole step;
* per step, over one profiled window of 3 steps
  (:func:`.profiling.profiled_window`): wall time, device busy time, the
  idle share 1 - busy / wall, and device time by kernel group and by
  kernel;
* the float operations of one step's forward and backward as
  :mod:`.flops` counts them, and the rate they reach in the measured step
  time;
* ms per train step in each precision (:func:`.profiling.by_precision`):
  float32 with TF32 off, with TF32 on, and ``model.compute_dtype =
  "bfloat16"``.

    python -m handwriting_line_generation_tpu_torch.trace_train

Needs a CUDA device.  Prints one JSON line last.
"""

from __future__ import annotations

import json
import pathlib

import torch

from handwriting_line_generation_tpu_torch import flops
from handwriting_line_generation_tpu_torch import profiling as prof
from handwriting_line_generation_tpu_torch.config import load_config
from handwriting_line_generation_tpu_torch.ops import ctc
from handwriting_line_generation_tpu_torch.ops.augment import (
    apply_augmentation, dequantize_image,
)
from handwriting_line_generation_tpu_torch.training.hwr_trainer import \
    HWRTrainer

CONFIG = pathlib.Path(__file__).resolve().parents[1] / "configs/iam_hwr.json"
B = 16


def step_flop(tr: HWRTrainer, data) -> float:
    """Float operations of one step's loss forward and backward
    (:mod:`.flops`)."""
    def step():
        loss, _ = tr.loss(*data)
        loss.backward()
    return flops.count(step)[1]


def trainer(device: str = "cuda", dtype: str = "float32",
            seed: int = 0) -> HWRTrainer:
    """The config's trainer in ``dtype``, seeded weights."""
    cfg = load_config(str(CONFIG))
    cfg.model.compute_dtype = dtype
    tr = HWRTrainer(cfg, device=device)
    tr.init_state(seed=seed)
    return tr


def precision_ms(data, card: str = "") -> dict:
    """ms per train step in each precision; prints the rates."""
    steps = prof.by_precision(lambda dt: trainer("cuda", dt),
                              lambda tr: tr.train_step(*data))
    print(f"HWR train step (iam_hwr, B={B}, 64x{prof.W}) by precision: "
          + ", ".join(f"{k} {v:.3f} ms ({B * 1e3 / v:.1f} lines/s)"
                      for k, v in steps.items()) + f" {card}", flush=True)
    return steps


def layer_times(tr: HWRTrainer, data) -> dict:
    image, label, lens, width = data
    model, gen = tr.model, tr.generator
    img = dequantize_image(image, width)
    aug = lambda: apply_augmentation(tr.augmentation, img, None, gen)
    x = aug()[0]
    with torch.no_grad():
        trunk = prof.event_ms(lambda: model.trunk(x.permute(0, 3, 1, 2)))
        forward = prof.event_ms(lambda: model(x))

    def fwd_bwd():
        loss, _ = tr.loss(*data)
        loss.backward()
    loss, logp = tr.loss(*data)
    m = logp.detach().contiguous()
    times = {
        "augment": prof.event_ms(lambda: apply_augmentation(
            tr.augmentation, dequantize_image(image, width), None, gen)),
        "trunk forward": trunk,
        "1-D stack + head forward": forward - trunk,
        "loss forward + backward": prof.event_ms(fwd_bwd),
        "ctc kernel forward + backward": prof.event_ms(
            lambda: ctc._launch(m, label, lens, True), 50),
        "adam step": prof.event_ms(tr.optimizer.step),
        "train step": prof.event_ms(lambda: tr.train_step(*data)),
    }
    return times


def main() -> None:
    prof.set_tf32(False)
    tr = trainer()
    data = prof.glyph_batch(B)
    times = layer_times(tr, data)
    for k, v in times.items():
        print(f"  {k:32s} {v:9.3f} ms")
    win = prof.profiled_window(lambda: tr.train_step(*data))
    prof.print_window("train step", win, top=15)
    step_ms = times["train step"]
    flop = step_flop(tr, data)
    print(f"operations: {flop / 1e12:.3f} TFLOP per step (flops.py, "
          f"forward + backward), {flop / step_ms / 1e9:.1f} TFLOP/s in the "
          f"{step_ms:.3f} ms step (CUDA events)")
    del tr
    steps = precision_ms(data)
    print(json.dumps({"batch": B, "width": prof.W, "layers_ms": times,
                      "step_ms_by_precision": steps,
                      "step_tflop": flop / 1e12,
                      "profiled_wall_ms": win["wall_ms"],
                      "busy_ms": win["busy_ms"],
                      "idle_share": win["idle_share"],
                      "groups_ms": win["groups_ms"],
                      "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
