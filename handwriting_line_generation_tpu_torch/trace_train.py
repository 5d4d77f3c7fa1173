"""Where the time of one HWR train step goes on the card.

Builds the ``configs/iam_hwr.json`` trainer (full-width ``CNNOnlyHWR``,
group norm, warp augmentation, f32, seeded weights) on a seeded batch of
16 u8 lines of 64 x 1024 and prints, with TF32 off:

* per layer, by CUDA events after warm-up: augmentation (dequantize +
  brightness + warp), the conv trunk forward, the 1-D stack and head
  forward (whole forward minus trunk), forward + backward of the loss, the
  CTC kernel alone (forward + backward), the Adam step, and the whole step;
* per step under ``torch.profiler``, over one window of 3 steps: wall
  time (host clock, ending in a synchronize), device busy time, the idle
  share 1 - busy / wall, and device time by kernel group and by kernel;
* the float operations of one step's forward and backward as
  :mod:`.flops` counts them, and the rate they reach in the measured step
  time;
* ms per train step in each precision (:func:`by_precision`): float32
  with TF32 off, with TF32 on, and ``model.compute_dtype = "bfloat16"``.

    python -m handwriting_line_generation_tpu_torch.trace_train

Needs a CUDA device.  Prints one JSON line last.
"""

from __future__ import annotations

import json
import pathlib
import time
from collections import defaultdict
from typing import Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from handwriting_line_generation_tpu_torch import flops
from handwriting_line_generation_tpu_torch.config import load_config
from handwriting_line_generation_tpu_torch.ops import ctc
from handwriting_line_generation_tpu_torch.ops.augment import (
    apply_augmentation, dequantize_image,
)
from handwriting_line_generation_tpu_torch.trace_forward import _device_us
from handwriting_line_generation_tpu_torch.training.hwr_trainer import \
    HWRTrainer

CONFIG = pathlib.Path(__file__).resolve().parents[1] / "configs/iam_hwr.json"
B, W, L = 16, 1024, 72
# (key, model.compute_dtype, TF32 on): the precisions a step is timed in
PRECISIONS = (("f32", "float32", False), ("tf32", "float32", True),
              ("bf16", "bfloat16", False))

# kernel-name substrings -> group, first match wins
GROUPS = (("ctc kernel", ("ctc_kernel",)),
          ("adam", ("multi_tensor", "adam", "foreach")),
          ("conv", ("conv", "cudnn", "xmma", "implicit", "dgrad", "wgrad",
                    "sm90_", "cutlass", "nhwc", "nchw")),
          ("pool", ("pool",)),
          ("gather/scatter", ("gather", "scatter", "index")),
          ("reduce", ("reduce",)),
          ("copy/cast", ("copy", "cat", "fill")),
          ("elementwise", ("elementwise", "vectorized")))


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def step_flop(tr: HWRTrainer, data) -> float:
    """Float operations of one step's loss forward and backward
    (:mod:`.flops`)."""
    def step():
        loss, _ = tr.loss(*data)
        loss.backward()
    return flops.count(step)[1]


def batch(seed: int = 0, device: str = "cuda", n: Optional[int] = None):
    """A fixed seeded batch ``[image, label, label_lengths, width]`` of
    ``n`` (default B) u8 lines 64 x W: labels of 24-L characters, widths in
    [W/2, W], paper 240-255 with one dark glyph per label over each
    sample's width, the rest padded with paper."""
    n = n or B
    rng = np.random.default_rng(seed)
    width = rng.integers(W // 2, W + 1, n).astype(np.int32)
    lens = rng.integers(24, L + 1, n).astype(np.int32)
    label = np.zeros((n, L), np.int32)
    image = rng.integers(240, 256, (n, 64, W, 1)).astype(np.uint8)
    for b in range(n):
        label[b, :lens[b]] = rng.integers(1, 80, lens[b])
        step = width[b] / lens[b]
        for j, c in enumerate(label[b, :lens[b]]):
            x0 = int(j * step)
            h = 8 + int(c) % 24
            image[b, 32 - h // 2:32 + h // 2, x0:x0 + max(2, int(step) // 2),
                  0] = rng.integers(0, 60)
    return [torch.from_numpy(a).to(device)
            for a in (image, label, lens, width)]


def event_ms(fn, iters: int = 10, warmup: int = 3) -> float:
    """Milliseconds per call of ``fn``, by CUDA events around ``iters``
    calls after ``warmup``."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def set_tf32(on: bool) -> None:
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def trainer(device: str = "cuda", dtype: str = "float32",
            seed: int = 0) -> HWRTrainer:
    """The config's trainer in ``dtype``, seeded weights."""
    cfg = load_config(str(CONFIG))
    cfg.model.compute_dtype = dtype
    tr = HWRTrainer(cfg, device=device)
    tr.init_state(seed=seed)
    return tr


def by_precision(make, run, timer=event_ms, **timer_kw) -> dict:
    """ms of ``run(trainer)`` (a step, a cycle) by ``timer`` in each of
    ``PRECISIONS``: ``f32`` (TF32 off), ``tf32`` (the same trainer with
    cuDNN's and cuBLAS's TF32 on) and ``bf16`` (a ``make("bfloat16")``
    trainer, TF32 off).  Leaves TF32 off."""
    out, tr = {}, None
    for key, dtype, tf32 in PRECISIONS:
        if key != "tf32":
            tr = None
            torch.cuda.empty_cache()
            tr = make(dtype)
        set_tf32(tf32)
        out[key] = timer(lambda: run(tr), **timer_kw)
    set_tf32(False)
    return out


def precision_ms(data, card: str = "") -> dict:
    """ms per train step in each precision; prints the rates."""
    steps = by_precision(lambda dt: trainer("cuda", dt),
                         lambda tr: tr.train_step(*data))
    print(f"HWR train step (iam_hwr, B={B}, 64x{W}) by precision: "
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
        trunk = event_ms(lambda: model.trunk(x.permute(0, 3, 1, 2)))
        forward = event_ms(lambda: model(x))

    def fwd_bwd():
        loss, _ = tr.loss(*data)
        loss.backward()
    loss, logp = tr.loss(*data)
    m = logp.detach().contiguous()
    times = {
        "augment": event_ms(lambda: apply_augmentation(
            tr.augmentation, dequantize_image(image, width), None, gen)),
        "trunk forward": trunk,
        "1-D stack + head forward": forward - trunk,
        "loss forward + backward": event_ms(fwd_bwd),
        "ctc kernel forward + backward": event_ms(
            lambda: ctc._launch(m, label, lens, True), 50),
        "adam step": event_ms(tr.optimizer.step),
        "train step": event_ms(lambda: tr.train_step(*data)),
    }
    return times


def main() -> None:
    set_tf32(False)
    tr = trainer()
    data = batch()
    times = layer_times(tr, data)
    for k, v in times.items():
        print(f"  {k:32s} {v:9.3f} ms")
    # busy time and wall time from one profiled window: a host clock
    # around the steps, ending in a synchronize
    n = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            tr.train_step(*data)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    kernels = defaultdict(float)
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] += _device_us(evt) / 1e3 / n
    groups = defaultdict(float)
    for name, ms in kernels.items():
        groups[_group(name)] += ms
    busy = sum(kernels.values())
    print(f"profiled train step: wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {1 - busy / wall:.3f}")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  group {g:16s} {ms:9.3f} ms  {ms / busy:6.1%} of busy")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {ms:9.3f} ms  {name[:110]}")
    step_ms = times["train step"]
    flop = step_flop(tr, data)
    print(f"operations: {flop / 1e12:.3f} TFLOP per step (flops.py, "
          f"forward + backward), {flop / step_ms / 1e9:.1f} TFLOP/s in the "
          f"{step_ms:.3f} ms step (CUDA events)")
    del tr
    steps = precision_ms(data)
    print(json.dumps({"batch": B, "width": W, "layers_ms": times,
                      "step_ms_by_precision": steps,
                      "step_tflop": flop / 1e12,
                      "profiled_wall_ms": wall,
                      "busy_ms": busy, "idle_share": 1 - busy / wall,
                      "groups_ms": dict(groups),
                      "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
