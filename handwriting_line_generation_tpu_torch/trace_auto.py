"""Where the time of one autoencoder train step goes on the card.

Builds the ``configs/iam_auto_2tight.json`` trainer (``Encoder2(32)`` +
``DecoderNoSkip(32)`` + the ``EHWR`` CTC head over 80 classes, Adam lr
2e-4, float32, seeded weights) on a seeded batch of 28 u8 lines of
64 x 1024 (``trace_train.batch``: widths 512-1024, labels at the 72
bucket, so T = W/8 = 128 CTC frames), and prints:

* per layer, CUDA-event medians of 10 runs after 3 warm-ups, TF32 off: the
  encoder, decoder and ``EHWR`` forwards (no autograd), the CTC kernel
  (forward + backward) on the step's log-probs, the loss forward (autograd
  and dropout on), its backward (forward + backward less the forward), the
  Adam step, and the whole train step;
* ms per train step and autoencoder-trained lines/s (28 x 1000 / ms), the
  same medians, with TF32 off and then on;
* the float operations of one step, forward and backward, as
  :mod:`.flops` counts them, and the rate they reach in the step;
* over one profiled window of 3 steps, TF32 off: wall time (host clock,
  ending in a synchronize), device busy time, the idle share
  1 - busy / wall, and device time by kernel group and by kernel;
* ms per train step in each precision (``trace_train.by_precision``):
  float32 with TF32 off, with TF32 on, and bf16.

    python -m handwriting_line_generation_tpu_torch.trace_auto

Needs a CUDA device.  Prints one JSON line last.
"""

from __future__ import annotations

import json
import pathlib
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from handwriting_line_generation_tpu_torch import flops
from handwriting_line_generation_tpu_torch import trace_train as tt
from handwriting_line_generation_tpu_torch.config import load_config
from handwriting_line_generation_tpu_torch.ops import ctc
from handwriting_line_generation_tpu_torch.ops.augment import \
    dequantize_image
from handwriting_line_generation_tpu_torch.trace_forward import _device_us
from handwriting_line_generation_tpu_torch.trace_style import \
    event_median_ms
from handwriting_line_generation_tpu_torch.training.auto_trainer import \
    AutoTrainer

CONFIG = (pathlib.Path(__file__).resolve().parents[1]
          / "configs/iam_auto_2tight.json")
B = load_config(str(CONFIG)).data.batch_size       # 28


def trainer(device, seed: int = 0, dtype: str = "float32") -> AutoTrainer:
    cfg = load_config(str(CONFIG))
    cfg.model.compute_dtype = dtype
    tr = AutoTrainer(cfg, device=device)
    tr.init_state(seed)
    return tr


def inputs(device, seed: int = 0):
    """``[image u8, label, label_lengths, width]``, ``B`` lines."""
    return tt.batch(seed=seed, device=device, n=B)


def layer_times(tr: AutoTrainer, data) -> dict:
    """Per-layer CUDA-event medians (ms) of one train step."""
    image, label, lens, width = data
    model = tr.model
    img = dequantize_image(image, width)
    with torch.no_grad():
        bott, mid = model.encode(img)
        times = {
            "encoder forward": event_median_ms(lambda: model.encode(img)),
            "decoder forward": event_median_ms(lambda: model.decoder(bott)),
            "EHWR forward": event_median_ms(lambda: model.hwr(bott)),
        }
    _, aux = tr.loss(*data)
    lp = aux["logp"].detach().contiguous()

    def fwd_bwd():
        loss, _ = tr.loss(*data)
        loss.backward()
    fwd = event_median_ms(lambda: tr.loss(*data))
    times.update({
        "ctc kernel forward + backward": event_median_ms(
            lambda: ctc._launch(lp, label, lens, True), 50),
        "loss forward": fwd,
        "backward": event_median_ms(fwd_bwd) - fwd,
        "adam step": event_median_ms(tr.optimizer.step),
        "train step": event_median_ms(lambda: tr.train_step(*data)),
    })
    return times


def step_flop(tr: AutoTrainer, data) -> float:
    """Float operations of one step's forward and backward
    (:mod:`.flops`)."""
    def step():
        loss, _ = tr.loss(*data)
        loss.backward()
    return flops.count(step)[1]


def profiled_window(tr: AutoTrainer, data, n: int = 3) -> dict:
    """Wall and device busy time per step over one profiled window of
    ``n`` steps, the idle share, and device time by group and kernel."""
    tr.train_step(*data)
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
        groups[tt._group(name)] += ms
    busy = sum(kernels.values())
    return {"wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall,
            "groups_ms": dict(groups), "kernels_ms": dict(kernels)}


def report(tr: AutoTrainer, data, card: str = "") -> dict:
    """Print the per-layer split, the step time and rate with TF32 off and
    on, the operation count and the profiled window; return them.  Leaves
    TF32 off."""
    tt.set_tf32(False)
    layers = layer_times(tr, data)
    for k, v in layers.items():
        print(f"  {k:32s} {v:9.3f} ms (B={B}, TF32 off) {card}")
    rates = {}
    for on in (False, True):
        tt.set_tf32(on)
        ms = event_median_ms(lambda: tr.train_step(*data))
        key = "tf32" if on else "f32"
        rates[f"step_ms_{key}"] = ms
        rates[f"lines_per_s_{key}"] = B * 1e3 / ms
        print(f"autoencoder train step (iam_auto_2tight, B={B}, 64x{tt.W}, "
              f"f32, TF32 {'on' if on else 'off'}): {ms:.3f} ms, "
              f"{B * 1e3 / ms:.1f} autoencoder-trained lines/s {card}",
              flush=True)
    tt.set_tf32(False)
    win = profiled_window(tr, data)
    busy = win["busy_ms"]
    print(f"profiled train step: wall {win['wall_ms']:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {win['idle_share']:.3f} {card}")
    for g, ms in sorted(win["groups_ms"].items(), key=lambda kv: -kv[1]):
        print(f"  group {g:16s} {ms:9.3f} ms  {ms / busy:6.1%} of busy")
    for name, ms in sorted(win["kernels_ms"].items(),
                           key=lambda kv: -kv[1])[:15]:
        print(f"  {ms:9.3f} ms  {name[:110]}")
    flop = step_flop(tr, data)
    print(f"operations: {flop / 1e12:.3f} TFLOP per step (flops.py, "
          f"forward + backward), {flop / rates['step_ms_f32'] / 1e9:.1f} "
          f"TFLOP/s in the {rates['step_ms_f32']:.3f} ms step {card}")
    return {"layers_ms": layers, **rates, "step_tflop": flop / 1e12,
            **{k: v for k, v in win.items() if k != "kernels_ms"}}


def precision_ms(data, card: str = "") -> dict:
    """Median ms per train step in each precision; prints the rates."""
    steps = tt.by_precision(lambda dt: trainer("cuda", dtype=dt),
                            lambda tr: tr.train_step(*data),
                            event_median_ms)
    print(f"autoencoder train step (iam_auto_2tight, B={B}, 64x{tt.W}) by "
          "precision: " + ", ".join(f"{k} {v:.3f} ms ({B * 1e3 / v:.1f} "
                                    f"lines/s)" for k, v in steps.items())
          + f" {card}", flush=True)
    return steps


def main() -> None:
    tr = trainer("cuda")
    data = inputs("cuda")
    out = report(tr, data)
    del tr
    out["step_ms_by_precision"] = precision_ms(data)
    print(json.dumps({"batch": B, "width": tt.W, **out,
                      "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
