"""Where the time of style extraction and autoencode goes on the card.

Builds the paper model — the ``model`` section of
``configs/iam_gan_paper.json``: num_class 80, ``cnn_only`` recognizer
(group norm), char style encoder (dim 64, char_dim 128, window 2, K 16,
style_dim 128), generator 256 with appended style, spacer with duplicates,
float32 — with ``fused_epilogue=True``, seeded weights and seeded non-zero
conv biases, on B = 64 u8 glyph lines of 64 x 1024 (``trace_train.batch``;
32 author pairs, ``a_batch_size`` 2; labels at the 72 bucket), and prints,
with TF32 off:

* per layer, CUDA-event medians of 10 runs after 3 warm-ups: the HWR
  forward, ``StyleTrunk``, dispatch + extractor bank, global branch +
  heads, the ``viterbi_align`` kernel (one launch, the path that runs on
  the card) and its plain version's recursion and backtrace, the
  generator;
* the two end-to-end rates, extracted lines/s (``extract_style``) and
  autoencoded lines/s (``autoencode``), the same way;
* over one profiled window of 3 autoencodes: wall time (host clock, ending
  in a synchronize), device busy time, the idle share 1 - busy / wall, and
  device time by kernel group and by kernel.

    python -m handwriting_line_generation_tpu_torch.trace_style

Needs a CUDA device.  Prints one JSON line last.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from handwriting_line_generation_tpu_torch import trace_train as tt
from handwriting_line_generation_tpu_torch.config import load_config
from handwriting_line_generation_tpu_torch.init import (
    init_model, seed_conv_biases,
)
from handwriting_line_generation_tpu_torch.models.hw_with_style import (
    HWWithStyle, collapse_author_batch,
)
from handwriting_line_generation_tpu_torch.ops.align import (
    viterbi_align, viterbi_backtrace, viterbi_moves,
)
from handwriting_line_generation_tpu_torch.ops.augment import \
    dequantize_image
from handwriting_line_generation_tpu_torch.ops.ctc import mask_frames_to_blank
from handwriting_line_generation_tpu_torch.ops.spacing import onehot
from handwriting_line_generation_tpu_torch.trace_forward import _device_us

CONFIG = (pathlib.Path(__file__).resolve().parents[1]
          / "configs/iam_gan_paper.json")
B, A = 64, 2              # lines, lines per author

# kernel-name substrings -> group, first match wins
GROUPS = (("gen_epilogue", ("epilogue_kernel",)),
          ("conv", ("conv", "cudnn", "xmma", "implicit", "sm90_", "cutlass",
                    "nhwc", "nchw")),
          ("matmul/bmm", ("gemm", "gemv", "bmm", "dot")),
          ("sort/top-K", ("sort", "radix")),
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


def paper_model(device, seed: int = 0) -> HWWithStyle:
    """The paper model on ``device``, eval mode, float32, fused epilogue,
    seeded weights and conv biases (the same on every device)."""
    cfg = load_config(str(CONFIG)).model
    cfg.generator.fused_epilogue = True
    cfg.compute_dtype = "float32"
    model = init_model(cfg, seed)
    seed_conv_biases(model.generator, seed + 1)
    return model.to(device).eval()


def inputs(device, seed: int = 0):
    """``(image [B, 64, 1024, 1] f32, labels, label_lengths, frames,
    width)``: ``trace_train.batch``'s u8 lines, dequantized (-1 past each
    line's width), and the recognizer frames ``(width + 3) // 4`` that
    cover the ink."""
    image, label, lens, width = tt.batch(seed=seed, device=device, n=B)
    frames = torch.clamp((width + 3) // 4, 1, tt.W // 4)
    return dequantize_image(image, width), label, lens, frames, width


def event_median_ms(fn, iters: int = 10, warmup: int = 3) -> float:
    """Median milliseconds of ``iters`` calls of ``fn``, each between its
    own pair of CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    marks = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in marks)


def _noise(device):
    return torch.Generator(device).manual_seed(0)


@torch.inference_mode()
def layer_times(model: HWWithStyle, image, label, lens, frames) -> dict:
    """Per-layer CUDA-event medians (ms) of one extraction + autoencode."""
    enc, dev = model.style_extractor, image.device
    pred = mask_frames_to_blank(model.recognize(image), frames)
    img_c, pred_c = collapse_author_batch(image, pred, A)
    x, recog = enc.features(img_c, pred_c)
    chars = enc.char_styles(x, recog)
    style = enc.heads(x, recog, *chars).repeat_interleave(A, dim=0)
    moves, j_final, ext = viterbi_moves(pred, label, lens)
    spaced = onehot(viterbi_backtrace(moves, j_final, ext),
                    model.cfg.num_class)
    ms = event_median_ms
    return {
        "HWR forward": ms(lambda: model.recognize(image)),
        "StyleTrunk": ms(lambda: enc.trunk(img_c.permute(0, 3, 1, 2))),
        "dispatch + extractor bank": ms(lambda: enc.char_styles(x, recog)),
        "global branch + heads": ms(lambda: enc.heads(x, recog, *chars)),
        "viterbi kernel": ms(lambda: viterbi_align(pred, label, lens)),
        "viterbi recursion": ms(lambda: viterbi_moves(pred, label, lens)),
        "viterbi backtrace": ms(lambda: viterbi_backtrace(moves, j_final,
                                                          ext)),
        "generator": ms(lambda: model.generator(spaced, style,
                                                generator=_noise(dev))),
    }


@torch.inference_mode()
def end_to_end(model: HWWithStyle, image, label, lens, frames) -> dict:
    """Medians (ms) of ``extract_style`` and ``autoencode`` on the batch,
    and their lines/s."""
    n = image.shape[0]
    ext_ms = event_median_ms(lambda: model.extract_style(
        image, A, frame_lengths=frames))
    ae_ms = event_median_ms(lambda: model.autoencode(
        image, label, lens, A, frame_lengths=frames,
        generator=_noise(image.device)))
    return {"extract_ms": ext_ms, "extracted_lines_per_s": n * 1e3 / ext_ms,
            "autoencode_ms": ae_ms,
            "autoencoded_lines_per_s": n * 1e3 / ae_ms}


@torch.inference_mode()
def profiled_window(model: HWWithStyle, image, label, lens, frames,
                    n: int = 3) -> dict:
    """Wall and device busy time per autoencode over one profiled window
    of ``n``, the idle share, and device time by group and by kernel."""
    run = lambda: model.autoencode(image, label, lens, A,
                                   frame_lengths=frames,
                                   generator=_noise(image.device))
    run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            run()
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
    return {"wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall,
            "groups_ms": dict(groups), "kernels_ms": dict(kernels)}


def report(model: HWWithStyle, data, card: str = "") -> dict:
    """Print the per-layer split, the two rates and the profiled window;
    return them."""
    layers = layer_times(model, *data[:4])
    for k, v in layers.items():
        print(f"  {k:28s} {v:9.3f} ms (B={B}, TF32 off) {card}")
    e2e = end_to_end(model, *data[:4])
    print(f"extract_style {e2e['extract_ms']:.3f} ms: "
          f"{e2e['extracted_lines_per_s']:.1f} extracted lines/s; "
          f"autoencode {e2e['autoencode_ms']:.3f} ms: "
          f"{e2e['autoencoded_lines_per_s']:.1f} autoencoded lines/s "
          f"(B={B}, 64x{tt.W}, f32, TF32 off) {card}")
    win = profiled_window(model, *data[:4])
    print(f"profiled autoencode: wall {win['wall_ms']:.3f} ms, device busy "
          f"{win['busy_ms']:.3f} ms, idle share {win['idle_share']:.3f} "
          f"{card}")
    busy = win["busy_ms"]
    for g, ms in sorted(win["groups_ms"].items(), key=lambda kv: -kv[1]):
        print(f"  group {g:16s} {ms:9.3f} ms  {ms / busy:6.1%} of busy")
    for name, ms in sorted(win["kernels_ms"].items(),
                           key=lambda kv: -kv[1])[:12]:
        print(f"  {ms:9.3f} ms  {name[:110]}")
    return {"layers_ms": layers, **e2e,
            **{k: v for k, v in win.items() if k != "kernels_ms"}}


def main() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = paper_model("cuda")
    out = report(model, inputs("cuda"))
    print(json.dumps({"batch": B, "a_batch_size": A, "width": tt.W, **out,
                      "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
