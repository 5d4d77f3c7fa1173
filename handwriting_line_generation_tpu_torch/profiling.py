"""What the port's measurement tools share: one timer, one profiled window,
one kernel-group table, and the seeded glyph lines they run on.

* :func:`event_ms`: milliseconds per call, by CUDA events;
* :func:`profiled_window`: wall and device busy time per call under
  ``torch.profiler``, the idle share, and device time by group and by
  kernel.  Busy time is the union of the kernel, copy and set intervals,
  as the benchmark's ``idle_share.infer`` counts it: a
  ``gpu_user_annotation`` range (a span's ``record_function`` mirrored on
  the device's timeline) is not work, and overlapping kernels count once;
* :data:`GROUPS` and :func:`kernel_group`: kernel name -> group;
* :func:`glyph_batch`, :func:`set_tf32` and :func:`by_precision`.

The benchmark (``benchmark/run.py --workload CELL --trace 0|1``) is the
yardstick of the served paths; these helpers serve the training profilers
(``trace_train``, ``trace_auto``, ``trace_gan``), ``trace_gen``,
``scripts/mfu_report`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, Iterable, Tuple

import numpy as np
import torch

from handwriting_line_generation_tpu_torch.utils import tracing

W, L = 1024, 72           # glyph lines: width in pixels, longest label
# (key, model.compute_dtype, TF32 on): the precisions a step is timed in
PRECISIONS = (("f32", "float32", False), ("tf32", "float32", True),
              ("bf16", "bfloat16", False))

# kernel-name substrings -> group, first match wins; pooling comes before
# conv so that an NHWC pooling kernel is not filed as a convolution, and
# no key is "cat", which "replication_pad" holds (torch.cat's kernel is a
# "CatArrayBatchedCopy")
GROUPS = (("gen_epilogue", ("epilogue_kernel",)),
          ("ctc kernel", ("ctc_kernel",)),
          ("adam", ("multi_tensor", "adam", "foreach")),
          ("pool", ("pool",)),
          ("conv", ("conv", "cudnn", "xmma", "implicit", "dgrad", "wgrad",
                    "sm90_", "cutlass", "nhwc", "nchw")),
          ("matmul/bmm", ("gemm", "gemv", "bmm", "dot")),
          ("sort/top-K", ("sort", "radix")),
          ("gather/scatter", ("gather", "scatter", "index")),
          ("reduce", ("reduce",)),
          ("copy/cast", ("copy", "memcpy", "memset", "fill")),
          ("elementwise", ("elementwise", "vectorized")))

# device activity that occupies the card (the profiler's activity types)
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset", "concurrent_kernel")


def kernel_group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def event_ms(fn: Callable[[], object], iters: int = 10,
             warmup: int = 3) -> float:
    """Milliseconds per call of ``fn`` over ``iters`` calls after
    ``warmup``: CUDA events around the calls once the process uses CUDA,
    else the host clock around them (a CPU op returns done)."""
    for _ in range(warmup):
        fn()
    if not torch.cuda.is_initialized():
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def window(events: Iterable[Tuple[str, int, int, str]], t0_ns: int,
           t1_ns: int, n: int = 1) -> Dict:
    """The window ``[t0_ns, t1_ns]`` of ``n`` calls from its device events
    ``(kind, start_ns, end_ns, name)``, ``kind`` the profiler's activity
    type: per call, ``wall_ms``, ``busy_ms`` (the union of the work
    intervals, clipped to the window), ``idle_share`` = 1 - busy / wall,
    and ``groups_ms`` / ``kernels_ms``, device time by group and by name."""
    work = [(max(a, t0_ns), min(b, t1_ns), name)
            for kind, a, b, name in events
            if kind.startswith(DEVICE_WORK) and b > t0_ns and a < t1_ns]
    busy, end = 0, t0_ns
    for a, b, _ in sorted(work):
        busy += max(0, b - max(a, end))
        end = max(end, b)
    kernels: Dict[str, float] = defaultdict(float)
    for a, b, name in work:
        kernels[name] += (b - a) / 1e6 / n
    groups: Dict[str, float] = defaultdict(float)
    for name, ms in kernels.items():
        groups[kernel_group(name)] += ms
    wall, busy_ms = (t1_ns - t0_ns) / 1e6 / n, busy / 1e6 / n
    return {"wall_ms": wall, "busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall, "groups_ms": dict(groups),
            "kernels_ms": dict(kernels)}


def _kind(e) -> str:
    """A device event's activity type; where this torch reports none, an
    annotation by its flag (a ``record_function`` name often holds a
    ``#``)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return str(kind())
    flag = getattr(e, "is_user_annotation", None)
    annotation = (flag is not None and flag()) or "#" in e.name()
    return "gpu_user_annotation" if annotation else "kernel"


def profiled_window(fn: Callable[[], object], n: int = 3) -> Dict:
    """:func:`window` of ``n`` calls of ``fn`` under ``torch.profiler``
    (CUDA activity only), between two synchronizes on the profiler's
    clock; the profiler's own host work counts as idle.  Warm ``fn`` up
    first.  Needs a CUDA device."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = tracing.clock_ns()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        t1 = tracing.clock_ns()
    events = [(_kind(e), e.start_ns(), e.start_ns() + e.duration_ns(),
               e.name()) for e in prof.profiler.kineto_results.events()
              if str(e.device_type()).endswith("CUDA")]
    return window(events, t0, t1, n)


def print_window(what: str, win: Dict, top: int = 12, card: str = ""):
    """Print a window: wall, busy and idle share, then its groups and its
    ``top`` kernels by device time."""
    busy = win["busy_ms"]
    print(f"profiled {what}: wall {win['wall_ms']:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {win['idle_share']:.3f} {card}")
    for g, ms in sorted(win["groups_ms"].items(), key=lambda kv: -kv[1]):
        print(f"  group {g:16s} {ms:9.3f} ms  {ms / busy:6.1%} of busy")
    for name, ms in sorted(win["kernels_ms"].items(),
                           key=lambda kv: -kv[1])[:top]:
        print(f"  {ms:9.3f} ms  {name[:110]}")


def glyph_batch(n: int, seed: int = 0, device: str = "cuda"):
    """A fixed seeded batch ``[image, label, label_lengths, width]`` of
    ``n`` u8 lines 64 x W: labels of 24-L characters, widths in [W/2, W],
    paper 240-255 with one dark glyph per label over each sample's width,
    the rest padded with paper."""
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


def set_tf32(on: bool) -> None:
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def by_precision(make, run, **timer_kw) -> Dict[str, float]:
    """ms of ``run(trainer)`` (a step, a cycle) by :func:`event_ms` in each
    of ``PRECISIONS``: ``f32`` (TF32 off), ``tf32`` (the same trainer with
    cuDNN's and cuBLAS's TF32 on) and ``bf16`` (a ``make("bfloat16")``
    trainer, TF32 off).  Leaves TF32 off."""
    out, tr = {}, None
    for key, dtype, tf32 in PRECISIONS:
        if key != "tf32":
            tr = None
            torch.cuda.empty_cache()
            tr = make(dtype)
        set_tf32(tf32)
        out[key] = event_ms(lambda: run(tr), **timer_kw)
    set_tf32(False)
    return out
