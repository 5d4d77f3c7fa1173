"""Where the time of one generation forward goes on the card.

Runs the bench configuration (paper width, bf16, fused epilogue, 512
lines) and prints, per forward: the unprofiled time (CUDA events), then
over one profiled window of 3 forwards the wall time (host clock, ending in
a synchronize), the device busy time summed over kernels, the idle share
1 - busy / wall, and device time by group and by kernel.  Busy and wall
come from the same window, so the profiler's own host work counts as idle.

    python -m handwriting_line_generation_tpu_torch.trace_forward [batch]

Needs a CUDA device.  Prints one JSON line last.
"""

from __future__ import annotations

import json
import sys
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from handwriting_line_generation_tpu_torch import bench

# kernel-name substrings -> group, first match wins
GROUPS = (("gen_epilogue", ("epilogue_kernel",)),
          ("conv", ("conv", "cudnn", "xmma", "implicit", "dgrad", "wgrad",
                    "sm90_", "cutlass", "nhwc")),
          ("matmul/einsum", ("gemm", "gemv", "bmm", "dot")),
          ("reduce", ("reduce",)),
          ("copy/cast", ("copy", "cat", "fill")),
          ("elementwise", ("elementwise", "vectorized")))


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    batch = int(argv[0]) if argv else 512
    n = 3
    session, labels, lens, styles = bench.build(batch)
    event_ms = bench.time_forward(session, labels, lens, styles, iters=n)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            session.forward(labels, lens, styles,
                            spaced_len=bench.SPACED_LEN, seed=i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = defaultdict(float)
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] += _device_us(evt) / 1e3 / n
    groups = defaultdict(float)
    for name, ms in kernels.items():
        groups[_group(name)] += ms
    busy = sum(kernels.values())
    print(f"forward of {batch} lines: {event_ms:.3f} ms unprofiled (CUDA "
          f"events); profiled window: wall {wall_ms:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {1 - busy / wall_ms:.3f}")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  group {g:14s} {ms:9.3f} ms  {ms / busy:6.1%} of busy")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:20]:
        print(f"  {ms:9.3f} ms  {name[:110]}")
    print(json.dumps({"batch": batch, "event_ms": event_ms,
                      "profiled_wall_ms": wall_ms, "busy_ms": busy,
                      "idle_share": 1 - busy / wall_ms,
                      "groups_ms": dict(groups),
                      "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
