"""The traced run's reduction of ``torch.profiler``'s events.

The profiler records host ops and device activity (kernels, copies,
sets) with one clock, nanoseconds since the epoch.  :func:`reduce` keeps,
inside the traced window:

* ``device``: every device interval ``(start_ns, end_ns, name)``;
* ``busy_s``: the length of their union (one card);
* ``by_name``: device seconds by kernel name;
* ``host``: host intervals the profiler saw (the CUDA runtime calls), for
  naming the device's idle gaps.

The traced run records device activity only (no host op recording, whose
overhead would slow a host-bound window): a gap is named by the
benchmark's span that ran at its middle and the innermost CUDA runtime
call under way then, or ``host`` when the host was in none.

:func:`breakdown` gives the ten device ops that took most time and the
ten longest idle gaps, each named by the benchmark's span and the
innermost host op that ran at its middle.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass
class Trace:
    t0_ns: int
    t1_ns: int
    device: List[Tuple[int, int, str]] = field(default_factory=list)
    host: List[Tuple[int, int, str]] = field(default_factory=list)
    busy_s: float = 0.0
    by_name: Dict[str, float] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def kernel_seconds(self, substring: str) -> Tuple[float, int]:
        """Device seconds and launches of kernels whose name holds
        ``substring``."""
        s, n = 0.0, 0
        for a, b, name in self.device:
            if substring in name:
                s += (b - a) / 1e9
                n += 1
        return s, n


def _union_s(intervals: List[Tuple[int, int, str]]) -> float:
    total, end = 0, None
    start = None
    for a, b, _ in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                total += end - start
            start, end = a, b
        else:
            end = max(end, b)
    if end is not None:
        total += end - start
    return total / 1e9


# device activity that occupies the card; a ``gpu_user_annotation`` range
# is a host span mirrored on the device's timeline, not work
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset", "concurrent_kernel")


def _is_work(e) -> bool:
    """A device event that is work, not an annotation: by its activity
    type where this torch reports one, else by its annotation flag (a
    host range's name, ``record_function``'s, holds no ``(`` and often a
    ``#``)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return any(str(kind()).startswith(w) for w in DEVICE_WORK)
    flag = getattr(e, "is_user_annotation", None)
    if flag is not None and flag():
        return False
    return "#" not in e.name()


def reduce(prof, t0_ns: int, t1_ns: int) -> Trace:
    """The window ``[t0_ns, t1_ns]`` of profile ``prof``."""
    tr = Trace(t0_ns, t1_ns)
    by_name: Dict[str, float] = defaultdict(float)
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        b = a + e.duration_ns()
        if b <= t0_ns or a >= t1_ns:
            continue
        a, b = max(a, t0_ns), min(b, t1_ns)
        if str(e.device_type()).endswith("CUDA"):
            if _is_work(e):
                name = e.name()
                tr.device.append((a, b, name))
                by_name[name] += (b - a) / 1e9
        else:
            tr.host.append((a, b, e.name()))
    tr.busy_s = _union_s(tr.device)
    tr.by_name = dict(by_name)
    return tr


def _gaps(tr: Trace) -> List[Tuple[int, int]]:
    out, end = [], tr.t0_ns
    for a, b, _ in sorted(tr.device):
        if a > end:
            out.append((end, a))
        end = max(end, b)
    if tr.t1_ns > end:
        out.append((end, tr.t1_ns))
    return out


def breakdown(tr: Trace, spans: List[Tuple[str, int, int]],
              top: int = 10) -> Dict[str, List]:
    """``{"device_ops": [[name, s]], "idle_gaps": [[name, s]]}``; a
    device op's name is cut to 160 characters.
    ``spans``: the benchmark's own ``(name, start_ns, end_ns)``."""
    ops = sorted(tr.by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(_gaps(tr), key=lambda g: g[0] - g[1])[:top]
    host = sorted(tr.host)
    starts = [h[0] for h in host]
    named = []
    for a, b in gaps:
        mid = (a + b) // 2
        span = next((n for n, s, e in spans if s <= mid <= e), "between")
        # the innermost host op running at the gap's middle
        best = None
        i = bisect.bisect_right(starts, mid)
        for h in reversed(host[max(0, i - 2000):i]):
            if h[1] >= mid and (best is None or h[1] - h[0]
                                < best[1] - best[0]):
                best = h
        op = best[2] if best else "host"
        named.append([f"{span}: {op}", (b - a) / 1e9])
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": named}
