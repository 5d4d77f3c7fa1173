"""The program's own spans and counters, read after a traced window.

The port records them (``handwriting_line_generation_tpu_torch.utils
.tracing``) while the profiler records, so in the traced run alone, on the
profiler's clock.  The readers take them after the window, while the
program's state is alive.  A checkout whose program has no recorder gives
``None``: its line leaves the metric out.

Each idle nanosecond of the window (no kernel, copy or set on the card,
``trace.reduce``'s intervals) goes to the innermost program span open at
that moment, so nested spans never count the same idle twice; idle while
no program span is open goes to none.  Values are per request: the total
over the window's root spans of the request's kind.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, Optional

from harness.trace import _gaps


def recorder():
    """The program's recorder module, or ``None`` where it has none."""
    try:
        from handwriting_line_generation_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing


def idle_by_span(spans, gaps, t0: int, t1: int) -> Dict[str, int]:
    """Idle ns by the name of the innermost span open during it.

    ``spans``: ``(name, start_ns, end_ns, ...)``; ``gaps``: the window's
    idle intervals ``(start_ns, end_ns)``, sorted and disjoint.  A span
    inside another starts no earlier and ends no later, so the innermost
    open span is the one that started last (of two that started together,
    the one that ends first)."""
    starts = [a for a, _ in gaps]
    before = [0]                       # idle ns before each gap
    for a, b in gaps:
        before.append(before[-1] + b - a)

    def idle_to(x: int) -> int:
        i = bisect.bisect_right(starts, x) - 1
        if i < 0:
            return 0
        a, b = gaps[i]
        return before[i] + min(x, b) - a

    edges = []
    for k, s in enumerate(spans):
        a, b = max(s[1], t0), min(s[2], t1)
        if a < b:
            edges += [(a, 1, k), (b, 0, k)]
    edges.sort()
    out: Dict[str, int] = {}
    open_: Dict[int, tuple] = {}
    last = None
    for x, opening, k in edges:
        if open_ and x > last:
            inner = max(open_.values(), key=lambda s: (s[1], -s[2]))
            out[inner[0]] = out.get(inner[0], 0) + idle_to(x) - idle_to(last)
        last = x
        if opening:
            open_[k] = spans[k]
        else:
            del open_[k]
    return out


def _window(m):
    tracing = recorder()
    if tracing is None or m.trace is None:
        return None
    t0, t1 = m.trace.t0_ns, m.trace.t1_ns
    return [s for s in tracing.records() if s[2] > t0 and s[1] < t1]


def idle_ms(m, names: Iterable[str], root: str) -> Optional[float]:
    """Idle ms a request of the window under the innermost spans named
    ``names``, over the window's root spans named ``root``."""
    spans = _window(m)
    if not spans:
        return None
    n = sum(1 for s in spans if s[0] == root and s[3] is None)
    if n == 0:
        return None
    by = idle_by_span(spans, _gaps(m.trace), m.trace.t0_ns, m.trace.t1_ns)
    return sum(by.get(k, 0) for k in names) / n / 1e6


def fill(m, used: str, slots: str) -> Optional[float]:
    """``100 * used / slots`` of two program counters, in percent; the
    counters are the process's totals over its traced windows."""
    if _window(m) is None:
        return None
    got = recorder().counters()
    if not got.get(slots):
        return None
    return 100.0 * got.get(used, 0) / got[slots]
