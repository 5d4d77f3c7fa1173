"""The measured window: a closed loop with one client.

The client sends step ``i + 1`` as soon as step ``i`` is complete (a
driver's step returns once its output is on the card, synchronized, or on
the host), until ``seconds`` have passed since the window opened; the
step under way then finishes, and the window closes at its end.  Every
step of the window is counted, and nothing runs in it but the steps.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class Window:
    t0_ns: int
    t1_ns: int
    # (kind, lines, start_ns, end_ns) of each step, on the spans' clock
    steps: List[Tuple[str, int, int, int]] = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    @property
    def lines(self) -> int:
        return sum(s[1] for s in self.steps)

    def latencies_s(self, kind: Optional[str] = None) -> List[float]:
        return [(b - a) / 1e9 for k, _, a, b in self.steps
                if kind is None or k == kind]

    def count(self, kind: str) -> int:
        return sum(1 for s in self.steps if s[0] == kind)


@dataclass
class MetricContext:
    """What a metric reader is given: the window, the cell (its float
    operations and kernel bounds a step kind, its peak), the
    benchmark's spans, and in a traced run the profile's reduction."""
    window: Window
    cell: object
    spans: List[Tuple[str, int, int]]
    setup_s: float
    trace: object = None


def run_window(cell, seconds: float, spans, sync) -> Window:
    """Steps back to back for ``seconds``; the window ends with the last
    step's completion."""
    sync()
    clock = spans.clock
    t0 = clock()
    steps = []
    i = 0
    while True:
        a = clock()
        kind, lines = cell.step(i)
        b = clock()
        steps.append((kind, lines, a, b))
        i += 1
        if (b - t0) / 1e9 >= seconds:
            break
    return Window(t0, b, steps)


def percentile(values: List[float], q: float) -> float:
    """The ``q``-th percentile, linear between order statistics (numpy's
    default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)

