"""What a traffic driver gives the harness, and what the harness gives it.

A driver is ``drivers/<name>.py`` with one function, ``setup(ctx) ->
Cell``; a traffic mix (``traffic/<mix>.json``) names its driver and gives
the driver's parameters (``ctx.params``).  ``setup`` it builds the system under test from the cell's configuration
and ``ctx.seed``, makes its inputs, warms up every shape the window will
use, counts each kind of step's float operations once, and returns a
:class:`Cell`.  The harness then calls ``cell.step(i)`` back to back for
the window (a closed loop with one client), reads the card's peak memory,
calls ``cell.close()`` to free the program's state, and ``cell.check()``
for the numbers that decide ``correct``.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class Number:
    """One number compared, with its limit: ``correct`` needs
    ``value <= limit``."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


class Spans:
    """The benchmark's own spans ``(name, start_ns, end_ns)``.  Their clock
    is the monotonic ``perf_counter_ns`` moved onto the profiler's
    (nanoseconds since the epoch) once, when the recorder is made, so a
    span lines up with the device's activity in a traced run."""

    def __init__(self):
        self.items: List[Tuple[str, int, int]] = []
        self._offset = time.time_ns() - time.perf_counter_ns()

    def clock(self) -> int:
        return time.perf_counter_ns() + self._offset

    @contextmanager
    def __call__(self, name: str):
        a = self.clock()
        yield
        self.items.append((name, a, self.clock()))


@dataclass
class Context:
    """What a driver is given."""
    seed: int
    device: str
    workload: Dict
    config: Dict
    params: Dict
    spans: Spans
    # the device's synchronize, a no-op on the CPU (the tests' dry runs)
    sync: object = None
    # None, or the name of a planted fault (the tests of the check)
    fault: Optional[str] = None

    def limit(self, name: str) -> float:
        return float(self.workload["limits"][name])


@dataclass
class Cell:
    """A driver's system under test, warm."""
    # kind of step -> float operations of one such step
    flops: Dict[str, float] = field(default_factory=dict)
    # kernel name -> kind of step -> least seconds of its launches a step
    bounds: Dict[str, Dict[str, float]] = field(default_factory=dict)
    # the datasheet peak (FLOP/s) of the configuration's precision
    peak_flops: float = 0.0

    def step(self, i: int) -> Tuple[str, int]:
        """One request or lesson, complete on return: ``(kind, lines)``."""
        raise NotImplementedError

    def close(self) -> None:
        """Free the program's state (the window is over)."""

    def check(self) -> List[Number]:
        """The numbers that decide ``correct``, each with its limit."""
        raise NotImplementedError

    def event_ms(self, kind: str) -> List[float]:
        """Milliseconds of the card's work of each step of ``kind`` in the
        window, by CUDA events (none where the driver records none)."""
        return []
