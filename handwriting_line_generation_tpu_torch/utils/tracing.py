"""The program's spans and counters, on the profiler's clock.

Tracing is on while a ``torch.profiler`` records (``train.py --profile``,
a benchmark's traced run) or after :func:`enable`.  Then

* ``with span(name):`` records ``Span(name, start_ns, end_ns, parent,
  request)``: ``parent`` is the name of the span open around it on the same
  thread (``None`` for a root), and ``request`` an id each root span draws
  and its children inherit, so the spans of one request share it.  While a
  profiler records, the span also opens ``record_function(name)``, so the
  range shows in the profiler's trace;
* ``count(name, n)`` adds a host integer to a counter, and ``count(name,
  tensor)`` adds the tensor's sum on its device, with no synchronize: the
  device's counters are read once, by :func:`counters`.

The clock is ``perf_counter_ns()`` moved onto the epoch once, at import:
the profiler's, nanoseconds since the epoch.  Off, a span is one flag check
and a shared no-op context, and a counter one flag check: no tensor op, no
allocation, no copy and no synchronize.
"""

from __future__ import annotations

import itertools
import threading
import time
from contextlib import nullcontext
from typing import Dict, List, NamedTuple, Optional, Union

import torch
from torch.autograd import profiler as _profiler

_OFFSET_NS = time.time_ns() - time.perf_counter_ns()
_OFF = nullcontext()


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]
    request: int


_forced = False
_records: List[Span] = []
_host_counts: Dict[str, int] = {}
_device_counts: Dict[str, torch.Tensor] = {}
_count_lock = threading.Lock()
_requests = itertools.count(1)
_local = threading.local()


def clock_ns() -> int:
    """Now, in nanoseconds since the epoch (the profiler's clock)."""
    return time.perf_counter_ns() + _OFFSET_NS


def enabled() -> bool:
    return _forced or _profiler._is_profiler_enabled


def enable() -> None:
    """Record spans and counters with no profiler running."""
    global _forced
    _forced = True


def disable() -> None:
    """Record only while a profiler records (the default)."""
    global _forced
    _forced = False


class _Open:
    __slots__ = ("name", "parent", "request", "start", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        self.parent = stack[-1] if stack else None
        self.request = (next(_requests) if self.parent is None
                        else self.parent.request)
        stack.append(self)
        # the clock brackets the profiler's range, so the range lies
        # inside the span
        self.start = clock_ns()
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        end = clock_ns()
        _local.stack.pop()
        _records.append(Span(self.name, self.start, end,
                             self.parent and self.parent.name, self.request))
        return False


def span(name: str):
    """A context that records the block as span ``name`` when tracing is
    on, and does nothing when it is off."""
    if not (_forced or _profiler._is_profiler_enabled):
        return _OFF
    return _Open(name)


def count(name: str, n: Union[int, torch.Tensor]) -> None:
    """Add ``n`` to counter ``name`` when tracing is on: a host integer, or
    a tensor's sum, kept on the tensor's device."""
    if not (_forced or _profiler._is_profiler_enabled):
        return
    if not isinstance(n, torch.Tensor):
        with _count_lock:
            _host_counts[name] = _host_counts.get(name, 0) + int(n)
        return
    # inference mode throughout: the accumulator is made and updated in it
    # whether the caller runs under autograd or under inference mode
    with torch.inference_mode(), _count_lock:
        total = n.detach().sum()
        acc = _device_counts.get(name)
        if acc is None:
            _device_counts[name] = total
        else:
            acc.add_(total.to(acc))


def records() -> List[Span]:
    """Every span recorded since the last :func:`reset`, in the order they
    closed."""
    return list(_records)


def counters() -> Dict[str, Union[int, float]]:
    """Every counter's total; a device counter is read here (one
    synchronize each)."""
    with _count_lock:
        out: Dict[str, Union[int, float]] = dict(_host_counts)
        for k, v in _device_counts.items():
            out[k] = out.get(k, 0) + v.item()
    return out


def reset() -> None:
    """Forget every span and counter."""
    with _count_lock:
        _records.clear()
        _host_counts.clear()
        _device_counts.clear()
