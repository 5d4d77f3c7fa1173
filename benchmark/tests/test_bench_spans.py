"""The readers of the program's spans and counters: idle assigned to the
innermost program span on a synthetic trace, each reader's value by hand,
and the seven metrics in a dry traced run of both cells."""

import math
from types import SimpleNamespace

import pytest

from harness import dry, program_spans, registry
from harness.trace import Trace
from harness.window import MetricContext, Window

GEN = ("prepare_idle_ms.gen", "spacing_idle_ms.gen", "trunk_idle_ms.gen",
       "spaced_fill.gen")
EXTRACT = ("recognizer_idle_ms.extract", "char_style_idle_ms.extract",
           "frame_fill.extract")


def _span(name, a, b, parent, request):
    return (name, a, b, parent, request)


class _Recorder:
    def __init__(self, spans, counters):
        self._spans, self._counters = spans, counters

    def records(self):
        return list(self._spans)

    def counters(self):
        return dict(self._counters)


def _ctx(monkeypatch, device, spans, counters=None, t0=0, t1=100):
    monkeypatch.setattr(program_spans, "recorder",
                        lambda: _Recorder(spans, counters or {}))
    tr = Trace(t0, t1, device=[(a, b, "k") for a, b in device])
    return MetricContext(window=Window(t0, t1), cell=SimpleNamespace(),
                         spans=[], setup_s=0.0, trace=tr)


def _read(name, m):
    return registry.metric(name).read(m)


def test_idle_goes_to_the_innermost_span_only():
    """Spans A [0, 50] holding B [10, 30] holding C [20, 25], D [60, 80]
    alone; the card busy [5, 15] and [22, 65] of a window 0..100: each
    idle nanosecond to one span, the innermost."""
    spans = [_span("C", 20, 25, "B", 1), _span("B", 10, 30, "A", 1),
             _span("A", 0, 50, None, 1), _span("D", 60, 80, None, 2)]
    gaps = [(0, 5), (15, 22), (65, 100)]
    got = program_spans.idle_by_span(spans, gaps, 0, 100)
    # A: [0, 5] (5); B: [15, 20] (5) and nothing after C; C: [20, 22] (2);
    # D: [65, 80] (15); [80, 100] in no span
    assert got == {"A": 5, "B": 5, "C": 2, "D": 15}
    assert sum(got.values()) == 27 < sum(b - a for a, b in gaps)


def test_equal_starts_go_to_the_inner_span():
    spans = [_span("child", 10, 20, "root", 1),
             _span("root", 10, 40, None, 1)]
    got = program_spans.idle_by_span(spans, [(0, 100)], 0, 100)
    assert got == {"child": 10, "root": 20}


def test_generation_readers_by_hand(monkeypatch):
    """Two requests in a window of 0..200 ns; the card busy [30, 60] and
    [130, 170].  Request 1: prepare [0, 20], spacer [20, 30], insert
    [30, 40], generator [40, 90]; request 2 the same 100 ns later."""
    spans = []
    for r, off in ((1, 0), (2, 100)):
        spans += [_span("gen.prepare", off, off + 20, "gen.request", r),
                  _span("gen.spacer", off + 20, off + 30, "gen.request", r),
                  _span("gen.insert_spaces", off + 30, off + 40,
                        "gen.request", r),
                  _span("gen.generator", off + 40, off + 90, "gen.request",
                        r),
                  _span("gen.request", off, off + 95, None, r)]
    m = _ctx(monkeypatch, [(30, 60), (130, 170)], spans,
             {"gen.spaced_used": 300, "gen.spaced_slots": 400}, 0, 200)
    # prepare: 20 + 20 ns; spacing: 10 + 10 (insert's busy both times);
    # generator: [60, 90] 30 + [170, 190] 20
    assert _read("prepare_idle_ms.gen", m) == pytest.approx(20 / 1e6)
    assert _read("spacing_idle_ms.gen", m) == pytest.approx(10 / 1e6)
    assert _read("trunk_idle_ms.gen", m) == pytest.approx(25 / 1e6)
    assert _read("spaced_fill.gen", m) == pytest.approx(75.0)


def test_extraction_readers_by_hand(monkeypatch):
    """One request: root [0, 100] holding recognizer [10, 50], char style
    [50, 80] and char style [85, 90]; the card busy [20, 60]."""
    spans = [_span("style.recognizer", 10, 50, "style.extract", 1),
             _span("style.char_style", 50, 80, "style.extract", 1),
             _span("style.char_style", 85, 90, "style.extract", 1),
             _span("style.extract", 0, 100, None, 1)]
    m = _ctx(monkeypatch, [(20, 60)], spans,
             {"style.frames_used": 96, "style.frames_slots": 128})
    assert _read("recognizer_idle_ms.extract", m) == pytest.approx(10 / 1e6)
    assert _read("char_style_idle_ms.extract", m) == pytest.approx(25 / 1e6)
    assert _read("frame_fill.extract", m) == pytest.approx(75.0)


def test_no_recorder_no_value(monkeypatch):
    """A program without the recorder (or an untraced run): every reader
    gives ``None`` and raises nothing."""
    monkeypatch.setattr(program_spans, "recorder", lambda: None)
    m = MetricContext(window=Window(0, 1), cell=SimpleNamespace(), spans=[],
                      setup_s=0.0, trace=Trace(0, 1))
    for name in GEN + EXTRACT:
        assert _read(name, m) is None


@pytest.mark.parametrize("cell,names", [("gen_paper_b512", GEN),
                                        ("extract_paper_b64", EXTRACT)])
def test_dry_traced_run_reports_the_metrics(cell, names):
    r = dry.run(cell, seed=14, seconds=0.2, trace=True)
    assert r["correct"] is True
    for name in names:
        v = r["metrics"][name]["value"]
        assert math.isfinite(v)
        if "fill" in name:
            assert 0 < v <= 100
        else:
            assert v >= 0
    # on the CPU no device activity is recorded: every span's time is idle
    idle = sum(r["metrics"][n]["value"] for n in names if "idle" in n)
    assert idle > 0
