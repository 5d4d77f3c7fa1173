"""The cell ``autoencode_paper_b64``: its check fails a broken timed path
and its control (the reference in bfloat16 in the program's place, one
step below the configuration's float32) on the CPU at the dry run's
sizes and, marked ``cuda``, on the card at the cell's own; its readers
of the program's spans and counters, by hand and in a dry traced run.

    python -m pytest -p no:cacheprovider benchmark/tests/test_bench_recon.py
"""

import math
from types import SimpleNamespace

import pytest

from harness import dry, program_spans, registry
from harness.trace import Trace
from harness.window import MetricContext, Window

CELL = "autoencode_paper_b64"
READERS = ("align_idle_ms.recon", "regen_idle_ms.recon",
           "lattice_fill.recon")
SEEDS = (101, 102, 103)


def _control_run(seed: int):
    """The dry run with the control's numbers on the same requests."""
    import run as runner
    wl = registry.workload(CELL)
    d = wl["dry_run"]
    cfg = dry.shrunk_config(registry.config(wl["config"]), d["config"])
    return runner.run_cell(CELL, seed, 0.0, False, device="cpu",
                           params=d["params"], config=cfg, control=True)


def test_control_is_not_correct_on_the_cpu():
    limits = registry.workload(CELL)["limits"]
    r = _control_run(2 ** 31 + 7)
    assert r["correct"] is True, r["checks"]
    assert set(r["control"]) == set(limits)
    assert any(v > limits[k] for k, v in r["control"].items()), r["control"]


@pytest.mark.cuda
def test_control_is_not_correct_on_the_card(cuda):
    import calibrate
    limits = registry.workload(CELL)["limits"]
    for seed in SEEDS:
        got, _, _ = calibrate.readings(CELL, seed, 1.0, control=True)
        readings = {what: numbers for what, numbers, _ in got}
        assert all(v <= limits[k]
                   for k, v in readings["program"].items()), readings
        assert any(v > limits[k]
                   for k, v in readings["control"].items()), readings


def test_check_fails_one_author_altered():
    """One author's reconstructions negated in every request: ``correct``
    comes out false, by the image's number."""
    r = dry.run(CELL, seed=13, seconds=0.2, fault="answer")
    assert r["correct"] is False, r["checks"]
    assert r["checks"]["image_gap"]["value"] > 1.0


class _Recorder:
    def __init__(self, spans, counters):
        self._spans, self._counters = spans, counters

    def records(self):
        return list(self._spans)

    def counters(self):
        return dict(self._counters)


def test_readers_by_hand(monkeypatch):
    """Two requests in a window of 0..200 ns; the card busy [20, 40] and
    [120, 140].  A request: recognizer [0, 30], char style [30, 40], align
    [40, 80], generator [80, 95], under its root [0, 98]."""
    spans = []
    for r, off in ((1, 0), (2, 100)):
        spans += [("style.recognizer", off, off + 30, "recon.request", r),
                  ("style.char_style", off + 30, off + 40, "recon.request",
                   r),
                  ("recon.align", off + 40, off + 80, "recon.request", r),
                  ("recon.generator", off + 80, off + 95, "recon.request",
                   r),
                  ("recon.request", off, off + 98, None, r)]
    monkeypatch.setattr(program_spans, "recorder", lambda: _Recorder(
        spans, {"recon.lattice_used": 67, "recon.lattice_slots": 100}))
    tr = Trace(0, 200, device=[(20, 40, "k"), (120, 140, "k")])
    m = MetricContext(window=Window(0, 200), cell=SimpleNamespace(),
                      spans=[], setup_s=0.0, trace=tr)
    read = lambda name: registry.metric(name).read(m)  # noqa: E731
    assert read("align_idle_ms.recon") == pytest.approx(40 / 1e6)
    assert read("regen_idle_ms.recon") == pytest.approx(15 / 1e6)
    assert read("lattice_fill.recon") == pytest.approx(67.0)


def test_no_recorder_no_value(monkeypatch):
    monkeypatch.setattr(program_spans, "recorder", lambda: None)
    m = MetricContext(window=Window(0, 1), cell=SimpleNamespace(
        event_ms=lambda kind: []), spans=[], setup_s=0.0, trace=Trace(0, 1))
    for name in READERS + ("forward_ms.recon",):
        assert registry.metric(name).read(m) is None


def test_dry_traced_run_reports_the_metrics():
    r = dry.run(CELL, seed=14, seconds=0.2, trace=True)
    assert r["correct"] is True, r["checks"]
    for name in READERS:
        v = r["metrics"][name]["value"]
        assert math.isfinite(v)
        assert (0 < v <= 100) if "fill" in name else v > 0
