#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

``CELL`` names ``benchmark/workloads/CELL.json``, which names its
configuration (``benchmark/configs/``) and its traffic mix
(``benchmark/traffic/``), which names its driver (``benchmark/drivers/``).
The driver builds the system under test from the seed, warms every shape
up, and the harness then runs it back to back for ``S`` seconds (a closed
loop with one client), reads the card's peak memory, frees the program's
state and checks what the window produced against the plain reference
(``benchmark/reference/``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device`` and,
traced, ``breakdown``; last in it, ``checks``: each number compared with
its limit, which also close standard error.  Without a card, with fewer
cards than the cell asks for, or when JAX or the JAX package is loaded
once the window has closed, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

from harness import env  # noqa: E402

env.prepare(ROOT)

from harness import registry  # noqa: E402
from harness.driver import Context, Number, Spans  # noqa: E402
from harness.window import MetricContext, run_window  # noqa: E402


def _sync_for(device: str):
    if device.startswith("cuda"):
        import torch
        return torch.cuda.synchronize
    return lambda: None


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", bench: Optional[Dict] = None,
             params: Optional[Dict] = None, config: Optional[Dict] = None,
             fault: Optional[str] = None, t_start: Optional[float] = None,
             bench_dir: Path = BENCH, control: bool = False) -> Dict:
    """One run of cell ``name``; returns the result object (``checks``
    last).  ``params`` / ``config`` replace the workload's parameters and
    the configuration (the CPU tests' small sizes); ``fault`` plants one
    of a driver's faults; ``control`` adds the control's numbers on the
    same inputs (``control``) and the check's ``detail`` (the readings
    the limits are set from, ``calibrate.py``)."""
    import torch
    t_start = T_PROC if t_start is None else t_start
    bench = registry.spec() if bench is None else bench
    wl = registry.workload(name, bench_dir)
    cfg = config if config is not None else registry.config(
        wl["config"], bench_dir)
    mix = registry.traffic(wl["traffic"], bench_dir)
    drv = registry.driver(mix["driver"], bench_dir)
    spans = Spans()
    ctx = Context(seed=int(seed), device=device, workload=wl, config=cfg,
                  params=dict(mix["params"], **(params or {})), spans=spans,
                  sync=_sync_for(device), fault=fault)
    if device.startswith("cuda"):
        env.set_precision(cfg["precision"])
        torch.cuda.reset_peak_memory_stats()
    t_setup = time.perf_counter()
    cell = drv.setup(ctx)
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    print(f"setup: {t_setup - t_start:.3f} s to the driver, "
          f"{setup_s - (t_setup - t_start):.3f} s in it", file=sys.stderr)

    e2e = registry.cell_metrics(bench, name, "end_to_end")
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        # device activity only: recording host ops would slow the window
        acts = ([ProfilerActivity.CUDA] if device.startswith("cuda")
                else [ProfilerActivity.CPU])
        with profile(activities=acts) as prof:
            win = run_window(cell, seconds, spans, ctx.sync)
    else:
        win = run_window(cell, seconds, spans, ctx.sync)
    peak = (torch.cuda.max_memory_allocated() if device.startswith("cuda")
            else 0)
    kinds = sorted({k for k, _, _, _ in win.steps})
    print(f"window: {len(win.steps)} steps, {win.lines} lines in "
          f"{win.seconds:.3f} s; median ms " + ", ".join(
              f"{k} {sorted(win.latencies_s(k))[win.count(k) // 2] * 1e3:.2f}"
              f" (n {win.count(k)})" for k in kinds), file=sys.stderr)

    mctx = MetricContext(window=win, cell=cell, spans=spans.items,
                         setup_s=setup_s)
    metrics: Dict[str, Dict] = {}
    breakdown = None
    dev_info = {"platform": "gpu" if device.startswith("cuda") else "cpu",
                "kind": (torch.cuda.get_device_name(0)
                         if device.startswith("cuda") else "cpu"),
                "count": int(wl["chips"]), "memory_peak_bytes": int(peak)}
    if trace:
        from harness import trace as tracing
        mctx.trace = tracing.reduce(prof, win.t0_ns, win.t1_ns)
        del prof
        for m in registry.cell_metrics(bench, name, "per_layer"):
            value = registry.metric(m["name"], "metrics", bench_dir).read(
                mctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info["busy_s"] = mctx.trace.busy_s
        dev_info["window_s"] = mctx.trace.window_s
        breakdown = tracing.breakdown(mctx.trace, spans.items)
    else:
        for m in e2e:
            value = registry.metric(m["name"], "end_to_end",
                                    bench_dir).read(mctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    cell.close()
    numbers: List[Number] = cell.check()
    result = {"correct": bool(numbers) and all(n.ok for n in numbers),
              "attempted": len(win.steps), "failed": 0,
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if control:
        result["detail"] = getattr(cell, "detail", None)
        if device.startswith("cuda"):
            env.set_precision(cfg["precision"])
        result["control"] = {n.name: n.value
                             for n in cell.check(control=True)}
    result["checks"] = {n.name: {"value": n.value, "limit": n.limit}
                        for n in numbers}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        bench = registry.spec()
        entry = registry.bench_entry(bench, args.workload)
        if entry is None:
            raise KeyError(f"BENCHMARK.json has no cell {args.workload!r}")
        card = env.require_cards(int(entry["chips"]))
    except (RuntimeError, KeyError, FileNotFoundError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), bench=bench)
    found = env.forbidden_loaded()
    if found:
        print(f"benchmark: loaded modules that may not be: {found}",
              file=sys.stderr)
        return 3
    print(f"device {card}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
