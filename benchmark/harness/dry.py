"""A cell's dry run on the CPU at the small sizes its workload file gives
under ``dry_run``: the same driver, window and check as on the card, so the
tests reach every path but the card's kernels and timings."""

from __future__ import annotations

import copy
from typing import Dict, Optional

from harness import registry


def shrunk_config(cfg_file: Dict, overrides: Dict) -> Dict:
    """``cfg_file`` with ``{"a.b.c": value}`` set inside its ``config``."""
    out = copy.deepcopy(cfg_file)
    for path, value in overrides.items():
        node = out["config"]
        *parents, leaf = path.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = value
    return out


def run(name: str, seed: int = 1, seconds: float = 0.0, trace: bool = False,
        fault: Optional[str] = None, bench: Optional[Dict] = None,
        bench_dir=registry.BENCH_DIR) -> Dict:
    """``run.run_cell`` of cell ``name`` on the CPU, shrunk."""
    import run as runner
    wl = registry.workload(name, bench_dir)
    dry = wl.get("dry_run", {})
    cfg = shrunk_config(registry.config(wl["config"], bench_dir),
                        dry.get("config", {}))
    return runner.run_cell(name, seed, seconds, trace, device="cpu",
                           bench=bench, params=dry.get("params", {}),
                           config=cfg, fault=fault, bench_dir=bench_dir)
