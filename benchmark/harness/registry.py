"""Everything of one cell, configuration, traffic mix or metric sits in
files of its own, found here by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``   a model configuration as it is run;
* ``workloads/<cell>.json``   a cell: its configuration, its traffic mix,
  the limits of its check and ``why``;
* ``traffic/<mix>.json``      a traffic mix: the driver that generates it
  and the driver's parameters (sizes, lengths, pools);
* ``drivers/<driver>.py``     a traffic driver, the general generator of
  one kind of traffic (see :mod:`harness.driver`);
* ``metrics/<metric>.py``     a per-layer metric's reader, ``read(ctx)``;
* ``end_to_end/<metric>.py``  an end-to-end metric's reader, ``read(ctx)``.

A later cell, configuration, traffic mix, driver or metric is a new file
beside these, and no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
SPEC = ROOT / "BENCHMARK.json"


def _json(path: Path) -> Dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} does not exist")
    with open(path) as f:
        return json.load(f)


def spec(path: Path = SPEC) -> Dict:
    """``BENCHMARK.json``."""
    return _json(path)


def workload_names(bench_dir: Path = BENCH_DIR) -> List[str]:
    """Every cell that has a file, by name."""
    return sorted(p.stem for p in (bench_dir / "workloads").glob("*.json"))


def workload(name: str, bench_dir: Path = BENCH_DIR) -> Dict:
    """``workloads/<name>.json``, with its name."""
    wl = _json(bench_dir / "workloads" / f"{name}.json")
    wl["name"] = name
    return wl


def config(name: str, bench_dir: Path = BENCH_DIR) -> Dict:
    """``configs/<name>.json``, with its name."""
    cfg = _json(bench_dir / "configs" / f"{name}.json")
    cfg["name"] = name
    return cfg


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> Dict:
    """``traffic/<name>.json``, with its name."""
    mix = _json(bench_dir / "traffic" / f"{name}.json")
    mix["name"] = name
    return mix


def _module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{path} does not exist")
    spec_ = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


def driver(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """``drivers/<name>.py``."""
    return _module(bench_dir / "drivers" / f"{name}.py",
                   f"bench_driver_{name}")


def metric(name: str, kind: str = "metrics",
           bench_dir: Path = BENCH_DIR) -> ModuleType:
    """``metrics/<name>.py`` (or ``end_to_end/<name>.py``); a metric's name
    may hold dots, so the module is loaded from its file."""
    return _module(bench_dir / kind / f"{name}.py",
                   f"bench_{kind}_{name.replace('.', '_')}")


def cell_metrics(bench: Dict, cell: str, section: str) -> List[Dict]:
    """The entries of ``section`` (``end_to_end`` or ``per_layer``) that
    ``cell`` reports: those that list it under ``workloads``, and those
    without the key (every cell reports them)."""
    return [m for m in bench.get(section, [])
            if "workloads" not in m or cell in m["workloads"]]


def bench_entry(bench: Dict, cell: str) -> Optional[Dict]:
    """The cell's entry of ``BENCHMARK.json``'s ``workloads``."""
    return next((w for w in bench.get("workloads", [])
                 if w["name"] == cell), None)
