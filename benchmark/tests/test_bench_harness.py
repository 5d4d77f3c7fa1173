"""The harness: cells, configurations, drivers and metrics found by name;
additions as files alone; the result line; no card, no result; no JAX;
the check failing on planted faults."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from harness import dry, env, registry

BENCH = registry.BENCH_DIR
ROOT = registry.ROOT
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def test_everything_named_is_found():
    bench = registry.spec()
    configs = {c["name"] for c in bench["configs"]}
    for c in configs:
        assert registry.config(c)["config"]
    for w in bench["workloads"]:
        wl = registry.workload(w["name"])
        assert wl["config"] == w["config"] in configs
        assert wl["traffic"] == w["traffic"]
        assert wl["chips"] == w["chips"]
        mix = registry.traffic(wl["traffic"])
        assert set(mix["params"]) and mix["why"]
        assert hasattr(registry.driver(mix["driver"]), "setup")
        assert set(wl["limits"]) and all(
            isinstance(v, (int, float)) for v in wl["limits"].values())
    for m in bench["end_to_end"]:
        assert hasattr(registry.metric(m["name"], "end_to_end"), "read")
    for m in bench["per_layer"]:
        assert hasattr(registry.metric(m["name"]), "read")
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    # a cell's files may stand ready before BENCHMARK.json lists it
    assert {w["name"] for w in bench["workloads"]} <= set(
        registry.workload_names())


def test_every_cell_reports_setup_an_end_to_end_and_a_layer():
    bench = registry.spec()
    for w in bench["workloads"]:
        e2e = [m["name"] for m in registry.cell_metrics(bench, w["name"],
                                                        "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert registry.cell_metrics(bench, w["name"], "per_layer")


def _copy_bench(tmp_path: Path) -> Path:
    dst = tmp_path / "benchmark"
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    return dst


def test_additions_are_files_alone(tmp_path):
    """A configuration, a traffic mix, a driver, a per-layer metric and a
    cell, each a new file: the cell is listed, and its dry run reports the
    new metric, with no file that was there edited."""
    dst = _copy_bench(tmp_path)
    before = {p: p.read_bytes() for p in dst.rglob("*") if p.is_file()}
    shutil.copy(dst / "configs/paper_gen_bf16.json",
                dst / "configs/paper_gen_copy.json")
    shutil.copy(dst / "drivers/generate.py", dst / "drivers/generate2.py")
    mix = json.loads((dst / "traffic/texts_b512_t192.json").read_text())
    mix.update(driver="generate2")
    mix["params"].update(spaced_len=224)
    (dst / "traffic/texts_added.json").write_text(json.dumps(mix))
    (dst / "metrics/lines_seen.new.py").write_text(
        "def read(m):\n    return float(m.window.lines)\n")
    wl = json.loads((dst / "workloads/gen_paper_b512.json").read_text())
    wl.update(config="paper_gen_copy", traffic="texts_added")
    (dst / "workloads/gen_added.json").write_text(json.dumps(wl))
    assert "gen_added" in registry.workload_names(dst)
    bench = registry.spec()
    bench["workloads"].append({"name": "gen_added",
                               "config": "paper_gen_copy",
                               "traffic": "texts_added", "chips": 1,
                               "why": "added"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("gen_added")
    bench["per_layer"].append({"name": "lines_seen.new", "unit": "lines",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves":
                               "infer_lines_per_s",
                               "workloads": ["gen_added"]})
    r = dry.run("gen_added", seed=11, seconds=0.2, trace=True, bench=bench,
                bench_dir=dst)
    assert r["correct"] is True
    assert r["metrics"]["lines_seen.new"]["value"] > 0
    for p, data in before.items():
        assert p.read_bytes() == data


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    r = dry.run("gen_paper_b512", seed=12, seconds=0.2, trace=trace)
    assert set(r) == KEYS | ({"breakdown"} if trace else set())
    assert list(r)[-1] == "checks"
    assert r["correct"] is True
    bench = registry.spec()
    want = ({m["name"] for m in bench["per_layer"]
             if "gen_paper_b512" in m.get("workloads", [])} if trace else
            {m["name"] for m in registry.cell_metrics(bench,
                                                      "gen_paper_b512",
                                                      "end_to_end")})
    # on the CPU the device readers find nothing to read
    assert set(r["metrics"]) <= want
    if not trace:
        assert set(r["metrics"]) == want
    for k in ("platform", "kind", "count", "memory_peak_bytes"):
        assert k in r["device"]
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_no_result():
    env_ = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "gen_paper_b512", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       env=env_, cwd=str(ROOT), timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


_NO_JAX = r"""
import sys
sys.path[:0] = [{bench!r}, {root!r}]
import torch
torch.set_num_threads(2)
from harness import dry, env, registry
from harness.driver import Context, Spans
for name in registry.workload_names():
    wl = registry.workload(name)
    d = wl["dry_run"]
    cfg = dry.shrunk_config(registry.config(wl["config"]), d["config"])
    mix = registry.traffic(wl["traffic"])
    ctx = Context(seed=3, device="cpu", workload=wl, config=cfg,
                  params=dict(mix["params"], **d["params"]), spans=Spans(),
                  sync=lambda: None)
    registry.driver(mix["driver"]).setup(ctx)
    found = env.forbidden_loaded()
    assert not found, (name, found)
print("clean")
"""


def test_no_jax_after_each_setup():
    code = _NO_JAX.format(bench=str(BENCH), root=str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(BENCH), timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().endswith("clean")


def test_forbidden_names_compare_whole_top_level_names():
    mods = {"handwriting_line_generation_tpu_torch.ops": 1, "jaxtyping": 1,
            "numpy": 1}
    assert env.forbidden_loaded(mods) == []
    mods["handwriting_line_generation_tpu.models"] = 1
    mods["flax.linen"] = 1
    assert env.forbidden_loaded(mods) == ["flax",
                                          "handwriting_line_generation_tpu"]


@pytest.mark.parametrize("cell,fault", [
    ("gen_paper_b512", "answer"),
    ("extract_paper_b64", "answer"),
    ("gan_paper_b4", "unchanged"),
    ("gan_paper_b4", "half_batch"),
])
def test_check_fails_a_broken_timed_path(cell, fault):
    """The run, its look for a card skipped, with the timed path broken
    underneath: ``correct`` comes out false."""
    r = dry.run(cell, seed=13, seconds=0.2, fault=fault)
    assert r["correct"] is False, r["checks"]
