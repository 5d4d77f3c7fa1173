"""Train-step and CTC-kernel times of two checkouts, alternated on one card.

    python -m handwriting_line_generation_tpu_torch.ab_train OTHER [--rounds 6]

``OTHER`` is the root of another checkout of this repo, for example the
parent commit unpacked by ``git archive``.  Each round runs one fresh
process in each checkout, this one first in even rounds and ``OTHER`` first
in odd ones, so that neither side always runs first.  A process imports
only its own checkout: it builds the ``configs/iam_hwr.json`` trainer on
``trace_train.batch()`` with TF32 off, as ``chip_smoke.py`` phase 8 does,
times ``BLOCKS`` blocks of 10 train steps by CUDA events after 3 warm-up
steps, then the CTC kernel alone (forward + backward, and forward only) at
B = 16, C = 80, (T, L) = (256, 72) on ``chip_smoke.ctc_inputs``.

Prints every run, then per side the median and range of the step blocks
and of the kernel times, and one JSON line last.  Needs a CUDA device;
each checkout builds its own kernels.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLOCKS = 3

# run with the checkout's root as the working directory, which puts that
# checkout first on sys.path
CHILD = f"""
import json, torch
import chip_smoke as cs
from handwriting_line_generation_tpu_torch import trace_train as tt
from handwriting_line_generation_tpu_torch.config import load_config
from handwriting_line_generation_tpu_torch.ops import ctc
from handwriting_line_generation_tpu_torch.training.hwr_trainer import \\
    HWRTrainer
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
tr = HWRTrainer(load_config(str(cs.HWR_CONFIG)), device="cuda")
tr.init_state(seed=0)
batch = tt.batch(seed=0, device="cuda")
steps = [tt.event_ms(lambda: tr.train_step(*batch), 10, 3 if i == 0 else 0)
         for i in range({BLOCKS})]
x, labels, lens = cs.ctc_inputs(torch, ctc, cs.CTC_BATCH, 256,
                                cs.CTC_CLASSES, 72, seed=256)
m = x.detach().contiguous()
fb = tt.event_ms(lambda: ctc._launch(m, labels, lens, True), 50)
fwd = tt.event_ms(lambda: ctc._launch(m, labels, lens, False), 50)
print(json.dumps({{"step_ms": steps, "ctc_ms": fb, "ctc_fwd_ms": fwd}}))
"""


def run_once(checkout: pathlib.Path) -> dict:
    """One fresh process in ``checkout``; its timings."""
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=checkout,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"run in {checkout} failed:\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def summary(runs: list) -> dict:
    """Median and range of the step blocks and of the kernel times."""
    out = {}
    for key, values in (("step_ms", [v for r in runs for v in r["step_ms"]]),
                        ("ctc_ms", [r["ctc_ms"] for r in runs]),
                        ("ctc_fwd_ms", [r["ctc_fwd_ms"] for r in runs])):
        out[key] = dict(median=statistics.median(values), min=min(values),
                        max=max(values), n=len(values))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=pathlib.Path)
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args()
    sides = {"this": ROOT, "other": args.other.resolve()}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    runs = {name: [] for name in sides}
    for r in range(args.rounds):
        order = ("this", "other") if r % 2 == 0 else ("other", "this")
        for name in order:
            res = run_once(sides[name])
            runs[name].append(res)
            print(f"round {r} {name}: train step blocks "
                  + ", ".join(f"{v:.3f}" for v in res["step_ms"])
                  + f" ms; ctc fwd+bwd {res['ctc_ms']:.4f} ms, fwd "
                  f"{res['ctc_fwd_ms']:.4f} ms", flush=True)
    result = {name: summary(rs) for name, rs in runs.items()}
    for name, s in result.items():
        print(f"{name} ({sides[name]}): " + "; ".join(
            f"{k} median {v['median']:.4f} [{v['min']:.4f}, {v['max']:.4f}] "
            f"over {v['n']}" for k, v in s.items()) + f" [{card}]")
    step = {n: result[n]["step_ms"]["median"] for n in result}
    print(f"train step median, this / other: "
          f"{step['this'] / step['other']:.4f}")
    print(json.dumps({"card": card, "rounds": args.rounds,
                      "summary": result, "runs": runs}))


if __name__ == "__main__":
    main()
