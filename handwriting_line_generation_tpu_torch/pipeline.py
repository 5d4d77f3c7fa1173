"""The synthetic three-stage pipeline: recognizer, perceptual autoencoder,
then the GAN that reads both, each through the train CLI.

    python -m handwriting_line_generation_tpu_torch.pipeline \\
        --family iam3|rimes3 [--through hwr|auto|spaced|gan] \\
        [--gan-iterations N] [-a PATH=VALUE ...] [--save-dir DIR] \\
        [--device cuda] [--check-cache [--trajectory N]] [--report]

Counterpart of ``scripts/run_iam_pipeline3.sh`` and
``scripts/run_rimes_pipeline3.sh`` (which stay JAX).  ``iam3``: the text
corpus ``DIR/syn_text.txt`` (written when absent, by
:mod:`.scripts.make_synthetic_corpus`), then ``configs/syn_hwr3.json``,
``configs/syn_auto3.json`` and ``configs/syn_gan3.json``, the GAN aligning
live.  ``rimes3``: the ``rimes`` corpus, ``syn_rimes_hwr3``,
``syn_rimes_auto3``, the ``spaced_loc`` cache (built when absent, by
:mod:`.scripts.precompute_spaced`), then ``syn_rimes_gan3``.

Each training stage runs ``python -m handwriting_line_generation_tpu_torch
.train -c CONFIG -r`` in a fresh process from the checkout's root, its
output appended to ``DIR/<name>.log``.  So a pipeline that was stopped
resumes each stage from its ``checkpoint-latest``, and a stage whose
``checkpoint-latest`` already holds its last iteration is skipped (no
process, no step).  Each stage's last iteration is made a
``checkpoint-latest`` save (``save_step_minor`` becomes its gcd with the
budget where it does not divide it), so the next stage and the next call
find it.  A stage that fails stops the pipeline with that stage's exit
code, named on stderr and in the log: there is no retry and no fallback to
the CPU.  One line a stage goes to ``DIR/pipeline.log``.

The configs' ``saved/...`` paths (run directories, the recognizer and
encoder checkpoints the GAN loads, the corpus, the cache) are moved under
``DIR`` (default ``saved`` in the checkout; the GAN reads its corpus only
from inside the checkout).  ``-a`` overrides go to every stage, after the
pipeline's own paths.  ``--gan-iterations N`` sets the GAN's
``trainer.iterations`` to ``N`` and ``trainer.swa_start`` to ``2N/3``
rounded down to a thousand (the bounded budget of the JAX RIMES script),
over any ``-a`` of the same fields.
``--check-cache`` runs :func:`cache_equals_live` on the GAN config and its
cache after the stages, with a trajectory of ``--trajectory`` lessons
(default 7, one curriculum cycle); ``--report`` prints each stage's validation
trajectory, wall time, rates and CTC launches from the run directories and
logs, and trains nothing.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import datetime
import json
import math
import os
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("hwr", "auto", "spaced", "gan")
CORPUS_LINES = 5000
# the config fields that name files under the configs' "saved/"
SAVED_FIELDS = ("trainer.save_dir", "model.pretrained_hwr",
                "trainer.encoder_weights", "data.text_data",
                "data.spaced_loc")


@dataclasses.dataclass(frozen=True)
class Family:
    charset: str
    hwr: str
    auto: str
    gan: str
    cached: bool                  # the GAN reads a spaced_loc cache


FAMILIES = {
    "iam3": Family("iam", "syn_hwr3", "syn_auto3", "syn_gan3", False),
    "rimes3": Family("rimes", "syn_rimes_hwr3", "syn_rimes_auto3",
                     "syn_rimes_gan3", True),
}


def config_path(name: str) -> str:
    return os.path.join(REPO_ROOT, "configs", name + ".json")


def _load(name: str, overrides: Sequence[str]):
    from handwriting_line_generation_tpu_torch.config import (
        apply_overrides, load_config,
    )
    return apply_overrides(load_config(config_path(name)), list(overrides))


def _get(cfg, path: str):
    node = cfg
    for part in path.split("."):
        node = getattr(node, part)
    return node


def moved_paths(name: str, save_dir: str) -> List[str]:
    """Overrides that move config ``name``'s ``saved/...`` paths under
    ``save_dir``."""
    cfg = _load(name, [])
    out = []
    for field in SAVED_FIELDS:
        value = _get(cfg, field)
        if isinstance(value, str) and (value == "saved/"
                                       or value.startswith("saved/")):
            out.append(f"{field}={os.path.join(save_dir, value[6:])}")
    return out


def gan_budget(n: int) -> List[str]:
    """``--gan-iterations N``: the budget and an SWA start at ``2N/3``
    rounded down to a thousand."""
    return [f"trainer.iterations={n}",
            f"trainer.swa_start={2 * n // 3 // 1000 * 1000}"]


def stage_overrides(name: str, save_dir: str, extra: Sequence[str]
                    ) -> Tuple[List[str], int]:
    """The overrides a stage trains with (the moved paths, ``extra``, and a
    ``save_step_minor`` that divides the budget), and its budget."""
    ov = moved_paths(name, save_dir) + list(extra)
    t = _load(name, ov).trainer
    minor = t.save_step_minor
    if not minor or t.iterations % minor:
        ov.append(f"trainer.save_step_minor="
                  f"{math.gcd(t.iterations, minor or t.iterations)}")
    return ov, t.iterations


def finished(run_dir: str, iterations: int) -> bool:
    """Whether ``run_dir``'s ``checkpoint-latest`` holds ``iterations``."""
    meta = os.path.join(run_dir, "checkpoint-latest.json")
    if not os.path.exists(meta):
        return False
    with open(meta) as f:
        return int(json.load(f).get("iteration", 0)) >= iterations


class Pipeline:
    """The stages of one family under ``save_dir``."""

    def __init__(self, family: str, save_dir: str = "saved",
                 overrides: Sequence[str] = (), device: str = "cuda",
                 gan_iterations: Optional[int] = None):
        self.family = family
        self.f = FAMILIES[family]
        self.save_dir = os.path.abspath(os.path.join(REPO_ROOT, save_dir))
        self.overrides = list(overrides)
        self.device = device
        self.gan_extra = gan_budget(gan_iterations) if gan_iterations else []
        gan = _load(self.f.gan, moved_paths(self.f.gan, self.save_dir))
        self.corpus = os.path.join(REPO_ROOT, gan.data.text_data)
        self.cache = gan.data.spaced_loc if self.f.cached else None

    def log(self, msg: str) -> None:
        os.makedirs(self.save_dir, exist_ok=True)
        stamp = datetime.datetime.now().isoformat(timespec="seconds")
        with open(os.path.join(self.save_dir, "pipeline.log"), "a") as f:
            f.write(f"{stamp} [{self.family}] {msg}\n")
        print(f"[{self.family}] {msg}", flush=True)

    def _run(self, what: str, argv: List[str], log_name: str) -> int:
        """``python -m argv...`` from the checkout's root, its output
        appended to ``DIR/<log_name>.log``; the exit code."""
        t0 = time.perf_counter()
        with open(os.path.join(self.save_dir, log_name + ".log"), "a") as f:
            rc = subprocess.call([sys.executable, "-m", *argv],
                                 cwd=REPO_ROOT, stdout=f,
                                 stderr=subprocess.STDOUT)
        secs = time.perf_counter() - t0
        if rc:
            self.log(f"{what} FAILED (exit {rc}) after {secs:.1f} s")
            print(f"pipeline: stage {what} failed with exit code {rc}; see "
                  f"{os.path.join(self.save_dir, log_name + '.log')}",
                  file=sys.stderr, flush=True)
        else:
            self.log(f"{what} done in {secs:.1f} s")
        return rc

    def train_stage(self, name: str, extra: Sequence[str] = ()) -> int:
        ov, iterations = stage_overrides(name, self.save_dir,
                                         self.overrides + list(extra))
        if finished(os.path.join(self.save_dir, name), iterations):
            self.log(f"stage {name}: checkpoint-latest holds iteration "
                     f"{iterations}; skipped")
            return 0
        self.log(f"stage {name}")
        argv = ["handwriting_line_generation_tpu_torch.train", "-c",
                config_path(name), "-r", "--device", self.device]
        for o in ov:
            argv += ["-a", o]
        return self._run(name, argv, name)

    def spaced_stage(self) -> int:
        if os.path.exists(self.cache):
            self.log(f"spaced_loc cache {self.cache} present; skipped")
            return 0
        self.log("precomputing spaced_loc cache")
        ov, _ = stage_overrides(self.f.gan, self.save_dir,
                                self.overrides + self.gan_extra)
        argv = ["handwriting_line_generation_tpu_torch.scripts."
                "precompute_spaced", config_path(self.f.gan), self.cache,
                "--device", self.device]
        for o in ov:
            argv += ["-a", o]
        return self._run("spaced_loc", argv, self.f.gan)

    def run(self, through: str = "gan") -> int:
        from handwriting_line_generation_tpu_torch.scripts.\
            make_synthetic_corpus import write_corpus
        os.makedirs(self.save_dir, exist_ok=True)
        self.log(f"start (through {through}, device {self.device}"
                 f"{', ' + card_name() if self.device != 'cpu' else ''})")
        if not os.path.exists(self.corpus):
            write_corpus(self.corpus, CORPUS_LINES, self.f.charset)
            self.log(f"wrote the {self.f.charset} corpus {self.corpus}")
        steps = [("hwr", lambda: self.train_stage(self.f.hwr)),
                 ("auto", lambda: self.train_stage(self.f.auto))]
        if self.f.cached:
            steps.append(("spaced", self.spaced_stage))
        steps.append(("gan", lambda: self.train_stage(self.f.gan,
                                                      self.gan_extra)))
        last = STAGES.index(through)
        for key, stage in steps:
            if STAGES.index(key) > last:
                break
            rc = stage()
            if rc:
                return rc
        self.log("done")
        return 0

    def report(self) -> Dict:
        """Each stage's validation trajectory, wall time, trained lines/s
        (each log window's, and their median), CTC launches and (the
        GAN's) sample strips' ink, from its run directory and logs."""
        out = {}
        walls = _stage_walls(os.path.join(self.save_dir, "pipeline.log"),
                             self.family)
        for name in (self.f.hwr, self.f.auto, self.f.gan):
            run = os.path.join(self.save_dir, name)
            path = os.path.join(run, "train_log.json")
            if not os.path.exists(path):
                continue
            with open(path) as f:
                log = json.load(f)
            cfg = _load(name, [])
            lines = cfg.data.batch_size * cfg.data.a_batch_size
            steps = [e for e in log if "sec_per_iter" in e]
            vals = [e for e in log if any(k.startswith("val_") for k in e)]
            rates = [lines / e["sec_per_iter"] for e in steps]
            out[name] = {
                "iterations": steps[-1]["iteration"] if steps else 0,
                "sample_ink": _sample_ink(os.path.join(run, "samples")),
                "validations": vals,
                "wall_s": walls.get(name, []),
                "lines_per_s_median": (statistics.median(rates)
                                       if rates else None),
                "lines_per_s": [[e["iteration"], r]
                                for e, r in zip(steps, rates)],
                "ctc_launches": _launches(os.path.join(self.save_dir,
                                                       name + ".log")),
            }
        return out


def card_name() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def _stage_walls(path: str, family: str) -> Dict[str, List[float]]:
    """Seconds of each process a stage ran, from ``pipeline.log``."""
    walls: Dict[str, List[float]] = {}
    if not os.path.exists(path):
        return walls
    with open(path) as f:
        for line in f:
            parts = line.split()
            if (len(parts) >= 6 and parts[1] == f"[{family}]"
                    and parts[3:5] == ["done", "in"]):
                walls.setdefault(parts[2], []).append(float(parts[5]))
    return walls


def _sample_ink(samples: str) -> Dict[str, float]:
    """The ink fraction (pixels darker than mid-grey) of each generated
    sample strip a GAN run dumped, by iteration."""
    import glob
    from handwriting_line_generation_tpu_torch.utils.png import \
        read_png_gray
    out = {}
    for path in glob.glob(os.path.join(samples, "iter*_gen.png")):
        it = os.path.basename(path)[4:-len("_gen.png")]
        out[it] = float((read_png_gray(path) < 128).mean())
    return dict(sorted(out.items(), key=lambda kv: int(kv[0])))


def _launches(path: str) -> List[int]:
    """The CTC launches each train process of a stage counted."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [int(l.split()[-1]) for l in f
                if l.startswith("kernel launches: ctc ")]


# ---------------------------------------------------------------------------
# The cache against live alignment
# ---------------------------------------------------------------------------


def _lesson_inputs(trainer, batch: Dict):
    """The image and foreground mask as ``run_lesson`` hands them to a
    step: u8 pixels and a bool mask when ``data.u8_transfer`` is on."""
    from handwriting_line_generation_tpu_torch.ops.augment import \
        quantize_image_u8
    image, fg = batch["image"], batch.get("fg_mask")
    if trainer.cfg.data.u8_transfer:
        image = quantize_image_u8(image)
        fg = None if fg is None else fg > 0.5
    return image, fg


def live_alignment(trainer, image, batch: Dict):
    """The alignment of ``image`` (as :func:`_lesson_inputs` gives it) as
    ``GanTrainer.step_count`` computes it in the step: dequantized, the
    recognizer, the frames past each line's width masked to blank,
    ``viterbi_align``."""
    import torch
    from handwriting_line_generation_tpu_torch.ops.align import viterbi_align
    from handwriting_line_generation_tpu_torch.ops.augment import \
        dequantize_image
    from handwriting_line_generation_tpu_torch.ops.ctc import \
        mask_frames_to_blank
    t = trainer._tensor
    width, label, lens = t(batch["width"]), t(batch["label"]), \
        t(batch["label_lengths"])
    image = dequantize_image(t(image), width)
    frames = trainer._frames(width, 1.0, image.shape[2])
    with torch.no_grad():
        pred = mask_frames_to_blank(trainer.model.recognize(image), frames)
        return viterbi_align(pred, label, lens)


def cache_equals_live(config: str, cache: str, overrides: Sequence[str] = (),
                      device: str = "cuda", batches: Optional[int] = None,
                      trajectory: int = 0) -> Dict:
    """The cache against live alignment on one ``GanTrainer`` state: every
    cached row of ``batches`` training batches (default: an epoch) against
    the in-step alignment (the mismatching positions counted), then a
    count and an auto lesson run from one state with the batch's
    ``spaced_label`` and without it (the viterbi of the step): their
    losses and gradient groups compared.  With ``trajectory`` N > 0, also
    N curriculum lessons of two same-seed trainers, one reading the cache
    and one aligning live (:func:`cache_trajectory`).  ``config`` is a
    config path, ``overrides`` as the train CLI's.  Deterministic
    algorithms are on throughout (cuBLAS's fixed workspace takes effect in
    a process that has not used it yet), so the two arms differ in the
    alignment's source alone.  Returns the counts and the largest
    differences."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    from handwriting_line_generation_tpu_torch.config import (
        apply_overrides, load_config,
    )
    cfg = apply_overrides(load_config(config), list(overrides)
                          + [f"data.spaced_loc={cache}"])
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        report = _cache_equals_live(cfg, device, batches)
        if trajectory:
            report["trajectory"] = cache_trajectory(cfg, device, trajectory)
        return report
    finally:
        torch.use_deterministic_algorithms(was[0])
        torch.backends.cudnn.deterministic = was[1]


def _cache_equals_live(cfg, device, batches: Optional[int]) -> Dict:
    from handwriting_line_generation_tpu_torch.data.datasets import (
        forever, make_batcher,
    )
    from handwriting_line_generation_tpu_torch.training.gan_trainer import \
        GanTrainer
    tr = GanTrainer(cfg, device=device)
    tr.init_state(cfg.trainer.seed)
    batcher = make_batcher(cfg.data, "train")
    it = forever(batcher, seed=cfg.trainer.seed)
    rows = positions = mismatched = 0
    for _ in range(batches or len(batcher)):
        b = next(it)
        live = live_alignment(tr, _lesson_inputs(tr, b)[0], b).cpu().numpy()
        cached = np.asarray(b["spaced_label"])
        if cached.shape != live.shape:
            raise AssertionError(f"cached rows {cached.shape} against live "
                                 f"{live.shape}")
        rows += live.shape[0]
        positions += live.size
        mismatched += int((cached != live).sum())
    b = next(it)
    image, fg = _lesson_inputs(tr, b)
    args = (image, b["label"], b["label_lengths"])
    a = b.get("a_batch_size", 1)
    lessons = {
        "count": (lambda sp: tr.step_count(*args, b["width"], a, sp),
                  ("countLoss",), ("grads",)),
        "auto": (lambda sp: tr.step_auto(*args, fg, b["width"], a,
                                         spaced_label=sp),
                 ("autoLoss", "perceptualLoss", "autoGenLoss",
                  "reconRecogLoss"),
                 ("main_g", "adv_g", "recog_g", "merged")),
    }
    snap = copy.deepcopy(tr.state_dict())
    report = {"rows": rows, "positions": positions,
              "mismatched_positions": mismatched, "lessons": {}}
    for name, (step, loss_keys, group_keys) in lessons.items():
        outs = []
        for spaced in (b["spaced_label"], None):
            tr.load_state_dict(copy.deepcopy(snap))
            outs.append(step(spaced))
        tr.load_state_dict(copy.deepcopy(snap))
        cached, live = outs
        loss_diff = max(abs(float(cached[k]) - float(live[k]))
                        for k in loss_keys if k in live)
        group_diff = max(float((x - y).abs().max())
                         for k in group_keys if k in live
                         for x, y in zip(cached[k], live[k]))
        report["lessons"][name] = {
            "losses": {k: [float(cached[k]), float(live[k])]
                       for k in loss_keys if k in live},
            "max_loss_diff": loss_diff, "max_group_diff": group_diff}
    return report


def cache_trajectory(cfg, device: str, n: int) -> Dict:
    """The ``scripts/spaced_equivalence.py`` stage-2 check: ``n`` lessons
    of the curriculum (``run_lesson``, as training runs them) by a trainer
    reading the cache and by a same-seed one aligning live (the config's
    ``spaced_loc`` cleared), on the same batches and draws.  Each lesson's
    losses are compared; returns them, the first lesson whose losses
    differ (None when every one is equal) and the largest difference."""
    from handwriting_line_generation_tpu_torch.data.datasets import (
        forever, make_batcher,
    )
    from handwriting_line_generation_tpu_torch.training.gan_trainer import \
        GanTrainer
    arms = []
    for cached in (True, False):
        c = copy.deepcopy(cfg)
        if not cached:
            c.data.spaced_loc = None
        tr = GanTrainer(c, device=device)
        tr.init_state(c.trainer.seed)
        it = forever(make_batcher(c.data, "train"), seed=c.trainer.seed)
        arms.append([{k: float(v) for k, v in tr.run_lesson(
            tr.curriculum.get_lesson(i), it, iteration=i).items()
            if k.endswith("Loss")} for i in range(n)])
    cached, live = arms
    diffs = [max([abs(a[k] - b[k]) for k in a.keys() & b.keys()]
                 + [0.0 if a.keys() == b.keys() else math.inf])
             for a, b in zip(cached, live)]
    first = next((i for i, (a, b) in enumerate(zip(cached, live))
                  if a != b), None)
    return {"lessons": n, "cached": cached, "live": live,
            "first_unequal": first, "max_loss_diff": max(diffs)}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m handwriting_line_generation_tpu_torch.pipeline",
        description="Run the synthetic recognizer -> autoencoder -> GAN "
                    "pipeline, each stage resumed from its checkpoint.")
    ap.add_argument("--family", required=True, choices=sorted(FAMILIES))
    ap.add_argument("--through", default="gan", choices=STAGES,
                    help="the last stage to run")
    ap.add_argument("--gan-iterations", type=int, default=None,
                    metavar="N", help="bound the GAN's budget (SWA from "
                                      "2N/3)")
    ap.add_argument("-a", "--override", action="append", default=[],
                    metavar="PATH=VALUE",
                    help="config override passed to every stage")
    ap.add_argument("--save-dir", default="saved",
                    help="where the runs, corpus, cache and logs go "
                         "(relative to the checkout; default saved)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--check-cache", action="store_true",
                    help="after the stages, hold the spaced_loc cache "
                         "against live alignment")
    ap.add_argument("--trajectory", type=int, default=7, metavar="N",
                    help="with --check-cache, also N lessons with the cache "
                         "and N aligning live, their losses held equal")
    ap.add_argument("--report", action="store_true",
                    help="print the stages' trajectories and rates only")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    a = build_parser().parse_args(argv)
    p = Pipeline(a.family, a.save_dir, a.override, a.device,
                 a.gan_iterations)
    if a.report:
        print(json.dumps(p.report(), indent=1))
        return 0
    rc = p.run(a.through)
    if rc or not a.check_cache:
        return rc
    if not p.cache:
        raise SystemExit(f"--check-cache: family {a.family} has no cache")
    ov, _ = stage_overrides(p.f.gan, p.save_dir, p.overrides + p.gan_extra)
    t0 = time.perf_counter()
    res = cache_equals_live(config_path(p.f.gan), p.cache, ov, a.device,
                            trajectory=a.trajectory)
    p.log(f"cache against live alignment: {json.dumps(res)} "
          f"({time.perf_counter() - t0:.1f} s)")
    ok = res["mismatched_positions"] == 0 and all(
        v["max_loss_diff"] == 0 and v["max_group_diff"] == 0
        for v in res["lessons"].values()) and (
        "trajectory" not in res or res["trajectory"]["first_unequal"] is None)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
