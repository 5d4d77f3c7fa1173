"""The synthetic pipeline of the port: the text corpus against the JAX
package's draws, the ``spaced_loc`` cache against the JAX evaluator's rows,
the coverage check, the cache held against live alignment, and the staged
pipeline on the CPU (stages in order, a second call taking no step, a failing
stage's exit code and name)."""

import json
import pathlib
import shutil
import tempfile

import numpy as np
import pytest

from handwriting_line_generation_tpu import charset as JC
from handwriting_line_generation_tpu.data.synthetic import \
    random_text as j_random_text
from handwriting_line_generation_tpu.inference.eval import \
    Evaluator as JEvaluator
from handwriting_line_generation_tpu_torch import pipeline
from handwriting_line_generation_tpu_torch.charset import IAM_CHARSET
from handwriting_line_generation_tpu_torch.config import (
    DataConfig, apply_overrides, load_config,
)
from handwriting_line_generation_tpu_torch.data import datasets as PD
from handwriting_line_generation_tpu_torch.inference.eval import Evaluator
from handwriting_line_generation_tpu_torch.scripts import (
    make_synthetic_corpus, precompute_spaced,
)
from test_torch_eval import BUCKETS, Batches, model_pair, records
from test_torch_train_cli import GAN_SHRINK
from test_torch_threads import one_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]
# two authors of four lines, two lines a batch (two groups of two for the
# GAN), two steps a stage, the GAN's widths shrunk
SMALL = ["data.synthetic_authors=2", "data.synthetic_lines=4",
         "data.batch_size=2", "trainer.iterations=2"] + GAN_SHRINK


def _pairs(overrides):
    return [a for ov in overrides for a in ("-a", ov)]


# -- the corpus ---------------------------------------------------------------

@pytest.mark.parametrize("charset", ["iam", "rimes"])
def test_corpus_is_the_jax_draws(charset, tmp_path):
    """The corpus file holds the JAX package's ``random_text`` draws from
    ``default_rng(99)``, one a line, byte for byte."""
    out = tmp_path / "corpus.txt"
    assert make_synthetic_corpus.main([str(out), "300", charset]) == 0
    cs = {"iam": JC.IAM_CHARSET, "rimes": JC.RIMES_CHARSET}[charset]
    rng = np.random.default_rng(99)
    want = "".join(j_random_text(rng, cs) + "\n" for _ in range(300))
    assert out.read_bytes() == want.encode("utf-8")


# -- the cache ----------------------------------------------------------------

def _batcher(n_authors):
    """Author pairs of ``records``, two groups a batch."""
    return PD.AuthorBatcher(records(n_authors, 2), IAM_CHARSET, 2, 2,
                            DataConfig(**BUCKETS), with_fg=False)


def test_cache_rows_match_the_jax_evaluator(tmp_path):
    """Three author groups padded to two batches by cycling from the
    front; every record's row equals the JAX ``Evaluator``'s
    ``save_spaced`` row on the same converted weights and batches."""
    jm, jp, model = model_pair()
    batcher = _batcher(3)
    rows = precompute_spaced.spaced_rows(
        Evaluator(model, IAM_CHARSET, device="cpu"), batcher)
    assert len(batcher.groups) == 4
    assert batcher.groups[3] == batcher.groups[0]
    precompute_spaced.check_coverage(rows, precompute_spaced.split_rids(
        batcher), "train")
    same = Batches(list(batcher.batches(np.random.default_rng(0),
                                        shuffle=False)))
    JEvaluator(jm, jp, JC.IAM_CHARSET).run(same, out_dir=str(tmp_path),
                                           save_spaced=True)
    want = np.load(tmp_path / "spaced.npz")
    assert sorted(rows) == sorted(want.files) == [f"r{k}" for k in range(6)]
    for k in want.files:
        np.testing.assert_array_equal(rows[k], want[k], err_msg=k)


def test_coverage_check_raises_on_a_short_cache(tmp_path):
    """Without the padding the evaluator drops the group that does not
    fill a batch, and the check names the records it left out."""
    _, _, model = model_pair()
    batcher = _batcher(3)
    Evaluator(model, IAM_CHARSET, device="cpu").run(
        batcher, out_dir=str(tmp_path), save_spaced=True)
    with np.load(tmp_path / "spaced.npz") as d:
        rows = list(d.files)
    assert len(rows) == 4
    with pytest.raises(SystemExit, match=r"2 missing \(first: \['r4', "
                                         r"'r5'\]\)"):
        precompute_spaced.check_coverage(
            rows, precompute_spaced.split_rids(batcher), "valid")


# -- the pipeline on the CPU --------------------------------------------------

@pytest.fixture(scope="module")
def rimes_run():
    """``rimes3`` through the GAN with ``--check-cache``, on the CPU; the
    GAN reads its corpus only from inside the checkout, so the run lives
    under the checkout's ``saved/``."""
    (REPO / "saved").mkdir(exist_ok=True)
    root = pathlib.Path(tempfile.mkdtemp(prefix="test_pipeline_",
                                         dir=REPO / "saved"))
    argv = ["--family", "rimes3", "--save-dir", str(root), "--device",
            "cpu", "--check-cache", "--trajectory", str(TRAJECTORY),
            *_pairs(SMALL)]
    rc = pipeline.main(argv)
    log = (root / "pipeline.log").read_text().splitlines()
    yield dict(rc=rc, root=root, argv=argv, log=log)
    shutil.rmtree(root, ignore_errors=True)


NAMES = ("syn_rimes_hwr3", "syn_rimes_auto3", "syn_rimes_gan3")
# the cache check's trajectory: the count, no-step gen and auto lessons
# (both lessons that read an alignment)
TRAJECTORY = 3


def test_pipeline_runs_the_stages_in_order(rimes_run):
    assert rimes_run["rc"] == 0
    steps = [l.split("] ", 1)[1] for l in rimes_run["log"]]
    assert [s for s in steps if s.startswith(("stage", "precomputing"))] \
        == ["stage syn_rimes_hwr3", "stage syn_rimes_auto3",
            "precomputing spaced_loc cache", "stage syn_rimes_gan3"]
    root = rimes_run["root"]
    for name in NAMES:
        meta = json.loads((root / name / "checkpoint-latest.json")
                          .read_text())
        assert meta["iteration"] == 2, name
        assert "kernel launches: ctc 0" in (root / f"{name}.log").read_text()
    assert (root / "syn_rimes_text.txt").read_text().count("\n") == 5000
    assert "does not exist" not in (root / "syn_rimes_gan3.log").read_text()
    cache = np.load(root / "syn_rimes_spaced3.npz")
    assert sorted(cache.files) == sorted(
        [f"syn-train-{i}" for i in range(8)]
        + [f"syn-valid-{i}" for i in range(8)])


def test_cache_equals_live_alignment(rimes_run):
    """Every cached row equals the in-step alignment, and a count and an
    auto lesson with and without ``spaced_label`` give bit-equal losses
    and gradient groups."""
    line = next(l for l in rimes_run["log"]
                if "cache against live alignment" in l)
    res = json.loads(line[line.index("{"):line.rindex("}") + 1])
    assert res["rows"] == 8 and res["positions"] > 0
    assert res["mismatched_positions"] == 0
    assert set(res["lessons"]) == {"count", "auto"}
    for name, v in res["lessons"].items():
        assert v["max_loss_diff"] == 0 and v["max_group_diff"] == 0, name
        assert all(a == b for a, b in v["losses"].values())
    traj = res["trajectory"]
    assert traj["lessons"] == TRAJECTORY and traj["first_unequal"] is None
    assert traj["cached"] == traj["live"] and traj["max_loss_diff"] == 0
    assert {"countLoss", "autoLoss", "genRecogLoss"} <= {
        k for lesson in traj["cached"] for k in lesson}


def test_cache_trajectory_fails_on_a_shifted_row(rimes_run, tmp_path):
    """The same check on a copy of the cache whose row of one record of the
    first training batch is shifted by a frame: the rows mismatch and the
    trajectory's count lesson, which reads that row, differs."""
    root = rimes_run["root"]
    ov, _ = pipeline.stage_overrides("syn_rimes_gan3", str(root), SMALL)
    cfg = apply_overrides(load_config(pipeline.config_path(
        "syn_rimes_gan3")), ov)
    first = next(PD.forever(PD.make_batcher(cfg.data, "train"),
                            seed=cfg.trainer.seed))["rid"][0]
    with np.load(root / "syn_rimes_spaced3.npz") as cache:
        rows = {k: cache[k] for k in cache.files}
    rows[first] = np.roll(rows[first], 1)
    shifted = tmp_path / "shifted.npz"
    np.savez_compressed(shifted, **rows)
    res = pipeline.cache_equals_live(pipeline.config_path("syn_rimes_gan3"),
                                     str(shifted), ov, "cpu", batches=1,
                                     trajectory=1)
    assert res["mismatched_positions"] > 0
    assert res["trajectory"]["first_unequal"] == 0
    assert res["trajectory"]["max_loss_diff"] > 0


def test_second_call_takes_no_step(rimes_run):
    root = rimes_run["root"]
    before = {n: (root / n / "checkpoint-latest.pt").stat().st_mtime_ns
              for n in NAMES}
    assert pipeline.main(["--family", "rimes3", "--save-dir", str(root),
                          "--device", "cpu", *_pairs(SMALL)]) == 0
    tail = (root / "pipeline.log").read_text().splitlines()[
        len(rimes_run["log"]):]
    assert sum("skipped" in l for l in tail) == 4
    assert not any(l.split("] ", 1)[1].startswith("stage ")
                   and "skipped" not in l for l in tail)
    assert before == {n: (root / n / "checkpoint-latest.pt").stat()
                      .st_mtime_ns for n in NAMES}


def test_report_reads_the_runs(rimes_run):
    rep = pipeline.Pipeline("rimes3", str(rimes_run["root"])).report()
    assert set(rep) == set(NAMES)
    for name in NAMES:
        assert len(rep[name]["wall_s"]) == 1
        assert rep[name]["ctc_launches"] == [0]


def test_failing_stage_stops_with_its_code(tmp_path, capsys):
    """A batch larger than the corpus: the recognizer's stage exits 1,
    the pipeline returns that code, names the stage, and runs no other."""
    root = pathlib.Path(tempfile.mkdtemp(prefix="test_pipeline_fail_",
                                         dir=REPO / "saved"))
    try:
        rc = pipeline.main(["--family", "iam3", "--save-dir", str(root),
                            "--device", "cpu",
                            *_pairs(SMALL + ["data.batch_size=1000"])])
        err = capsys.readouterr().err
        log = (root / "pipeline.log").read_text()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    assert rc == 1
    assert "stage syn_hwr3 failed with exit code 1" in err
    assert "syn_hwr3 FAILED (exit 1)" in log
    assert "syn_auto3" not in log and "syn_gan3" not in log


def test_gan_budget_and_the_last_save():
    """``--gan-iterations``: the budget and an SWA start at 2N/3 rounded
    down to a thousand, over an ``-a`` of the same field; a budget that
    the config's ``save_step_minor`` does not divide saves at their gcd."""
    assert pipeline.gan_budget(14000) == ["trainer.iterations=14000",
                                          "trainer.swa_start=9000"]
    ov, n = pipeline.stage_overrides(
        "syn_gan3", "/x", ["trainer.iterations=7"]
        + pipeline.gan_budget(14000))
    assert n == 14000 and ov[-1] == "trainer.save_step_minor=1000"
    assert "model.pretrained_hwr=/x/syn_hwr3/checkpoint-latest" in ov
    ov, n = pipeline.stage_overrides("syn_hwr3", "/x", [])
    assert n == 30000 and not any("save_step_minor" in o for o in ov)
