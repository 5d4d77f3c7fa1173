"""The port's training CLI with ``--distributed``, two gloo ranks on the CPU
over ``tests/fixtures/mini_iam``.

Each rank is a subprocess with torchrun's variables (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) running
``python -m handwriting_line_generation_tpu_torch.train ... --distributed
--device cpu``, one thread each.  A module fixture starts every run once,
independent runs side by side:

* ``iam_hwr`` on two ranks for 4 steps (log and validation every 2 and 4,
  ``checkpoint-latest`` and a numbered checkpoint at 4), the archive mirror
  (``INTERACTIVE_SESSION_ARCHIVE``) set and ``--profile``; rank 1 is given
  a ``--save-dir`` of its own, which must stay empty (it writes nothing);
* the same config in one process for 4 steps (with ``--debug``), then
  resumed (``-r -i 6``) on two ranks, and the two-rank run resumed in one
  process;
* a SIGINT to rank 1 alone, after its first log line: both ranks stop at
  the same step, rank 0 writes one ``checkpoint-latest`` marked
  ``interrupted`` (and the same into the archive mirror), both exit 0;
* ``--fsdp 2`` (a ``1 x 2`` grid: both ranks step on the whole batch, the
  Adam state sharded): its ``checkpoint-latest`` equals the one-process
  run's bit for bit, and resumes in one process;
* ``iam_gan_paper`` (widths shrunk, the built-in text of up to 24
  characters in lines of 144 columns, no pretrained recognizer) on two
  ranks for 7 lessons, rank 1 again with a ``--save-dir`` of its own; it
  validates at lessons 3 and 6, which are not save steps, and rank 1 holds
  no validation rows (the fixture's one validation author goes to rank
  0), so only rank 0 has the monitored ``val_gen_CER``.
"""

import json
import os
import shutil
import signal
import socket
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "mini_iam")
CLI = [sys.executable, "-m", "handwriting_line_generation_tpu_torch.train",
       "--device", "cpu"]
HWR = ["-c", os.path.join(REPO, "configs", "iam_hwr.json"),
       "-a", f"data.data_dir={FIXTURE}", "-a", "data.batch_size=4",
       "-a", "trainer.log_step=2", "-a", "trainer.val_step=0",
       "-a", "trainer.save_step_minor=2", "-a", "trainer.save_step=0"]
# the first two-rank run also validates and writes a numbered checkpoint
HWR_FULL = HWR + ["-a", "trainer.val_step=4", "-a", "trainer.save_step=4"]
GAN_SHRINK = ["model.generator.dim=64", "model.style.style_dim=32",
              "model.style.dim=16", "model.style.char_dim=16",
              "model.style.char_capacity=4", "model.discriminator.dim=16",
              "model.spacer.dim=128"]
GAN = ["-c", os.path.join(REPO, "configs", "iam_gan_paper.json"),
       "-a", f"data.data_dir={FIXTURE}", "-a", "data.text_data=",
       "-a", "model.pretrained_hwr=", "-a", "trainer.log_step=7",
       "-a", "trainer.val_step=3", "-a", "trainer.save_step_minor=7",
       "-a", "trainer.print_every=7", "-a", "model.max_gen_length=144",
       "-a", "trainer.text_data_max_len=24"] + sum(
           (["-a", o] for o in GAN_SHRINK), [])
TIMEOUT = 300


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class _Run:
    """One CLI run: ``world`` rank subprocesses (one plain process when
    ``world`` is 0), started at once."""

    def __init__(self, args, world=2, env=None, rank_args=None):
        base = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO,
                    **(env or {}))
        port = str(_free_port())
        self.procs = []
        for r in range(max(world, 1)):
            e = dict(base)
            flags = []
            if world:
                e.update(RANK=str(r), WORLD_SIZE=str(world),
                         LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                         MASTER_PORT=port)
                flags = ["--distributed"]
            self.procs.append(subprocess.Popen(
                CLI + args + flags + (rank_args or {}).get(r, []),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=e, cwd=REPO))
        self._outs = None

    def wait(self):
        """Every process's (return code, output)."""
        if self._outs is None:
            self._outs = []
            for p in self.procs:
                try:
                    out, _ = p.communicate(timeout=TIMEOUT)
                except subprocess.TimeoutExpired:
                    for q in self.procs:
                        q.kill()
                    raise
                self._outs.append((p.returncode, out))
        return self._outs


def _entries(out):
    got = []
    for line in out.splitlines():
        if line.startswith("{"):
            got.append(json.loads(line))
    return got


def _losses(out):
    """Every logged loss (keys ending in ``Loss``/``loss``), in order."""
    return [(e.get("iteration"), k, v) for e in _entries(out)
            for k, v in sorted(e.items()) if k.lower().endswith("loss")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run's directories and outputs; the ~1 GB of checkpoints
    they wrote are removed after the module's tests."""
    w = tmp_path_factory.mktemp("dist_cli")
    try:
        yield _start_runs(w)
    finally:
        shutil.rmtree(w, ignore_errors=True)


def _start_runs(w):
    d = {k: w / k for k in ("two", "one", "fsdp", "gan", "archive",
                            "other", "prof", "gan_other")}
    started = {
        "two": _Run(HWR_FULL + ["-i", "4", "--save-dir", str(d["two"]),
                           "--profile", str(d["prof"])],
                    env={"INTERACTIVE_SESSION_ARCHIVE": str(d["archive"])},
                    rank_args={1: ["--save-dir", str(d["other"])]}),
        "one": _Run(HWR + ["-i", "4", "--save-dir", str(d["one"]),
                           "--debug"], world=0),
        "fsdp": _Run(HWR + ["-i", "4", "--save-dir", str(d["fsdp"]),
                            "--fsdp", "2"]),
        "gan": _Run(GAN + ["-i", "7", "--save-dir", str(d["gan"])],
                    rank_args={1: ["--save-dir", str(d["gan_other"])]}),
    }
    # SIGINT to rank 1 once it has logged (the loop is running)
    d["sigint"], d["sigint_archive"] = w / "sigint", w / "sigint_archive"
    sig = _Run(HWR + ["-i", "1000", "--save-dir", str(d["sigint"])],
               env={"INTERACTIVE_SESSION_ARCHIVE": str(d["sigint_archive"])})
    r1 = sig.procs[1]
    head = []
    for line in r1.stdout:
        head.append(line)
        if line.startswith("{"):
            break
    r1.send_signal(signal.SIGINT)
    outs = {k: started[k].wait() for k in ("two", "one", "fsdp")}
    for k in outs:
        assert all(rc == 0 for rc, _ in outs[k]), outs[k]
    # resumes: two ranks -> one process, one process -> two ranks, the
    # sharded run -> one process
    for src, dst in (("two", "two_to_one"), ("one", "one_to_two"),
                     ("fsdp", "fsdp_to_one")):
        d[dst] = w / dst
        (d[dst] / "iam_hwr").mkdir(parents=True)
        for f in ("checkpoint-latest.pt", "checkpoint-latest.json",
                  "train_log.json"):
            shutil.copy(d[src] / "iam_hwr" / f, d[dst] / "iam_hwr" / f)
    resumed = {
        "two_to_one": _Run(HWR + ["-r", "-i", "6", "--save-dir",
                                  str(d["two_to_one"])], world=0),
        "one_to_two": _Run(HWR + ["-r", "-i", "6", "--save-dir",
                                  str(d["one_to_two"])]),
        "fsdp_to_one": _Run(HWR + ["-r", "-i", "6", "--save-dir",
                                   str(d["fsdp_to_one"])], world=0),
    }
    outs.update({k: r.wait() for k, r in resumed.items()})
    outs["gan"] = started["gan"].wait()
    outs["sigint"] = [(rc, "".join(head) + out if r == 1 else out)
                      for r, (rc, out) in enumerate(sig.wait())]
    return d, outs


def _ok(outs):
    for i, (rc, out) in enumerate(outs):
        assert rc == 0, f"process {i} failed:\n{out[-4000:]}"


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _equal(a, b, what=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _equal(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    else:
        assert a == b, what


@pytest.mark.parametrize("name", ["two", "fsdp", "gan", "one_to_two"])
def test_ranks_exit_zero_and_log_the_same_losses(runs, name):
    d, outs = runs
    _ok(outs[name])
    (_, a), (_, b) = outs[name]
    assert _losses(a) and _losses(a) == _losses(b)
    assert "rank 0 of 2: gloo on cpu" in a and "rank 1 of 2: gloo on cpu" in b


@pytest.mark.parametrize("name,other", [("two", "other"),
                                        ("gan", "gan_other")])
def test_only_rank_zero_writes(runs, name, other):
    """Rank 1, given a run directory of its own, leaves it unmade; rank 0's
    holds the checkpoints, the log and (GAN) the sample strips."""
    d, outs = runs
    _ok(outs[name])
    assert not d[other].exists()
    run = d[name] / ("iam_gan_paper" if name == "gan" else "iam_hwr")
    names = {p.name for p in run.iterdir()}
    assert {"checkpoint-latest.pt", "model_best.pt", "train_log.json"} \
        <= names
    if name == "gan":
        assert any((run / "samples").iterdir())
    else:
        assert "checkpoint-iteration4.pt" in names
        assert [e["iteration"] for e in json.loads(
            (run / "train_log.json").read_text())
            if "val_loss" not in e] == [2, 4]


def test_archive_mirror_gets_the_same_checkpoints(runs):
    d, _ = runs
    run = d["two"] / "iam_hwr"
    ckpts = sorted(p.name for p in run.glob("*.pt"))
    assert ckpts == sorted(p.name for p in d["archive"].glob("*.pt"))
    for name in ckpts:
        _equal(_load(run / name), _load(d["archive"] / name), name)
        assert json.loads((run / name.replace(".pt", ".json")).read_text()) \
            == json.loads((d["archive"] / name.replace(".pt", ".json"))
                          .read_text())


def test_profile_writes_a_trace_a_rank(runs):
    d, outs = runs
    _ok(outs["two"])
    for r in range(2):
        trace = json.loads((d["prof"] / f"trace_rank{r}.json").read_text())
        assert trace["traceEvents"]


@pytest.mark.parametrize("name,world", [("two_to_one", 1),
                                        ("one_to_two", 2),
                                        ("fsdp_to_one", 1)])
def test_checkpoint_resumes_in_another_layout(runs, name, world):
    """A ``checkpoint-latest`` written by two ranks (replicated or sharded
    Adam) or by one process resumes with ``-r`` in the other layout: the
    run goes on from step 4 to 6."""
    d, outs = runs
    _ok(outs[name])
    assert len(outs[name]) == world
    for _, out in outs[name]:
        assert [e["iteration"] for e in _entries(out)
                if "loss" in e] == [6]
    latest = json.loads((d[name] / "iam_hwr" /
                         "checkpoint-latest.json").read_text())
    assert latest["iteration"] == 6


def test_sigint_to_one_rank_stops_both_at_the_same_step(runs):
    """The ranks agree on the stop flag each step: both leave the loop
    after the same step and exit 0, and rank 0 writes ``checkpoint-latest``
    there with ``interrupted: true``, into the archive mirror too."""
    d, outs = runs
    _ok(outs["sigint"])
    run = d["sigint"] / "iam_hwr"
    meta = json.loads((run / "checkpoint-latest.json").read_text())
    assert meta["interrupted"] is True
    assert json.loads((d["sigint_archive"] / "checkpoint-latest.json")
                      .read_text()) == meta
    _equal(_load(run / "checkpoint-latest.pt"),
           _load(d["sigint_archive"] / "checkpoint-latest.pt"))
    assert 2 <= meta["iteration"] < 1000
    ends = [max([e["iteration"] for e in _entries(out) if "loss" in e])
            for _, out in outs["sigint"]]
    assert ends[0] == ends[1] <= meta["iteration"]


def test_fsdp_checkpoint_equals_one_process(runs):
    """``--fsdp 2`` on two ranks (a 1 x 2 grid: the whole batch on each)
    writes the one-process run's ``checkpoint-latest`` bit for bit: the
    sharded Adam's state gathered whole, its updates the replicated
    ones."""
    d, outs = runs
    _ok(outs["fsdp"])
    grid = "1 x 2 data x model grid on cpu (sharded Adam)"
    assert grid in outs["fsdp"][0][1]
    got = _load(d["fsdp"] / "iam_hwr" / "checkpoint-latest.pt")
    want = _load(d["one"] / "iam_hwr" / "checkpoint-latest.pt")
    _equal(got, want, "checkpoint-latest")


def test_gan_validates_between_saves_with_rows_on_one_rank(runs):
    """Validation at lessons 3 and 6, between the saves at 7: both ranks
    log the same global-mean losses, rank 0 alone (the one with validation
    rows) its CERs, and no rank waits in a collective the other skipped.
    ``model_best`` follows rank 0's ``val_gen_CER``."""
    d, outs = runs
    _ok(outs["gan"])
    vals = [[e for e in _entries(out) if "val_autoLoss" in e]
            for _, out in outs["gan"]]
    assert len(vals[0]) == len(vals[1]) == 2
    for a, b in zip(*vals):
        assert "val_gen_CER" in a and "val_gen_CER" not in b
        assert {k: v for k, v in a.items() if k.endswith("Loss")} \
            == {k: v for k, v in b.items() if k.endswith("Loss")}
    run = d["gan"] / "iam_gan_paper"
    assert json.loads((run / "model_best.json").read_text())[
        "iteration"] in (3, 6)
    assert json.loads((run / "checkpoint-latest.json").read_text())[
        "iteration"] == 7
