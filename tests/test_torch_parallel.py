"""Multi-process training of the PyTorch port on the CPU (gloo ranks).

* The pure helpers of ``parallel/mesh.py`` against the JAX package's on the
  same inputs; the FSDP axis rule against the specs of JAX's
  ``fsdp_sharding`` over the paper GAN's parameter shapes (a JAX child with
  four host devices).
* Data parallelism = one process on the concatenated batch: two ranks on a
  ``2 x 1`` grid, each stepping on its half of a seeded batch, against one
  process on the whole batch (one thread a rank), for an HWR step
  (warp augmentation drawn through ``ops.rows``), an autoencoder step
  (dropout likewise) and the four GAN lessons in turn (count, no-step gen,
  auto with balancing, disc; the bank and ``insert_spaces`` draws injected,
  split by rows, the noise through ``ops.rows``).  Every averaged gradient
  within ``GRAD_RTOL`` of its tensor's largest entry of the one-process
  gradient; after every step the ranks' parameters, Adam moments, style
  bank and spectral-norm ``u``'s bit-equal; the parameters within Adam's
  per-step bound (``_adam_step_bound``) of the one-process run's.  These
  run in float64 (``_float64``: the port's ``.float()`` casts and compute
  dtype widened, as ``test_torch_gan_trainer``'s float64 tests do): in
  float32 the first convolution's weight gradient of the autoencoder, a
  sum over every pixel with heavy cancellation, moves by up to 6.5e-5 of
  its largest entry between one batch of 4 and two of 2 (oneDNN's blocking
  follows the batch), which is rounding, not averaging.
* Sharded Adam = replicated Adam bit for bit: two ranks on a ``1 x 2``
  grid, each beside a replicated trainer in the same process (same thread,
  deterministic algorithms, so the same gradients), through one HWR step
  and one GAN auto lesson; the gathered checkpoint equals the replicated
  one, and a replicated checkpoint loaded into the sharded trainer steps on
  bit-equal.

* Ranks whose batches were bucketed to other widths and label lengths:
  padded to the common shapes, their parameters and generators stay
  bit-equal through two HWR steps.

The ranks run once, in a module fixture, and send back error figures and
digests of their states and averaged gradients (sha1 of the bits), not the
tensors.  Each flow's one-process reference runs on one rank
(``REF_OWNER``: the recognizer's and the autoencoder's on rank 0, the
GAN's on rank 1, side by side), after every collective, and its figures go
to both ranks: their averaged gradients are bit-equal (the digests), so
the figures hold for each.
"""

import contextlib
import copy
import hashlib
import json
import math
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from handwriting_line_generation_tpu_torch.config import (
    Config, DataConfig, DiscriminatorConfig, GeneratorConfig, HWRConfig,
    ModelConfig, SpacerConfig, StyleConfig, TrainerConfig, load_config,
)
from handwriting_line_generation_tpu_torch.data.datasets import (
    forever, make_batcher,
)
from handwriting_line_generation_tpu_torch.ops import rows
from handwriting_line_generation_tpu_torch.parallel import mesh as pm
from handwriting_line_generation_tpu_torch.training.auto_trainer import \
    AutoTrainer
from handwriting_line_generation_tpu_torch.training.gan_trainer import \
    GanTrainer
from handwriting_line_generation_tpu_torch.training.hwr_trainer import \
    HWRTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
GRAD_RTOL = 1e-5          # of each tensor's largest one-process entry
LESSONS = ("count", "gen", "auto", "disc")
# s for the ranks' whole run: beside five test processes compiling (-n 6)
# it has taken more than 240 s; a hung rank still fails the tests
RANK_TIMEOUT = 900


def _adam_step_bound(b1, b2, t):
    """The largest |update| / lr of Adam's t-th step (as in
    ``test_torch_gan_trainer``): ``sqrt(sum a_k² / w_k)``."""
    a = [(1 - b1) * b1 ** (t - k) / (1 - b1 ** t) for k in range(1, t + 1)]
    w = [(1 - b2) * b2 ** (t - k) / (1 - b2 ** t) for k in range(1, t + 1)]
    return float(np.sqrt(sum(x * x / y for x, y in zip(a, w))))


def _gan_cfg():
    """The root ``__graft_entry__``'s tiny GAN (two author groups of two
    lines, 64 x 192, labels at 12), balanced, no augmentation."""
    cfg = Config(name="par_gan")
    cfg.data = DataConfig(dataset="synthetic", batch_size=2, a_batch_size=2,
                          width_buckets=(192,), label_buckets=(12,),
                          augmentation=None, synthetic_authors=4,
                          synthetic_lines=4)
    cfg.model = ModelConfig(
        hwr=HWRConfig(kind="cnn_only", norm="group"),
        style=StyleConfig(style_dim=32, dim=16, char_dim=16, window=2,
                          char_capacity=4),
        generator=GeneratorConfig(dim=64),
        discriminator=DiscriminatorConfig(dim=16),
        spacer=SpacerConfig(dim=32), hwr_frozen=True)
    cfg.trainer = TrainerConfig(kind="gan", iterations=10, prev_style_size=8)
    return cfg


def _batch(dtype=np.float32):
    cfg = _gan_cfg()
    b = next(forever(make_batcher(cfg.data, "train"), seed=0))
    return dict(b, image=b["image"].astype(dtype),
                fg_mask=b["fg_mask"].astype(dtype))


@contextlib.contextmanager
def _float64():
    """The port in float64: ``.float()`` casts, the compute dtype and the
    default dtype widened."""
    saved = (torch.Tensor.float, ModelConfig.torch_compute_dtype,
             torch.get_default_dtype())
    torch.Tensor.float = lambda t: t.double()
    ModelConfig.torch_compute_dtype = lambda self: torch.float64
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.Tensor.float, ModelConfig.torch_compute_dtype = saved[:2]
        torch.set_default_dtype(saved[2])


def _gan_draws(tr, seed):
    """Bank and ``insert_spaces`` draws of the whole batch (4 lines)."""
    g = torch.Generator().manual_seed(seed)
    B, L, D = 4, 12, tr.cfg.model.packed_style_dim()
    return {"bank": (torch.randint(0, 2, (B, 2), generator=g),
                     torch.rand((B, 1), generator=g),
                     torch.randn((B, D), generator=g)),
            "normals": (torch.randn((B, L), generator=g),
                        torch.randn((B, L), generator=g))}


def _split(draws, sl):
    return {k: tuple(t[sl] for t in v) for k, v in draws.items()}


def _digest(tree) -> str:
    """sha1 of a nest of dicts, lists, tensors and numbers: equal bits,
    equal digests (what the ranks send back in place of their states)."""
    h = hashlib.sha1()

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x, key=str):
                h.update(str(k).encode())
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, torch.Tensor):
            t = x.detach().cpu().contiguous().reshape(-1)
            h.update(f"{t.dtype}{tuple(x.shape)}".encode())
            h.update(t.view(torch.uint8).numpy().tobytes())
        else:
            h.update(repr(x).encode())
    walk(tree)
    return h.hexdigest()


def _rel_err(got, want) -> float:
    """Max over tensors of max |got - want| / max |want| (0 where both
    are all zero)."""
    worst = 0.0
    for a, b in zip(got, want):
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        worst = max(worst, err / scale if scale else (err and math.inf))
    return worst


def _gan_digests(tr):
    """Digests of a GAN trainer's state after a lesson."""
    s = tr.state
    return {"params": _digest(s.params),
            "u": _digest({k: v for k, v in tr.model.state_dict().items()
                          if k.endswith(".u")}),
            "bank": _digest([s.style_bank, s.bank_count]),
            "opt": _digest([s.opt_main.state_dict(),
                            s.opt_disc.state_dict()]),
            "generator": _digest(s.generator.get_state())}


def _grads_of(kind, out):
    if kind == "gen":
        return out["recog_g"] + out["adv_g"]
    if kind == "auto":
        return out["main_g"] + out["adv_g"] + out["recog_g"]
    return out["grads"]


def _contiguous(model):
    """Weights converted from the flax layout are permuted views; the
    float64 CPU convolution wants them contiguous."""
    for t in list(model.parameters()) + list(model.buffers()):
        t.data = t.data.contiguous()


# the rank that runs each flow's one-process reference (module docstring)
REF_OWNER = {"hwr": 0, "ae": 0, "gan": 1}


def _dp_flows(mesh, sl, rank):
    """HWR step, autoencoder step and the four GAN lessons on rows ``sl``
    of the batch under ``mesh``, and (on ``REF_OWNER``'s rank) each beside
    one process on every row (in this rank, no mesh), in float64: the
    averaged gradients' and the loss's errors, the parameters' gap, and
    digests of the rank's state and averaged gradients.  The owners'
    figures are shared over the default group."""
    with _float64():
        res, figures = _dp_flows64(mesh, sl, rank)
    owned = [None] * WORLD
    dist.all_gather_object(owned, figures)
    for part in owned:
        for name, fig in part.items():
            res[name].update(fig)
    return res


STEP_FLOWS = {"hwr": (HWRTrainer, "iam_hwr.json"),
              "ae": (AutoTrainer, "iam_auto_2tight.json")}


def _step(name, mesh, rows):
    """A seeded trainer of flow ``name`` after one step on ``rows``, and
    its loss."""
    cls, config = STEP_FLOWS[name]
    tr = cls(load_config(os.path.join(REPO, "configs", config)),
             device="cpu")
    tr.use_mesh(mesh)
    tr.init_state(seed=0)
    _contiguous(tr.model)
    out = tr.train_step(*rows)
    return tr, float(out[0] if name == "hwr" else out["loss"])


def _dp_flows64(mesh, sl, rank):
    b = _batch(np.float64)
    rows_of = lambda s: (b["image"][s], b["label"][s], b["label_lengths"][s],
                         b["width"][s])
    res, figures, dps = {}, {}, {}
    for name in STEP_FLOWS:
        dp, loss = dps[name] = _step(name, mesh, rows_of(sl))
        res[name] = {
            "lr": dp.cfg.optimizer.lr,
            "digest": {"params": _digest(dp.model.state_dict()),
                       "opt": _digest(dp.optimizer.state_dict()),
                       "generator": _digest(dp.generator.get_state()),
                       "grads": _digest([p.grad for p in
                                         dp.model.parameters()])}}
    gan = _gan_dp(mesh, sl, rows_of, b["fg_mask"], res)
    # the references, after every collective of the flows
    for name, (dp, loss) in dps.items():
        if REF_OWNER[name] != rank:
            continue
        ref, want = _step(name, None, rows_of(slice(None)))
        figures[name] = {
            "grad_err": _rel_err([p.grad for p in dp.model.parameters()],
                                 [p.grad for p in ref.model.parameters()]),
            "loss_err": abs(loss - want) / abs(want),
            "param_gap": max(float((p - q).abs().max()) for p, q in
                             zip(dp.model.parameters(),
                                 ref.model.parameters()))}
    if REF_OWNER["gan"] == rank:
        figures.update(_gan_ref(gan, rows_of, b["fg_mask"]))
    return res, figures


def _gan_lesson(tr, kind, s, rows_of, fg, draws):
    img, lab, lens, width = rows_of(s)
    d = _split(draws, s)
    if kind == "count":
        return tr.step_count(img, lab, lens, width, 2)
    if kind == "gen":
        return tr.step_gen_nostep(lab, lens, tr.gen_spaced_len, d)
    if kind == "auto":
        return tr.step_auto(img, lab, lens, fg[s], width, 2)
    return tr.step_disc(img, lab, lens, width, 2, draws=d)


def _gan_trainer(mesh):
    tr = GanTrainer(_gan_cfg(), device="cpu")
    tr.use_mesh(mesh)
    tr.init_state(seed=0)
    _contiguous(tr.model)
    _contiguous(tr.encoder)
    return tr


def _gan_dp(mesh, sl, rows_of, fg, res):
    """The four GAN lessons on this rank's rows: digests into ``res``;
    returns what the reference is held against (the draws, the averaged
    gradient groups, parameters and bank after each lesson)."""
    dp = _gan_trainer(mesh)
    res["text_batch"] = dp.text.get_batch(label_len=12)["label"]
    kept = []
    for kind in LESSONS:
        draws = _gan_draws(dp, seed=LESSONS.index(kind))
        grads = _grads_of(kind, _gan_lesson(dp, kind, sl, rows_of, fg,
                                            draws))
        res[kind] = {"digest": {**_gan_digests(dp),
                                "grads": _digest(grads)}}
        kept.append(dict(draws=draws, grads=grads,
                         params=[p.detach().clone() for p in dp.state.params],
                         bank=dp.state.style_bank.clone(),
                         bank_count=dp.state.bank_count))
    return dict(kept=kept, names=dp.state.names, labels=dp.state.labels)


def _gan_ref(gan, rows_of, fg):
    """One process on every row through the same lessons and draws: each
    lesson's errors against the kept averaged ones."""
    ref, out = _gan_trainer(None), {}
    for kind, k in zip(LESSONS, gan["kept"]):
        want = _grads_of(kind, _gan_lesson(ref, kind, slice(None), rows_of,
                                           fg, k["draws"]))
        gaps = {}
        for p, q, label in zip(k["params"], ref.state.params, gan["labels"]):
            gaps[label] = max(gaps.get(label, 0.0),
                              float((p - q).abs().max()))
        out[kind] = {
            "grad_err": _rel_err(k["grads"], want), "param_gap": gaps,
            "bank_err": _rel_err([k["bank"]], [ref.state.style_bank]),
            "bank_count": (k["bank_count"], ref.state.bank_count)}
    return out


def _fsdp_flows(mesh):
    """Beside a replicated trainer in this process: a sharded one (same
    seed, same whole batch): an HWR step, its state_dict, a replicated
    checkpoint loaded and stepped on; a GAN auto lesson.  Digests of
    each pair's results."""
    b = _batch()
    args = (b["image"], b["label"], b["label_lengths"], b["width"])
    cfg = load_config(os.path.join(REPO, "configs", "iam_hwr.json"))
    pair = []
    for m in (None, mesh):
        tr = HWRTrainer(cfg, device="cpu")
        tr.use_mesh(m, fsdp=m is not None)
        tr.init_state(seed=0)
        pair.append(tr)
    res = {k: [] for k in ("hwr_grads", "hwr_params", "hwr_opt",
                           "hwr_resumed", "gan_merged", "gan_state")}
    for tr in pair:
        tr.train_step(*args)
        res["hwr_grads"].append(_digest([p.grad for p in
                                         tr.model.parameters()]))
        res["hwr_params"].append(_digest(tr.model.state_dict()))
        res["hwr_opt"].append(_digest(tr.optimizer.state_dict()))
    ref, sharded = pair
    ref.train_step(*args)                       # the replicated one ahead
    # ... and taken up sharded (a copy, as from a file: a loaded Adam
    # shares the tensors it is given)
    sharded.load_state_dict(copy.deepcopy(ref.state_dict()))
    for tr in pair:
        tr.train_step(*args)
        res["hwr_resumed"].append(_digest(tr.model.state_dict()))
    res["sharded_slots"] = sum(ax is not None
                               for ax in sharded.optimizer._axis)
    for m in (None, mesh):
        tr = GanTrainer(_gan_cfg(), device="cpu")
        tr.use_mesh(m, fsdp=m is not None)
        tr.init_state(seed=0)
        out = tr.step_auto(b["image"], b["label"], b["label_lengths"],
                           b["fg_mask"], b["width"], 2)
        res["gan_merged"].append(_digest(out["merged"]))
        res["gan_state"].append(_gan_digests(tr))
    return res


def _ragged_flow(mesh, rank):
    """Two HWR steps through the loop's batch path (``_train_step``) where
    rank 1's lines are narrower and their labels shorter (bucketed on
    their own): padded to the common shapes first, so the ranks draw equal
    shapes and their states stay equal."""
    b = _batch()
    sl = slice(2 * rank, 2 * rank + 2)
    batch = {k: v[sl] if isinstance(v, (np.ndarray, list)) else v
             for k, v in b.items()}
    if rank == 1:
        batch.update(image=batch["image"][:, :, :128],
                     fg_mask=batch["fg_mask"][:, :, :128],
                     width=np.minimum(batch["width"], 128),
                     label=batch["label"][:, :8],
                     label_lengths=np.minimum(batch["label_lengths"], 8))
    tr = HWRTrainer(load_config(os.path.join(REPO, "configs",
                                             "iam_hwr.json")), device="cpu")
    tr.use_mesh(mesh)
    tr.init_state(seed=0)
    for i in (1, 2):
        tr._train_step(iter([batch]), i, False)
    return _digest([tr.model.state_dict(), tr.generator.get_state()])


def _rank_main(rank, world, port, out_dir):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    pm.init_distributed(device="cpu")
    dp = pm.make_mesh(world, 1)
    fsdp = pm.make_mesh(1, world)
    res = {"dp": _dp_flows(dp, slice(2 * rank, 2 * rank + 2), rank),
           "fsdp": _fsdp_flows(fsdp), "ragged": _ragged_flow(dp, rank)}
    x = torch.arange(3.0) + 10 * rank
    got = pm.fetch(x, dp.data_group)
    res["fetch"] = got
    res["local_rows"] = pm.local_rows(got, world, rank)
    res["any"] = (dp.any(rank == 1), dp.any(False))
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    pm.barrier()
    pm.shutdown()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two ranks' results."""
    out = tmp_path_factory.mktemp("ranks")
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(WORLD, _free_port(), str(out)), nprocs=WORLD,
        join=False, start_method="spawn")
    try:
        deadline = time.monotonic() + RANK_TIMEOUT
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "ranks timed out"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


# ---------------------------------------------------------------------------
# data parallelism = one process on the concatenated batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["hwr", "ae"])
def test_dp_step_matches_one_process(run, name):
    """The averaged gradients and loss equal the one-process ones; the
    parameters after Adam's first step within its bound (2 lr)."""
    for r in run:
        got = r["dp"][name]
        assert got["grad_err"] <= GRAD_RTOL, got["grad_err"]
        assert got["loss_err"] <= 1e-5, got["loss_err"]
        assert got["param_gap"] <= 2 * got["lr"] + 1e-6, got["param_gap"]


@pytest.mark.parametrize("name", ["hwr", "ae"] + list(LESSONS))
def test_dp_ranks_bit_equal(run, name):
    """After each step, the two ranks hold the same bits: averaged
    gradients, parameters, Adam moments, generator, and for the GAN the
    style bank and the ``u``'s."""
    a, b = run
    assert a["dp"][name]["digest"] == b["dp"][name]["digest"]


@pytest.mark.parametrize("kind", LESSONS)
def test_dp_gan_lesson_matches_one_process(run, kind):
    """Each lesson's averaged gradient groups equal the one-process groups
    on the whole batch; the bank equals its bank (the ranks' styles
    gathered in rank order); the parameters within Adam's bound of its
    after the same lessons."""
    cfg = _gan_cfg()
    b1, b2 = cfg.optimizer.betas
    steps = {"main": 0, "disc": 0, "frozen": 0}
    for k in LESSONS[:LESSONS.index(kind) + 1]:
        if k in ("count", "auto"):
            steps["main"] += 1
        elif k == "disc":
            steps["disc"] += 1
    bound = {p: 2 * cfg.optimizer.lr * sum(
        _adam_step_bound(b1, b2, t) for t in range(1, n + 1)) + 1e-6
        for p, n in steps.items()}
    for r in run:
        got = r["dp"][kind]
        assert got["grad_err"] <= GRAD_RTOL, got["grad_err"]
        assert got["bank_count"][0] == got["bank_count"][1]
        assert got["bank_err"] <= 1e-5, got["bank_err"]
        for part, gap in got["param_gap"].items():
            assert gap <= bound[part], (part, gap, bound[part])


def test_ranks_with_ragged_batches_stay_equal(run):
    """Rank 1's batch narrower (128 of 192 columns) with labels at 8 of
    12: after two steps both ranks hold the same parameters and the same
    augmentation generator."""
    a, b = run
    assert a["ragged"] == b["ragged"]


def test_text_lessons_sample_the_same_texts_on_every_rank(run):
    """JAX's quirk, copied: the text sampler takes ``batch_size *
    a_batch_size / data`` texts a rank from the same seed, so every rank
    draws the same texts."""
    a, b = run
    assert a["dp"]["text_batch"].shape[0] == 4 // WORLD
    assert np.array_equal(a["dp"]["text_batch"], b["dp"]["text_batch"])


def test_fetch_local_rows_and_stop_agreement(run):
    """``fetch`` gathers every rank's rows in rank order, ``local_rows``
    gives a rank's own back, and ``Mesh.any`` agrees on a flag any rank
    raised."""
    whole = np.concatenate([np.arange(3.0) + 10 * r for r in range(WORLD)])
    for r, res in enumerate(run):
        assert np.array_equal(res["fetch"], whole)
        assert np.array_equal(res["local_rows"], np.arange(3.0) + 10 * r)
        assert res["any"] == (True, False)


# ---------------------------------------------------------------------------
# sharded Adam = replicated Adam
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank", range(WORLD))
def test_sharded_adam_bit_equal_hwr(run, rank):
    """One HWR step: the same gradients, then the sharded update equals the
    replicated one bit for bit; the gathered state equals the replicated
    state; a replicated checkpoint taken up by the sharded trainer steps
    on bit-equal."""
    res = run[rank]["fsdp"]
    assert res["sharded_slots"] > 0
    for k in ("hwr_grads", "hwr_params", "hwr_opt", "hwr_resumed"):
        ref, sharded = res[k]
        assert ref == sharded, k


@pytest.mark.parametrize("rank", range(WORLD))
def test_sharded_adam_bit_equal_gan_auto(run, rank):
    """One GAN auto lesson (balanced merge, ``PartitionAdam``): the merged
    gradients, the parameters, the ``u``'s, the bank, the gathered Adam
    states and the generator equal the replicated trainer's bit for
    bit."""
    res = run[rank]["fsdp"]
    assert res["gan_merged"][0] == res["gan_merged"][1]
    assert res["gan_state"][0] == res["gan_state"][1]


# ---------------------------------------------------------------------------
# helpers against the JAX package
# ---------------------------------------------------------------------------


class _Rec:
    def __init__(self, i, author):
        self.i, self.author = i, author

    def __eq__(self, other):
        return (self.i, self.author) == (other.i, other.author)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("by_author", [False, True])
def test_shard_records_for_host_matches_jax(n, by_author):
    from handwriting_line_generation_tpu.parallel import mesh as jm
    recs = [_Rec(i, f"w{(i * 7) % 5}") for i in range(23)]
    key = (lambda r: r.author) if by_author else None
    for h in range(n):
        want = jm.shard_records_for_host(recs, n, h, by_author=key)
        assert pm.shard_records_for_host(recs, n, h, by_author=key) == want


@pytest.mark.parametrize("lines,a,n", [(8, 2, 2), (8, 2, 4), (8, 4, 2),
                                       (6, 2, 2), (8, 1, 3), (12, 3, 2),
                                       (16, 2, 8)])
def test_local_batch_size_and_group_check_match_jax(lines, a, n):
    from handwriting_line_generation_tpu.parallel import mesh as jm

    def outcome(fn, *args):
        try:
            return fn(*args)
        except ValueError:
            return "raises"
    assert outcome(pm.local_batch_size, lines, a, n) == \
        outcome(jm.local_batch_size, lines, a, n)
    assert outcome(pm.check_group_local, lines, a, n) == \
        outcome(jm.check_group_local, lines, a, n)


@pytest.mark.parametrize("b,n", [(4, 2), (5, 2), (5, 4), (3, 8)])
def test_pad_batch_to_devices_matches_jax(b, n):
    from handwriting_line_generation_tpu.parallel import mesh as jm
    rng = np.random.default_rng(b * 10 + n)
    batch = {"image": rng.standard_normal((b, 4, 8, 1)).astype(np.float32),
             "label": rng.integers(1, 9, (b, 5)).astype(np.int32),
             "width": rng.integers(8, 33, b), "gt": [f"l{i}" for i in
                                                    range(b)],
             "a_batch_size": 2}
    got, want = pm.pad_batch_to_devices(batch, n), \
        jm.pad_batch_to_devices(batch, n)
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert np.array_equal(got[k], want[k]) and \
                got[k].dtype == want[k].dtype, k
        else:
            assert got[k] == want[k], k


def test_local_rows_matches_jax_single_process():
    from handwriting_line_generation_tpu.parallel import mesh as jm
    arr = np.arange(12).reshape(6, 2)
    assert np.array_equal(pm.local_rows(arr, 1, 0), jm.local_rows(arr))
    assert np.array_equal(pm.local_rows(arr, 3, 1), arr[2:4])


_JAX_SPECS = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
from handwriting_line_generation_tpu.config import MeshConfig
from handwriting_line_generation_tpu.parallel.mesh import (
    fsdp_sharding, make_mesh)
shapes = json.load(sys.stdin)
tree = {k: jax.ShapeDtypeStruct(tuple(v), "float32")
        for k, v in shapes.items()}
out = {}
for data, model in ((2, 2), (1, 4)):
    mesh = make_mesh(MeshConfig(data=data, model=model))
    spec = fsdp_sharding(mesh, tree)
    out[model] = {k: [None if p is None else p for p in s.spec]
                  for k, s in spec.items()}
print(json.dumps(out))
"""


def test_fsdp_axis_matches_jax_fsdp_sharding():
    """The axis rule on the paper GAN's flax parameter shapes (and a few
    made up) against JAX's ``fsdp_sharding`` specs, model 2 and 4."""
    from handwriting_line_generation_tpu_torch.init import init_params
    cfg = load_config(os.path.join(REPO, "configs", "iam_gan_paper.json"))
    shapes = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}")
        else:
            shapes[path] = list(np.shape(node))
    walk(init_params(cfg.model, 0), "")
    shapes.update({"/a": [2048], "/b": [2047], "/c": [64, 64],
                   "/d": [3, 3, 256, 256], "/e": [6, 4, 512],
                   "/f": [5, 7, 61]})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, "-c", _JAX_SPECS],
                         input=json.dumps(shapes), capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    specs = json.loads(res.stdout.strip().splitlines()[-1])
    n_sharded = 0
    for model, spec in specs.items():
        for k, shape in shapes.items():
            ax = pm.fsdp_axis(shape, int(model))
            want = [i for i, p in enumerate(spec[k]) if p == "model"]
            assert ([] if ax is None else [ax]) == want, (model, k, shape)
            n_sharded += ax is not None
    assert n_sharded > 100


def test_row_shard_draws_are_rows_of_the_global_draw():
    """A rank's per-row draws are its rows of one process's draw of the
    whole batch, and its generator ends where that one's does."""
    shapes = [(3, 5), (3, 2, 4), (3,)]
    whole = torch.Generator().manual_seed(7)
    want = [rows.randn(s[:1] and (6,) + s[1:], whole) for s in shapes]
    want.append(rows.randint(0, 9, (6, 2), whole))
    for i in range(2):
        g = torch.Generator().manual_seed(7)
        shard = rows.RowShard(g, 2, i)
        got = [rows.randn(s, shard) for s in shapes]
        got.append(rows.randint(0, 9, (3, 2), shard))
        for a, b in zip(got, want):
            assert torch.equal(a, b[3 * i:3 * i + 3])
        assert torch.equal(g.get_state(), whole.get_state())
    assert rows.plain(shard) is g and rows.plain(g) is g
