"""Resuming a JAX training run in the port: the run directory rules (a
fresh run over a JAX run refuses and leaves it byte-equal; ``-r`` resumes;
after a port save the sidecar names the newer file), the optax state ->
torch state conversion (every optax layout the JAX trainers build, and the
weights' converters as index maps), and three JAX runs of ``k = 2`` steps
on the mini-IAM fixture (``iam_hwr`` with a warm-up schedule,
``iam_auto_2tight`` and ``iam_gan_paper`` at the JAX fixture's narrow
widths with the recognizer and encoder frozen) resumed by the port's
``train(..., resume=True)``: the converted state bit for bit, then step
``k + 1`` in both packages on the same batch with the JAX draws injected.

Step ``k + 1`` is held three ways.  Its loss within 1e-5 relative, its
gradient within 1e-3 of each tensor's largest entry (the GAN's disc lesson
in float64, as ``tests/test_torch_gan_trainer.py`` holds it).  And the
resumed optimizer, fed the JAX step's own gradient (read back from its
Adam first moments: ``g = (mu' - b1 mu) / (1 - b1)``), lands within 1e-5 of
each tensor's largest entry of JAX's parameters after the step.  The two
packages' own steps differ by more than that: where a gradient entry is
near zero, float32 summation order flips its sign and Adam turns the flip
into up to 2 lr (measured 7.1e-3 of the largest entry of the recognizer's
``trunk.convs.5`` at lr 1e-3), so those are bounded by 2 lr, as the
trainers' tests bound them.
"""

import copy
import dataclasses
import functools
import json
import multiprocessing
import os
import pathlib
import shutil
import types

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import threadpoolctl
import torch
from flax import serialization

import handwriting_line_generation_tpu.models.autoencoder as j_ae
from handwriting_line_generation_tpu.config import (
    apply_overrides as j_overrides, load_config as j_load,
)
from handwriting_line_generation_tpu.data.datasets import (
    make_batcher as j_batcher, quantize_image_u8,
)
from handwriting_line_generation_tpu.training.auto_trainer import \
    AutoTrainer as JAutoTrainer
from handwriting_line_generation_tpu.training.gan_trainer import \
    GanTrainer as JGanTrainer
from handwriting_line_generation_tpu.training.hwr_trainer import \
    HWRTrainer as JHWRTrainer
from handwriting_line_generation_tpu.training.train_state import \
    create_gan_state as j_create_gan_state
from handwriting_line_generation_tpu.utils.checkpoint import \
    CheckpointManager as JCheckpointManager
from handwriting_line_generation_tpu_torch.config import (
    apply_overrides, load_config,
)
from handwriting_line_generation_tpu_torch.convert import (
    convert_autoencoder_params, convert_hwr_params, convert_params,
    optax_adam, optax_partitions, torch_optimizer_state,
)
from handwriting_line_generation_tpu_torch.inference.load import load_model
from handwriting_line_generation_tpu_torch.init import (
    init_autoencoder_params, init_hwr_params, init_params, init_spectral,
)
from handwriting_line_generation_tpu_torch.training import (
    auto_trainer as p_auto, gan_trainer as p_gan, hwr_trainer as p_hwr,
)
from handwriting_line_generation_tpu_torch.training.loop import resume_seed
from handwriting_line_generation_tpu_torch.utils.checkpoint import (
    checkpoint_file, load_raw_checkpoint,
)
from test_torch_gan_trainer import (  # noqa: F401  (float64: a fixture)
    F64_COMPILE, _JaxRun, _check_groups, _disc_grad, _f64, float64,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
MINI_IAM = REPO / "tests" / "fixtures" / "mini_iam"
JAX_FIXTURE = REPO / "tests" / "fixtures" / "jax_ckpt" / "fixture.json"
K = 2
GRAD_L2 = 3e-3                     # measured 1.5e-4 (hwr), 1.04e-3 (auto)
PARAM_RTOL = 1e-5
RUN = ["trainer.save_step_minor=2", "trainer.save_step=1000",
       "trainer.log_step=1", "trainer.val_step=0",
       f"data.data_dir={MINI_IAM}"]
CONFIGS = {
    # the config's constant rate would leave the schedule's position
    # untested: a warm-up moves the rate every step
    "hwr": ("iam_hwr.json", ["data.batch_size=4",
                             "optimizer.lr_schedule=warmup"]),
    "auto": ("iam_auto_2tight.json", ["data.batch_size=4"]),
    "gan": ("iam_gan_paper.json", [
        "data.text_data=", "model.pretrained_hwr=",
        "trainer.encoder_weights=", "trainer.print_every=0",
        "model.style.dim=16", "model.style.char_dim=16",
        "model.style.char_capacity=4", "trainer.swa=true",
        "trainer.swa_start=1"]),
}
# the GAN's three lessons: a no-step gen lesson (the saved groups and
# have_saved set, the u's advanced, SWA started) and a disc lesson (the disc
# Adam stepped), then a disc lesson from the resumed state (its Adam at its
# second step).  An auto lesson would fill the bank but doubles the JAX
# side's compiles; test_gan_state_fields_convert_bit_for_bit holds a
# random bank and main-partition moments instead
GAN_CURRICULUM = {"0": [["no-step", "gen"], ["disc"], ["disc"]]}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's side on one torch thread and one BLAS thread (several
    test processes share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


def _gan_widths():
    return [ov for ov in json.loads(JAX_FIXTURE.read_text())["overrides"]
            if ".kind=" not in ov]


def _configs(which, save_dir):
    """The JAX and the port config of ``which``, run directory under
    ``save_dir``."""
    name, extra = CONFIGS[which]
    ovs = RUN + extra + [f"trainer.save_dir={save_dir}"]
    if which == "gan":
        ovs += _gan_widths()
    path = str(REPO / "configs" / name)
    jcfg, pcfg = j_overrides(j_load(path), ovs), \
        apply_overrides(load_config(path), ovs)
    if which == "gan":
        jcfg.trainer.curriculum = pcfg.trainer.curriculum = GAN_CURRICULUM
    return jcfg, pcfg


JAX_TRAINERS = {"hwr": JHWRTrainer, "auto": JAutoTrainer,
                "gan": JGanTrainer}
PORT_TRAINERS = {"hwr": p_hwr.HWRTrainer, "auto": p_auto.AutoTrainer,
                 "gan": p_gan.GanTrainer}


def _host_tree(tree):
    """A JAX pytree as msgpack stores it: nested dicts of numpy arrays
    (tuples and optax's named tuples as maps, ``MaskedNode`` as ``{}``)."""
    return serialization.msgpack_restore(serialization.to_bytes(
        jax.tree_util.tree_map(np.asarray, tree)))


def _gan_init_state(jt, pcfg, sample_batch, seed=0):
    """The JAX GAN trainer's ``init_state`` with the port's seeded weights,
    ``u``'s and perceptual encoder (numpy) in place of flax's jitted init
    (35 s of compile on the CPU for the whole model), as
    ``tests/test_torch_gan_trainer.py`` starts both packages."""
    c = pcfg.model
    c.num_class = jt.cfg.model.num_class
    variables = {k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in (
        ("params", init_params(c, seed)), ("spectral", init_spectral(c, seed)))}
    jt.encoder_params = {"params": jax.tree_util.tree_map(
        jnp.asarray, init_autoencoder_params("2tight", 0, seed=seed + 2)
        ["params"]["encoder"])}
    (state, jt.main_tx, jt.disc_tx, jt.gen_only_tx,
     jt.style_ex_tx) = j_create_gan_state(
        jt.cfg, variables, jax.random.PRNGKey(seed + 1),
        need_sep_gen_opt=jt.curriculum.need_sep_gen_opt,
        need_sep_style_ex_opt=jt.curriculum.need_sep_style_ex_opt)
    return state


def _unoptimized_xla():
    """A child's compiles without LLVM's optimizations: half the compile
    time, and the steps run at two-line shapes.  Set before the child's
    first JAX computation starts its backend."""
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_backend_optimization_level=0")


def _step_child(conn, which, save_dir):
    """The JAX run of the recognizer or the autoencoder in a process of its
    own, started with the ``runs`` fixture beside the other two: ``K``
    steps by its trainer's own ``train``, then step ``K + 1`` from JAX's
    resume (:func:`_jax_step`).  Sends the log and that step."""
    _unoptimized_xla()
    jcfg, _ = _configs(which, save_dir)
    jt = JAX_TRAINERS[which](jcfg)
    log = jt.train(iterations=K)
    kept, after, out, args, draws = _jax_step(
        which, jt, pathlib.Path(save_dir, jcfg.name))
    draws = draws and {k: v.numpy() for k, v in draws.items()}
    conn.send(dict(log=log.entries, step=(kept, after, out, args, draws)))
    conn.close()


def _gan_child(conn, save_dir):
    """The JAX side of the GAN in a process of its own, started with the
    ``runs`` fixture beside the recognizer's and the autoencoder's:
    ``K`` lessons by ``GanTrainer.train``, then JAX's own resume from the
    checkpoint and lesson ``K + 1`` on the first batch of
    ``default_rng(5)``.  Sends the log, the lesson's draws and loss, and
    the states before and after it (``_host_tree``)."""
    _unoptimized_xla()
    jcfg, pcfg = _configs("gan", save_dir)
    jt = JGanTrainer(jcfg)
    jt.init_state = functools.partial(_gan_init_state, jt, pcfg)
    log = jt.train(iterations=K)
    batch = next(j_batcher(jcfg.data, "train").batches(
        np.random.default_rng(5)))
    before = JCheckpointManager(
        str(pathlib.Path(save_dir, jcfg.name))).latest(jt.state)
    draws = _disc_draws(jt, jcfg, before, batch)
    jt.state = before
    out = jt.run_lesson(GAN_CURRICULUM["0"][K], iter([batch]), iteration=K)
    conn.send(dict(log=log.entries, draws=draws,
                   loss=float(out["discriminatorLoss"]),
                   before=_host_tree(before), after=_host_tree(jt.state)))
    conn.close()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each JAX run of ``K`` steps, by its trainer's own ``train``, each in
    a spawned child (:func:`_step_child`, :func:`_gan_child`), the three
    side by side: its run directory, configs and log, and for the
    recognizer and the autoencoder step ``K + 1`` (``step``), for the GAN
    the child's answer (``jax``)."""
    ctx = multiprocessing.get_context("spawn")
    roots, conns, children = {}, {}, []
    for which in ("gan", "hwr", "auto"):
        roots[which] = tmp_path_factory.mktemp(f"jax_{which}")
        conns[which], child_end = ctx.Pipe()
        target = _gan_child if which == "gan" else _step_child
        args = ((child_end, str(roots[which])) if which == "gan" else
                (child_end, which, str(roots[which])))
        children.append(ctx.Process(target=target, args=args, daemon=True))
        children[-1].start()
        child_end.close()
    out = {}
    try:
        for which, conn in conns.items():
            if not conn.poll(900):
                raise TimeoutError(f"the JAX {which} run sent no answer")
            got = conn.recv()
            jcfg, pcfg = _configs(which, roots[which])
            run = types.SimpleNamespace(dir=roots[which] / jcfg.name,
                                        jcfg=jcfg, pcfg=pcfg, log=got["log"])
            if which == "gan":
                run.jax = got
            else:
                kept, after, res, args, draws = got["step"]
                draws = draws and {k: torch.from_numpy(v)
                                   for k, v in draws.items()}
                run.step = (kept, after, res, args, draws)
            out[which] = run
    finally:
        for child in children:
            if child.is_alive():
                child.join(30)
                child.kill()
            child.join()
    return out


def _jax_step(which, jt, run_dir):
    """Step ``K + 1`` of JAX's own resume of ``run_dir`` on the first
    batch of ``default_rng(5)``: ``(state before, state after, outputs,
    the port's step arguments, the port's draws)``.  The recognizer's
    augmentation draws are split from the resumed key as its step splits
    them; the autoencoder steps with its dropout off."""
    batch = next(j_batcher(jt.cfg.data, "train").batches(
        np.random.default_rng(5)))
    image = quantize_image_u8(batch["image"])
    args = (image, batch["label"], batch["label_lengths"], batch["width"])
    before = JCheckpointManager(str(run_dir)).latest(jt.state)
    draws = None
    with pytest.MonkeyPatch.context() as mp:
        if which == "hwr":
            draws = _warp_draws(jax.random.split(before.rng)[1],
                                *image.shape[:3])
        else:
            _jax_no_dropout(mp)
            jt = JAutoTrainer(jt.cfg)
        host = lambda t: jax.tree_util.tree_map(np.array, t)
        kept = host(before)          # copied: the step donates its state
        after, out = jt.train_step(before, *map(jnp.asarray, args))
    return kept, host(after), host(out), args, draws


def _copy_run(run, tmp_path):
    """A copy of the JAX run (its directory and configs) under
    ``tmp_path``."""
    jcfg, pcfg = copy.deepcopy(run.jcfg), copy.deepcopy(run.pcfg)
    jcfg.trainer.save_dir = pcfg.trainer.save_dir = str(tmp_path)
    shutil.copytree(run.dir, tmp_path / pcfg.name)
    return tmp_path / pcfg.name, pcfg


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def _resume(which, pcfg):
    """The port's trainer resumed by ``train(..., resume=True)`` (no
    step: the run is at its budget)."""
    pt = PORT_TRAINERS[which](pcfg, device="cpu")
    pt.train(iter(()), iterations=K, resume=True)
    return pt


# -- step 0: the run directory --------------------------------------------


@pytest.mark.parametrize("which", ["hwr", "auto", "gan"])
def test_fresh_run_over_a_jax_run_refuses(runs, which, tmp_path):
    """Before the repair the port saw no checkpoint in a JAX run directory:
    a fresh run started at step 0 and overwrote its sidecars and
    ``train_log.json``.  Now it raises, and every file stays byte-equal;
    ``-r`` resumes at the JAX step."""
    run_dir, pcfg = _copy_run(runs[which], tmp_path)
    before = _files(run_dir)
    assert "checkpoint-latest.msgpack" in before
    with pytest.raises(RuntimeError, match="already contains checkpoints"):
        PORT_TRAINERS[which](pcfg, device="cpu").train(
            iter(()), iterations=K + 1, resume=False)
    assert _files(run_dir) == before
    assert _resume(which, pcfg).step == K


@pytest.mark.parametrize("kept", ["model_best", "checkpoint-iteration2"])
def test_jax_checkpoints_without_latest(runs, kept, tmp_path):
    """A JAX run directory with only a ``model_best`` or a numbered
    checkpoint: a fresh run refuses, and so does ``-r`` (nothing to resume
    from), the files untouched."""
    run_dir, pcfg = _copy_run(runs["hwr"], tmp_path)
    (run_dir / "checkpoint-latest.msgpack").rename(
        run_dir / f"{kept}.msgpack")
    before = _files(run_dir)
    for resume, msg in ((False, "already contains"),
                        (True, f"no checkpoint-latest.*{kept}.msgpack")):
        with pytest.raises(RuntimeError, match=msg):
            p_hwr.HWRTrainer(pcfg, device="cpu").train(
                iter(()), iterations=K + 1, resume=resume)
    assert _files(run_dir) == before


def test_checkpoint_file_follows_the_sidecar(tmp_path):
    """Both ``.pt`` and ``.msgpack``: the port's sidecar (``"format":
    "pt"``) picks the ``.pt``; the JAX package's, or none, refuses."""
    for ext in (".pt", ".msgpack"):
        (tmp_path / f"m{ext}").write_bytes(b"x")
    with pytest.raises(ValueError, match="both"):
        checkpoint_file(str(tmp_path / "m"))
    (tmp_path / "m.json").write_text(json.dumps({"iteration": 3}))
    with pytest.raises(ValueError, match="both"):
        checkpoint_file(str(tmp_path / "m"))
    (tmp_path / "m.json").write_text(json.dumps({"format": "pt"}))
    assert checkpoint_file(str(tmp_path / "m")) == str(tmp_path / "m.pt")


def test_port_save_in_a_jax_run_directory(runs, tmp_path):
    """The port resumes the JAX GAN run, takes a lesson and saves
    ``checkpoint-latest`` (and its ``-swa``) beside the JAX files: the
    sidecars name the port's files, ``load_model`` reads its newer weights,
    a second ``-r`` resumes from them, and ``train_log.json`` keeps JAX's
    entries up to ``K``."""
    run_dir, pcfg = _copy_run(runs["gan"], tmp_path)
    pcfg.trainer.save_step_minor = 1
    batches = j_batcher(runs["gan"].jcfg.data, "train").batches(
        np.random.default_rng(0))
    pt = p_gan.GanTrainer(pcfg, device="cpu")
    pt.train(batches, iterations=K + 1, resume=True)
    assert pt.step == K + 1
    names = {p.name for p in run_dir.iterdir()}
    assert {"checkpoint-latest.pt", "checkpoint-latest.msgpack",
            "checkpoint-latest-swa.pt",
            "checkpoint-latest-swa.msgpack"} <= names
    for name in ("checkpoint-latest", "checkpoint-latest-swa"):
        meta = json.loads((run_dir / f"{name}.json").read_text())
        assert meta["format"] == "pt" and meta["iteration"] == K + 1
    model, step = load_model(pcfg, str(run_dir), device="cpu")
    assert step == K + 1
    for k, v in pt.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    again = p_gan.GanTrainer(pcfg, device="cpu")
    again.train(iter(()), iterations=K + 1, resume=True)
    assert again.step == K + 1 and again.swa_n == pt.swa_n == K + 1
    log = json.loads((run_dir / "train_log.json").read_text())
    jax_log = runs["gan"].log
    assert log[:len(jax_log)] == json.loads(json.dumps(jax_log))
    assert [e["iteration"] for e in log] == [1, 2, 3]


# -- the converters -----------------------------------------------------------


def _distinct(tree, start=0):
    """``tree`` with its leaves replaced by distinct float64 values."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out[k], start = _distinct(v, start)
        else:
            n = int(np.prod(np.shape(v)))
            out[k] = np.arange(start, start + n, dtype=np.float64).reshape(
                np.shape(v))
            start += n
    return out, start


def _gan_params():
    cfg = _configs("gan", "/tmp")[1]
    cfg.model.num_class = 80
    return init_params(cfg.model, seed=0)


INDEX_MAPS = {
    "cnn_only": lambda: (init_hwr_params(
        load_config(str(REPO / "configs/iam_hwr.json")).model.hwr, 80),
        convert_hwr_params),
    "crnn": lambda: (init_hwr_params(dataclasses.replace(
        load_config(str(REPO / "configs/iam_hwr.json")).model.hwr,
        kind="crnn"), 80), convert_hwr_params),
    "2tight": lambda: (init_autoencoder_params("2tight", 80),
                       convert_autoencoder_params),
    "gan": lambda: (_gan_params(), convert_params),
}


@pytest.mark.parametrize("kind", sorted(INDEX_MAPS))
def test_weight_converters_are_index_maps(kind):
    """Each weights converter maps a tree of distinct values to a
    permutation of them: every output element is one input element, so
    the Adam moments convert as the parameters do (``mu`` linearly, ``nu``
    elementwise and non-negative)."""
    params, convert = INDEX_MAPS[kind]()
    tree, n = _distinct(params)
    out = convert(tree)
    got = np.sort(np.concatenate([t.double().numpy().ravel()
                                  for t in out.values()]))
    np.testing.assert_array_equal(got, np.arange(n, dtype=np.float64))


TINY = {"a": {"kernel": np.linspace(-1, 1, 6, dtype=np.float32
                                    ).reshape(2, 3)},
        "b": np.array([0.5, -0.25, 2.0, 0.0], np.float32)}


def _tiny_convert(tree):
    return {"a.weight": torch.from_numpy(np.array(tree["a"]["kernel"])).T,
            "b": torch.from_numpy(np.array(tree["b"]))}


OPTAX = {
    "adam": (lambda s: optax.adam(1e-2, b1=0.5, b2=0.99), "adam", None),
    "adam+schedule": (lambda s: optax.adam(s, b1=0.5, b2=0.99), "adam",
                      "warmup"),
    "adam+weight_decay": (lambda s: optax.chain(
        optax.add_decayed_weights(0.1), optax.adam(1e-2, b1=0.5, b2=0.99)),
        "adam", None),
    "sgd": (lambda s: optax.sgd(1e-2), "sgd", None),
    "sgd+schedule": (lambda s: optax.sgd(s), "sgd", "warmup"),
}


@pytest.mark.parametrize("name", sorted(OPTAX))
def test_optax_state_to_torch(name):
    """Each optax optimizer the JAX trainers build, after three updates,
    converted to a ``torch.optim`` optimizer and its ``LambdaLR``: the
    moments and step counts exact, and the next update equal to optax's
    (float32)."""
    from handwriting_line_generation_tpu_torch.config import OptimConfig
    from handwriting_line_generation_tpu_torch.training.train_state import \
        make_optimizer
    make, kind, sched = OPTAX[name]
    j_sched = lambda c: 1e-2 * jnp.minimum((c + 1.0) ** -0.3,
                                           (c + 1.0) * 10 ** -1.3)
    tx = make(j_sched)
    params = jax.tree_util.tree_map(jnp.asarray, TINY)
    state = tx.init(params)
    rng = np.random.default_rng(0)
    grads = [jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(size=a.shape), jnp.float32),
        params) for _ in range(4)]
    for g in grads[:3]:
        upd, state = tx.update(g, state, params)
        params = optax.apply_updates(params, upd)
    raw = serialization.msgpack_restore(serialization.to_bytes(
        jax.tree_util.tree_map(np.asarray, state)))
    host = jax.tree_util.tree_map(np.asarray, params)
    count, mu, nu = optax_adam(raw, host, _tiny_convert)
    assert count == (None if name == "sgd" else 3)
    assert (mu is None) == (kind == "sgd")
    if mu is not None:
        j_adam = state[1][0] if "decay" in name else state[0]
        for got, want in ((mu, j_adam.mu), (nu, j_adam.nu)):
            for k, v in _tiny_convert(jax.tree_util.tree_map(
                    np.asarray, want)).items():
                assert torch.equal(got[k], v), k

    model = torch.nn.Module()
    model.a = torch.nn.Linear(2, 3, bias=False)
    model.b = torch.nn.Parameter(torch.zeros(4))
    model.load_state_dict(_tiny_convert(host))
    cfg = OptimConfig(kind=kind, lr=1e-2, betas=(0.5, 0.99),
                      lr_schedule=sched or "none", warmup_steps=10,
                      weight_decay=0.1 if "decay" in name else 0.0)
    opt, lr_sched = make_optimizer(model.parameters(), cfg, 1000)
    names = [n for n, _ in model.named_parameters()]
    o, s = torch_optimizer_state(opt, lr_sched, names,
                                 3 if count is None else count, mu, nu)
    opt.load_state_dict(o)
    lr_sched.load_state_dict(s)
    assert lr_sched.last_epoch == 3
    g3 = _tiny_convert(jax.tree_util.tree_map(np.asarray, grads[3]))
    for name, p in model.named_parameters():
        p.grad = g3[name].clone()
        if kind == "adam":
            assert opt.state_dict()["state"][0]["step"].item() == 3
    opt.step()
    upd, state = tx.update(grads[3], state, params)
    want = _tiny_convert(jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(params, upd)))
    for k, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_gan_state_fields_convert_bit_for_bit(tmp_path):
    """A JAX ``GanTrainState`` of the JAX fixture's narrow model with every
    float leaf random (the Adam moments under the masked partitions, the
    saved groups, the bank, the ``u``'s), every count 5, ``have_saved``
    set, and an SWA tree, saved by the JAX ``CheckpointManager``: the
    port's GAN trainer resumes each field bit for bit."""
    fx = json.loads(JAX_FIXTURE.read_text())
    path = str(REPO / fx["config"])
    ovs = fx["overrides"] + [f"trainer.save_dir={tmp_path}",
                             "model.pretrained_hwr=",
                             "trainer.encoder_weights=", "data.text_data="]
    jcfg = j_overrides(j_load(path), ovs)
    pcfg = apply_overrides(load_config(path), ovs)
    jcfg.model.num_class = 80
    raw = serialization.msgpack_restore(
        (JAX_FIXTURE.parent / "model_best.msgpack").read_bytes())
    state = j_create_gan_state(jcfg, raw, jax.random.PRNGKey(3))[0]
    rng = np.random.default_rng(1)
    masked = lambda x: type(x).__name__ == "MaskedNode"

    def randomize(x):
        a = np.asarray(x) if not masked(x) else None
        if a is not None and a.dtype == np.float32:
            return jnp.asarray(rng.normal(size=a.shape), jnp.float32)
        if a is not None and a.dtype == np.int32 and a.shape == ():
            return jnp.asarray(5, jnp.int32)
        return x
    state = jax.tree_util.tree_map(randomize, state, is_leaf=masked)
    state = state.replace(have_saved=jnp.asarray(True),
                          bank_count=jnp.asarray(7, jnp.int32))
    swa = jax.tree_util.tree_map(randomize, state.params)
    run = tmp_path / pcfg.name
    JCheckpointManager(str(run), save_step=0, save_step_minor=5).maybe_save(
        5, state, {"name": pcfg.name}, extra_trees={"swa": swa},
        extra_meta={"swa_n": 4})
    pt = p_gan.GanTrainer(pcfg, device="cpu")
    pt.init_state(seed=0)
    raw = load_raw_checkpoint(str(run), "checkpoint-latest")
    pt.load_jax_state(raw, str(run))
    s = pt.state
    weights = convert_params(raw["params"], raw["spectral"])
    for k, v in pt.model.state_dict().items():
        assert torch.equal(v, weights[k]), k
    for slot in ("saved_recog", "saved_adv"):
        want = convert_params(raw[slot])
        for name, t in zip(s.names, getattr(s, slot)):
            assert torch.equal(t, want[name]), (slot, name)
    assert s.have_saved is True and s.bank_count == 7 and s.step == 5
    assert torch.equal(s.style_bank, torch.from_numpy(raw["style_bank"]))
    _check_optimizers(s, raw, {"opt_main": 5, "opt_disc": 5})
    want_swa = convert_params(jax.tree_util.tree_map(np.asarray, swa))
    for name, t in zip(s.names, pt.swa):
        assert torch.equal(t, want_swa[name]), name
    assert pt.swa_n == 4
    g = torch.Generator().manual_seed(resume_seed(pcfg.trainer.seed, 5))
    assert torch.equal(s.generator.get_state(), g.get_state())


def _check_optimizers(s, raw, counts):
    """Both GAN optimizers' moments and steps against the raw state's, bit
    for bit; their schedules at ``counts[name]``."""
    for opt_name, part in (("opt_main", "main"), ("opt_disc", "disc")):
        opt, count = getattr(s, opt_name), counts[opt_name]
        adam = optax_partitions(raw[opt_name])[part]["0"]
        assert int(adam["count"]) == count
        mu = _named_moments(adam["mu"], convert_params, raw["params"])
        nu = _named_moments(adam["nu"], convert_params, raw["params"])
        sd = opt.optimizer.state_dict()["state"]
        assert len(sd) == len(opt.order) > 0
        for j, i in enumerate(opt.order):
            name = s.names[i]
            assert s.labels[i] == part and sd[j]["step"].item() == count
            assert torch.equal(sd[j]["exp_avg"], mu[name]), name
            assert torch.equal(sd[j]["exp_avg_sq"], nu[name]), name
        assert opt.scheduler.last_epoch == count


# -- the trained runs ---------------------------------------------------------


def _named_moments(tree, convert, params):
    return convert(jax.tree_util.tree_map(
        lambda m, p: np.zeros_like(p) if isinstance(m, dict) else m,
        tree, params, is_leaf=lambda x: isinstance(x, dict) and not x))


@pytest.mark.parametrize("which", ["hwr", "auto"])
def test_resumed_state_equals_jax(runs, which, tmp_path):
    """The port's ``-r`` over the JAX run: weights, every Adam moment bit
    for bit under the layout mapping, every step and the schedule's
    position at optax's count, the generator from ``trainer.seed`` and the
    step, and JAX's ``train_log.json`` entries kept."""
    run_dir, pcfg = _copy_run(runs[which], tmp_path)
    raw = load_raw_checkpoint(str(run_dir), "checkpoint-latest")
    pt = _resume(which, pcfg)
    convert = pt._jax_params
    weights = convert(raw["params"])
    adam = raw["opt_state"]["0"]
    assert int(adam["count"]) == K == pt.step
    mu, nu = (convert(adam[k]) for k in ("mu", "nu"))
    sd = pt.optimizer.state_dict()
    for i, (name, p) in enumerate(pt.model.named_parameters()):
        assert torch.equal(p.detach(), weights[name]), name
        st = sd["state"][i]
        assert st["step"].item() == K
        assert torch.equal(st["exp_avg"], mu[name]), name
        assert torch.equal(st["exp_avg_sq"], nu[name]), name
        assert (st["exp_avg_sq"] >= 0).all()
    assert pt.scheduler.last_epoch == K
    lam = pt.scheduler.lr_lambdas[0]
    assert pt.optimizer.param_groups[0]["lr"] == \
        pt.scheduler.base_lrs[0] * lam(K)
    if which == "hwr":
        assert "1" in raw["opt_state"] and \
            int(raw["opt_state"]["1"]["count"]) == K
    g = torch.Generator().manual_seed(resume_seed(pcfg.trainer.seed, K))
    assert torch.equal(pt.generator.get_state(), g.get_state())
    log = json.loads((run_dir / "train_log.json").read_text())
    assert log == json.loads(json.dumps(runs[which].log))
    assert [e["iteration"] for e in log] == [1, 2]


def _rel_l2(got, want):
    a = torch.cat([g.reshape(-1).double() for g in got])
    b = torch.cat([w.reshape(-1).double() for w in want])
    return float((a - b).norm() / b.norm())


def _warp_draws(key, B, H, W):
    """The brightness + warp draws the JAX step splits from ``key``."""
    k1, k2 = jax.random.split(key)
    shifts = []
    for k in jax.random.split(k1, B):
        a, b = jax.random.split(k)
        shifts.append([float(jax.random.normal(a)),
                       float(jax.random.normal(b))])
    return {"shifts": torch.tensor(shifts),
            "offsets": torch.from_numpy(np.array(jax.random.normal(
                k2, (B, H // 12 + 2, W // 12 + 2, 2))))}


def _jax_no_dropout(mp):
    _, dec, dim = j_ae._AE_KINDS["2tight"]
    mp.setitem(j_ae._AE_KINDS, "2tight", (
        lambda dt=None: j_ae.Encoder2(out_dim=32, dropout=0.0, dtype=dt),
        dec, dim))
    mp.setattr(j_ae, "EHWR", functools.partial(j_ae.EHWR, dropout=0.0))


@pytest.mark.parametrize("which", ["hwr", "auto"])
def test_step_after_resume_matches_jax(runs, which, tmp_path, monkeypatch):
    """Step ``K + 1`` from JAX's own resume and from the port's ``-r``, on
    the same batch (the HWR's augmentation draws split from the resumed
    JAX key; the autoencoder's dropout off on both sides): the loss, the
    gradient, and the resumed Adam fed JAX's gradient against JAX's
    parameters after the step."""
    run = runs[which]
    run_dir, pcfg = _copy_run(run, tmp_path)
    before, after, out, args, draws = run.step
    pt = _resume(which, pcfg)
    if which == "hwr":
        aug = p_hwr.apply_augmentation
        monkeypatch.setattr(p_hwr, "apply_augmentation",
                            lambda *a: aug(*a, draws=draws))
    else:
        for m in pt.model.modules():
            if hasattr(m, "dropout"):
                m.dropout = 0.0
    snapshot = (copy.deepcopy(pt.model.state_dict()),
                copy.deepcopy(pt.optimizer.state_dict()),
                copy.deepcopy(pt.scheduler.state_dict()))
    got = pt.train_step(*args)
    loss = got[0] if which == "hwr" else got["loss"]
    np.testing.assert_allclose(float(loss), float(out["loss"]), rtol=1e-5)

    convert = pt._jax_params
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)
    b1 = pcfg.optimizer.betas[0]
    mu0 = convert(host(before.opt_state[0].mu))
    mu1 = convert(host(after.opt_state[0].mu))
    g_jax = {k: (mu1[k] - b1 * mu0[k]) / (1 - b1) for k in mu0}
    names = [n for n, _ in pt.model.named_parameters()]
    err = _rel_l2([p.grad for _, p in pt.model.named_parameters()],
                  [g_jax[n] for n in names])
    print(f"{which} step {K + 1}: gradient relative L2 {err:.3e}")
    assert err <= GRAD_L2
    want = convert(host(after.params))
    lr = pt.optimizer.param_groups[0]["lr"]
    for name, p in pt.model.named_parameters():     # Adam's sign flips
        assert (p.detach() - want[name]).abs().max() <= 2 * lr + 1e-7, name

    pt.model.load_state_dict(snapshot[0])
    pt.optimizer.load_state_dict(snapshot[1])
    pt.scheduler.load_state_dict(snapshot[2])
    for name, p in pt.model.named_parameters():
        p.grad = g_jax[name].clone()
    pt.optimizer.step()
    pt.scheduler.step()
    for name, p in pt.model.named_parameters():
        scale = want[name].abs().max().item()
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=PARAM_RTOL * scale,
                                   err_msg=name)
    assert pt.scheduler.last_epoch == K + 1


def _disc_draws(jt, c, state, batch):
    """The JAX disc step's draws (numpy), split from its state's key as the
    step splits it: the affine augmentation's, the bank sample's, the
    spacer's normals and the generator's noise planes (recorded as
    ``test_torch_gan_trainer`` records them)."""
    _, aug_key, krng, nrng, srng = jax.random.split(state.rng, 5)
    k1, k2 = jax.random.split(aug_key)
    max_rot = 45 / 180 * np.pi
    aug = {"stretch": np.asarray(jax.random.uniform(
               k1, (), minval=0.6, maxval=1.4)),
           "skew": np.asarray(jax.random.uniform(
               k2, (), minval=-max_rot, maxval=max_rot))}
    B, L = batch["label"].shape
    T = batch["image"].shape[2] // 4
    k1, k2, k3 = jax.random.split(srng, 3)
    limit = jnp.clip(state.bank_count, 1, state.style_bank.shape[0])
    a, b = jax.random.split(krng)
    recorder = types.SimpleNamespace(noise_fns={}, jcfg=c)
    noise = _JaxRun._noise_fn(recorder, T)(state.params, nrng)
    return {"aug": aug,
            "bank": tuple(np.asarray(v) for v in (
                jax.random.randint(k1, (B, 2), 0, limit),
                jax.random.uniform(k2, (B, 1), minval=jt.interp_low,
                                   maxval=jt.interp_high),
                jax.random.normal(k3, (B, c.model.packed_style_dim())))),
            "normals": tuple(np.asarray(jax.random.normal(k, (B, L)))
                             for k in (a, b)),
            "noise": [np.asarray(p) for p in noise]}


def _torch_draws(d):
    return {"aug": {k: torch.tensor(v) for k, v in d["aug"].items()},
            "bank": tuple(torch.tensor(v) for v in d["bank"]),
            "normals": tuple(torch.tensor(v) for v in d["normals"]),
            "noise": [torch.tensor(v) for v in d["noise"]]}


@pytest.fixture(scope="module")
def gan_step(runs, tmp_path_factory):
    """The GAN's lesson ``K + 1`` (disc) from the port's ``-r`` on the
    batch and draws of JAX's (``runs["gan"].jax``), and the port's state
    before it."""
    run = runs["gan"]
    run_dir, pcfg = _copy_run(run, tmp_path_factory.mktemp("gan_step"))
    batch = next(j_batcher(run.jcfg.data, "train").batches(
        np.random.default_rng(5)))
    pt = _resume("gan", pcfg)
    snapshot = (copy.deepcopy(pt.model.state_dict()),
                copy.deepcopy(pt.state.opt_disc.state_dict()))
    draws = _torch_draws(run.jax["draws"])
    got = pt.run_lesson(GAN_CURRICULUM["0"][K], iter([batch]), iteration=K,
                        draws=draws)
    return types.SimpleNamespace(
        run=run, pcfg=pcfg, pt=pt, got=got, draws=draws, batch=batch,
        before=run.jax["before"], after=run.jax["after"],
        snapshot=snapshot)


def test_gan_resumed_state_equals_jax(runs, tmp_path):
    """The port's ``-r`` over the JAX GAN run: weights and ``u``'s, both
    optimizers' moments and counts, the saved groups and ``have_saved``,
    the bank and its count, SWA and ``swa_n``, bit for bit."""
    run_dir, pcfg = _copy_run(runs["gan"], tmp_path)
    raw = load_raw_checkpoint(str(run_dir), "checkpoint-latest")
    pt = _resume("gan", pcfg)
    s = pt.state
    assert s.step == K and int(raw["bank_count"]) == s.bank_count
    assert s.have_saved and bool(raw["have_saved"])
    weights = convert_params(raw["params"], raw["spectral"])
    for k, v in pt.model.state_dict().items():
        assert torch.equal(v, weights[k]), k
    assert torch.equal(s.style_bank, torch.from_numpy(
        np.asarray(raw["style_bank"])))
    assert s.have_saved == bool(raw["have_saved"])
    for slot in ("saved_recog", "saved_adv"):
        want = _named_moments(raw[slot], convert_params, raw["params"])
        for name, t in zip(s.names, getattr(s, slot)):
            assert torch.equal(t, want[name]), (slot, name)
    _check_optimizers(s, raw, {"opt_main": 0, "opt_disc": 1})
    swa = convert_params(load_raw_checkpoint(str(run_dir),
                                             "checkpoint-latest-swa"))
    for name, t in zip(s.names, pt.swa):
        assert torch.equal(t, swa[name]), name
    assert pt.swa_n == K == json.loads(
        (run_dir / "checkpoint-latest-swa.json").read_text())["swa_n"]


def test_gan_lesson_after_resume_matches_jax(gan_step):
    """Lesson ``K + 1`` (disc): the loss and the ``u``'s it leaves against
    JAX's from the same state, and the resumed disc Adam (at its second
    step) fed JAX's gradient against JAX's parameters after the lesson;
    every other parameter unchanged."""
    g = gan_step
    pt, s = g.pt, g.pt.state
    np.testing.assert_allclose(float(g.got["discriminatorLoss"]),
                               g.run.jax["loss"], rtol=1e-5)
    spec = convert_params(g.after["params"], g.after["spectral"])
    for name, t in pt.model.state_dict().items():
        if name.endswith(".u"):
            np.testing.assert_allclose(t.numpy(), spec[name].numpy(),
                                       atol=1e-6, err_msg=name)
    b1 = g.pcfg.optimizer_discriminator.betas[0]
    mu = [_named_moments(optax_partitions(st["opt_disc"])["disc"]["0"]["mu"],
                         convert_params, st["params"])
          for st in (g.before, g.after)]
    pt.model.load_state_dict(g.snapshot[0])
    s.opt_disc.load_state_dict(g.snapshot[1])
    s.opt_disc.step([(mu[1][n] - b1 * mu[0][n]) / (1 - b1)
                     for n in s.names])
    want = convert_params(g.after["params"])
    start = convert_params(g.before["params"])
    params = dict(pt.model.named_parameters())
    for name, label in zip(s.names, s.labels):
        p = params[name].detach()
        if label == "disc":
            scale = want[name].abs().max().item()
            np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                       rtol=0, atol=PARAM_RTOL * scale,
                                       err_msg=name)
        else:
            assert torch.equal(p, start[name]) and \
                torch.equal(want[name], start[name]), name


@pytest.mark.compile
def test_gan_lesson_after_resume_float64(gan_step, float64):
    """Lesson ``K + 1``'s gradient in float64 from the resumed state: the
    port's disc step against JAX's gradient of the hinge loss on the real
    and fake lines the port's discriminator saw, from the checkpoint's
    weights and ``u``'s (within 1e-3 of each tensor's largest entry)."""
    g = gan_step
    pt = p_gan.GanTrainer(g.pcfg, device="cpu")
    pt.train(iter(()), iterations=K, resume=True)
    pt.model.double()
    seen = []
    discriminate = pt.model.discriminate

    def spy(image, **kw):
        seen.append(image.detach().numpy())
        return discriminate(image, **kw)
    pt.model.discriminate = spy
    b = g.batch
    out = pt.step_disc(torch.from_numpy(quantize_image_u8(b["image"])),
                       b["label"], b["label_lengths"], b["width"],
                       b["a_batch_size"], draws=g.draws)
    assert len(seen) == 2 and out["grads"][0].dtype == torch.float64
    disc = _f64({"discriminator": g.before["params"]["discriminator"]})
    spectral = _f64(g.before["spectral"])
    fn = jax.jit(_disc_grad(g.run.jcfg.model)).lower(
        disc, spectral, *seen).compile(F64_COMPILE)
    _check_groups([fn(disc, spectral, *seen)], [out["grads"]],
                  pt.state.names, g.before["spectral"])
