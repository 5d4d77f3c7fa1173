"""The port's small modules against their JAX counterparts: the optimizer
kinds (any case, ``sgd``, ``weight_decay``) against optax, the rest of the
loss registry, the metric registry, ``Charset.save``, ``graft_subtree`` and
``param_summary``, ``WikiText``'s local corpus and the transcription-list
CLI."""

import pathlib
import runpy
import sys

import numpy as np
import jax.numpy as jnp
import optax
import pytest
import torch

from handwriting_line_generation_tpu import charset as JC
from handwriting_line_generation_tpu.config import OptimConfig as JOptim
from handwriting_line_generation_tpu.data.wiki_text import \
    WikiText as JWikiText
from handwriting_line_generation_tpu.training import losses as JL
from handwriting_line_generation_tpu.training import metrics as JM
from handwriting_line_generation_tpu.training import train_state as JT
from handwriting_line_generation_tpu.utils import checkpoint as JCK
from handwriting_line_generation_tpu_torch import charset as PC
from handwriting_line_generation_tpu_torch.config import (
    DiscriminatorConfig, OptimConfig,
)
from handwriting_line_generation_tpu_torch.convert import convert_params
from handwriting_line_generation_tpu_torch.data.wiki_text import WikiText
from handwriting_line_generation_tpu_torch.init import init_params
from handwriting_line_generation_tpu_torch.models.hw_with_style import \
    HWWithStyle
from handwriting_line_generation_tpu_torch.scripts import make_IAM_text_list
from handwriting_line_generation_tpu_torch.training import losses as PL
from handwriting_line_generation_tpu_torch.training import metrics as PM
from handwriting_line_generation_tpu_torch.training import train_state as PT
from handwriting_line_generation_tpu_torch.utils import checkpoint as PCK
from test_torch_eval import model_cfgs
from test_torch_threads import one_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]
RTOL_OF_MAX = 1e-6         # each tensor within 1e-6 of its largest entry
SHAPES = {"a": (4, 3), "b": (5,), "c": (2, 2, 3)}


def _close_of_max(got, want, what):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= RTOL_OF_MAX * max(np.abs(want).max(), 1e-30), (what, err)


# -- optimizers ---------------------------------------------------------------

OPTIMIZERS = {
    "Adam": dict(kind="Adam", lr=1e-2, betas=(0.5, 0.999)),
    "ADAM+wd": dict(kind="ADAM", lr=1e-2, betas=(0.9, 0.999),
                    weight_decay=0.1),
    "sgd": dict(kind="sgd", lr=0.1),
    "SGD+wd": dict(kind="SGD", lr=0.1, weight_decay=0.05),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_make_optimizer_matches_optax(name):
    """Two steps of ``make_optimizer`` for each kind, in any case, with
    and without weight decay, against the JAX package's optax chain."""
    kw = OPTIMIZERS[name]
    rng = np.random.default_rng(3)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    tx = JT._adam(JOptim(**kw))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    names = sorted(params)
    tparams = [torch.nn.Parameter(torch.from_numpy(params[k].copy()))
               for k in names]
    opt, sched = PT.make_optimizer(tparams, OptimConfig(**kw),
                                   total_iters=10)
    for step in range(2):
        grads = {k: rng.normal(size=s).astype(np.float32)
                 for k, s in SHAPES.items()}
        upd, state = tx.update({k: jnp.asarray(v) for k, v in
                                grads.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, k in zip(tparams, names):
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        sched.step()
        for p, k in zip(tparams, names):
            _close_of_max(p.detach().numpy(), jp[k], (name, step, k))


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        PT.make_optimizer([torch.nn.Parameter(torch.zeros(2))],
                          OptimConfig(kind="rmsprop"), total_iters=1)


@pytest.mark.parametrize("clip", [2.0, 0.0])
@pytest.mark.parametrize("kind", ["Adam", "sgd"])
def test_partition_optimizer_decay_matches_optax(kind, clip):
    """The GAN's partition optimizers with weight decay, with and without
    the element clip: JAX's chain is clip, then per partition
    ``add_decayed_weights`` and the update; a main parameter that gets no
    gradient still decays, the frozen one never moves."""
    rng = np.random.default_rng(4)
    shapes = {"discriminator/w": (3, 3), "generator/a": (4,),
              "generator/zero": (2, 3), "hwr/w": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    labels = {k: JT.partition_label((k,), hwr_frozen=True) for k in params}
    kw = dict(kind=kind, lr=1e-2, betas=(0.5, 0.999), weight_decay=0.2)
    main_tx, disc_tx = JT.make_optimizers(labels, JOptim(**kw),
                                          JOptim(**kw), grad_clip=clip)
    names = sorted(params)
    tparams = [torch.nn.Parameter(torch.from_numpy(params[k].copy()))
               for k in names]
    plabels = PT.partition_params([k.replace("/", ".") for k in names],
                                  hwr_frozen=True)
    main, disc = PT.make_optimizers(tparams, plabels, OptimConfig(**kw),
                                    OptimConfig(**kw), grad_clip=clip)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    states = {"main": main_tx.init(jp), "disc": disc_tx.init(jp)}
    for step in range(2):
        for which, tx, opt in (("main", main_tx, main),
                               ("disc", disc_tx, disc)):
            grads = {k: (3.0 * rng.normal(size=s)).astype(np.float32)
                     for k, s in shapes.items()}
            grads["generator/zero"][:] = 0
            upd, states[which] = tx.update(
                {k: jnp.asarray(v) for k, v in grads.items()},
                states[which], jp)
            jp = optax.apply_updates(jp, upd)
            tg = [torch.from_numpy(grads[k]) for k in names]
            tg[names.index("generator/zero")] = None     # no gradient
            opt.step(tg)
            for k, p in zip(names, tparams):
                _close_of_max(p.detach().numpy(), jp[k], (step, which, k))
    moved = {k: not np.array_equal(p.detach().numpy(), params[k])
             for k, p in zip(names, tparams)}
    assert moved == {"discriminator/w": True, "generator/a": True,
                     "generator/zero": True, "hwr/w": False}


# -- losses and metrics -------------------------------------------------------

def _loss_inputs(name, rng):
    if name == "CrossEntropyLoss":
        return ((3 * rng.normal(size=(6, 7))).astype(np.float32),
                rng.integers(0, 7, size=6))
    if name == "styleReg":
        return (rng.normal(size=(4, 9)).astype(np.float32),)
    pred = (4 * rng.normal(size=(5, 8))).astype(np.float32)
    if name == "sigmoid_BCE_loss":
        pred[0, :3] = [80.0, -80.0, 35.0]           # past the ±30 clip
        return pred, rng.random(size=(5, 8)).astype(np.float32)
    return pred, (4 * rng.normal(size=(5, 8))).astype(np.float32)


@pytest.mark.parametrize("name", ["CrossEntropyLoss", "HingeLoss",
                                  "AdaptiveHingeLoss", "sigmoid_BCE_loss",
                                  "styleReg"])
def test_registry_losses_match_jax(name):
    args = _loss_inputs(name, np.random.default_rng(5))
    kw = {"threshold": 0.7} if name == "HingeLoss" else {}
    want = float(JL.get_loss(name)(*map(jnp.asarray, args), **kw))
    got = float(PL.get_loss(name)(*map(torch.as_tensor, args), **kw))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_cross_entropy_keeps_the_clamp():
    """A class far below the rest: its probability underflows to 0 and is
    clamped at 1e-12 in both packages."""
    logits = np.array([[0.0, -200.0, 1.0]], np.float32)
    labels = np.array([1])
    want = float(JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(PL.cross_entropy(torch.from_numpy(logits),
                                 torch.from_numpy(labels)))
    assert got == pytest.approx(-np.log(1e-12), rel=1e-6)
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("name", ["class_accuracy", "meanIOU"])
def test_metrics_match_jax(name):
    rng = np.random.default_rng(6)
    if name == "class_accuracy":
        args = (rng.normal(size=(32, 5)).astype(np.float32),
                rng.integers(0, 5, size=32))
    else:
        args = (rng.random(size=(3, 2, 8, 9)).astype(np.float32),
                rng.random(size=(3, 2, 8, 9)).astype(np.float32))
    want = float(JM.get_metric(name)(*map(jnp.asarray, args)))
    got = float(PM.get_metric(name)(*map(torch.as_tensor, args)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(KeyError, match="unknown metric"):
        PM.get_metric("nope")


# -- charset, checkpoints -----------------------------------------------------

@pytest.mark.parametrize("which", ["IAM_CHARSET", "RIMES_CHARSET"])
def test_charset_save_is_jax_bytes(which, tmp_path):
    getattr(PC, which).save(str(tmp_path / "port.json"))
    getattr(JC, which).save(str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()
    assert PC.Charset.load(str(tmp_path / "port.json")) == getattr(PC, which)


def _gan_tree():
    _, tcfg = model_cfgs()
    tcfg.discriminator = DiscriminatorConfig(dim=8)
    return tcfg, init_params(tcfg, seed=0)


def test_param_summary_matches_jax():
    """The same subtree names and counts as the JAX summary of the flax
    tree, from the converted weights and from the model's parameters."""
    tcfg, params = _gan_tree()
    assert "discriminator" in params
    want = JCK.param_summary(params)
    assert PCK.param_summary(convert_params(params)) == want
    model = HWWithStyle(tcfg)
    model.load_state_dict(convert_params(params), strict=False)
    assert PCK.param_summary(model) == want


def test_graft_subtree_matches_jax():
    """JAX's graft of another recognizer into the tree, converted, equals
    the port's graft of that recognizer's converted entries."""
    tcfg, params = _gan_tree()
    other = init_params(tcfg, seed=1)["hwr"]
    want = convert_params(JCK.graft_subtree(params, "hwr", other))
    sd = convert_params(params)
    hwr = PCK.extract_subtree(convert_params({"hwr": other}), "hwr")
    got = PCK.graft_subtree(sd, "hwr", hwr)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert PCK.extract_subtree(got, "hwr").keys() == hwr.keys()
    with pytest.raises(KeyError):
        PCK.graft_subtree(sd, "nope", hwr)


# -- text sources -------------------------------------------------------------

CORPUS = ("Intro paragraph one, with ~ odd | characters; long enough to "
          "keep.\n\nshort\n\nA second   paragraph\nspread over lines and "
          "long enough too.\n\nSee also\nA trailing section that goes.\n")


@pytest.mark.parametrize("path", [False, True])
def test_wiki_text_local_matches_jax(path, tmp_path):
    p = None
    if path:
        p = tmp_path / "corpus.txt"
        p.write_text(CORPUS, encoding="utf-8")
        p = str(p)
    got, want = WikiText(corpus_path=p), JWikiText(corpus_path=p)
    assert len(got) == len(want) > 0
    assert [got[i] for i in range(len(got) + 2)] == \
        [want[i] for i in range(len(want) + 2)]
    with pytest.raises(NotImplementedError, match="local corpus"):
        WikiText(try_hf=True)


def test_make_text_list_matches_jax(tmp_path, monkeypatch):
    """The transcription list of a split, from the port's CLI and the
    root JAX script, byte for byte."""
    config = str(REPO / "configs" / "syn_auto3.json")
    assert make_IAM_text_list.main(["-c", config, "-d", "valid", "-o",
                                    str(tmp_path / "port.txt")]) == 0
    monkeypatch.setattr(sys, "argv", ["make_IAM_text_list.py", "-c", config,
                                      "-d", "valid", "-o",
                                      str(tmp_path / "jax.txt")])
    runpy.run_path(str(REPO / "make_IAM_text_list.py"), run_name="__main__")
    port = (tmp_path / "port.txt").read_bytes()
    assert port == (tmp_path / "jax.txt").read_bytes()
    assert len(port.splitlines()) == 60 * 80
