"""Port parity for autoencoder pretraining: the port's ``AutoTrainer``
against the JAX trainer from the same weights and batches (dropout at 0 on
both sides, float32), and the checkpoint loop both port trainers share:
resume bit for bit, the two clobber refusals, ``model_best`` and SIGINT."""

import functools
import json
import pathlib
import signal

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from handwriting_line_generation_tpu.config import load_config as j_load
from handwriting_line_generation_tpu.models import autoencoder as J
from handwriting_line_generation_tpu.ops.augment import \
    dequantize_image as j_dequantize
from handwriting_line_generation_tpu.ops.ctc import ctc_loss_fast as j_ctc
from handwriting_line_generation_tpu.training.auto_trainer import (
    AutoState, AutoTrainer as JAutoTrainer,
)
from handwriting_line_generation_tpu_torch.charset import IAM_CHARSET
from handwriting_line_generation_tpu_torch.config import load_config
from handwriting_line_generation_tpu_torch.convert import \
    convert_autoencoder_params
from handwriting_line_generation_tpu_torch.init import \
    init_autoencoder_params
from handwriting_line_generation_tpu_torch.training.auto_trainer import \
    AutoTrainer
from handwriting_line_generation_tpu_torch.training.hwr_trainer import \
    HWRTrainer
from handwriting_line_generation_tpu_torch.utils import checkpoint as ckpt

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"
AUTO, HWR = CONFIGS / "iam_auto_2tight.json", CONFIGS / "iam_hwr.json"
B, W, L, NC = 2, 128, 6, 12
LR = 2e-4                            # configs/iam_auto_2tight.json
STEPS = 3


def _batch(seed=0, w=W):
    """u8 lines with ink widths, labels in [1, NC), and their text."""
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, (B, 64, w, 1)).astype(np.uint8)
    label_lengths = np.array([L, 3], np.int32)
    label = np.zeros((B, L), np.int32)
    for b in range(B):
        label[b, :label_lengths[b]] = rng.integers(1, NC, label_lengths[b])
    width = np.array([w, 3 * w // 4], np.int32)
    gt = [IAM_CHARSET.decode(label[b, :label_lengths[b]]) for b in range(B)]
    return dict(image=image, label=label, label_lengths=label_lengths,
                width=width, gt=gt)


def _args(batch):
    return [batch[k] for k in ("image", "label", "label_lengths", "width")]


@pytest.fixture
def jax_no_dropout(monkeypatch):
    """The JAX ``2tight`` autoencoder with its dropout rates at 0."""
    _, dec, dim = J._AE_KINDS["2tight"]
    monkeypatch.setitem(J._AE_KINDS, "2tight", (
        lambda dt=None: J.Encoder2(out_dim=32, dropout=0.0, dtype=dt), dec,
        dim))
    monkeypatch.setattr(J, "EHWR", functools.partial(J.EHWR, dropout=0.0))


def _no_dropout(trainer):
    for m in trainer.model.modules():
        if hasattr(m, "dropout"):
            m.dropout = 0.0


def _trainers(tree):
    jcfg, tcfg = j_load(str(AUTO)), load_config(str(AUTO))
    jcfg.autoencoder.hwr_classes = tcfg.autoencoder.hwr_classes = NC
    jt = JAutoTrainer(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = AutoState(step=jnp.zeros((), jnp.int32), params=params,
                      opt_state=jt.tx.init(params),
                      rng=jax.random.PRNGKey(1))
    pt = AutoTrainer(tcfg, device="cpu")
    pt.init_state(seed=0, params=tree)
    _no_dropout(pt)
    return jt, state, pt


def _flat(tree):
    return convert_autoencoder_params(jax.tree_util.tree_map(np.asarray,
                                                             tree))


@pytest.mark.compile
def test_auto_trajectory_matches_jax(jax_no_dropout):
    tree = init_autoencoder_params("2tight", NC, seed=0)
    jt, state, pt = _trainers(tree)
    batch = _args(_batch())
    jbatch = [jnp.asarray(a) for a in batch]

    def loss_fn(p):
        image = j_dequantize(jbatch[0], jbatch[3])
        recon, logp = jt.model.apply(p, image)
        auto = jnp.mean(jnp.abs(recon - image))
        recog = j_ctc(logp, jbatch[1], jbatch[2])
        return auto + recog, (auto, recog)
    (_, (auto_j, recog_j)), g_j = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(state.params)
    g_want = _flat(g_j)

    def param_diffs():
        p_want = _flat(state.params)
        return [np.abs(p.detach().numpy() - p_want[name].numpy())
                for name, p in pt.model.named_parameters()]
    for step in range(STEPS):
        state, out = jt.train_step(state, *jbatch)
        got = pt.train_step(*batch)
        # after the first update the weights differ by up to ~2 lr where a
        # near-zero gradient flips sign (see below), so later losses differ
        # by ~1e-4 relative and log-probs by ~4e-4
        rtol, atol = (1e-5, 1e-4) if step == 0 else (1e-3, 2e-3)
        for k in ("loss", "autoLoss", "recogLoss"):
            np.testing.assert_allclose(float(got[k]), float(out[k]),
                                       rtol=rtol, err_msg=k)
        np.testing.assert_allclose(got["logp"].numpy(),
                                   np.asarray(out["logp"]), rtol=0.0,
                                   atol=atol)
        if step == 0:
            np.testing.assert_allclose(float(got["autoLoss"]),
                                       float(auto_j), rtol=1e-5)
            np.testing.assert_allclose(float(got["recogLoss"]),
                                       float(recog_j), rtol=1e-5)
            # step-1 gradients, against each tensor's largest entry.  The
            # biases and norms that feed a GroupNorm have gradients that
            # nearly cancel, so float32 summation order leaves up to ~8e-4
            # of the max (the same comparison in float64 agrees to 2e-6,
            # the float32 tanh and log-softmax both packages keep)
            for name, p in pt.model.named_parameters():
                want = g_want[name].numpy()
                np.testing.assert_allclose(
                    p.grad.numpy(), want, rtol=0.0,
                    atol=1e-3 * np.abs(want).max(), err_msg=name)
            first = np.concatenate([d.ravel() for d in param_diffs()])
            assert first.mean() <= 1e-3 * LR
    # Adam's first updates are ~lr * sign(g): a coordinate whose tiny
    # gradient differs in sign between the frameworks may differ by up to
    # 2 lr a step.  Adam then spreads those differences: the mean grows
    # ~5x a step (4e-5, 4e-3, 2e-2 lr), the same in float64 on both sides,
    # since both models keep their tanh and log-softmax in float32
    diffs = param_diffs()
    assert max(d.max() for d in diffs) <= 2 * LR * STEPS + 1e-6
    assert np.concatenate([d.ravel() for d in diffs]).mean() <= 0.05 * LR
    assert pt.step == STEPS


class _Batcher:
    """A stand-in for the JAX package's batchers: ``batches`` from a
    list."""

    def __init__(self, batches):
        self.items = batches

    def batches(self, rng, shuffle=True):
        return iter(self.items)


@pytest.mark.compile
def test_eval_step_and_validate_match_jax(jax_no_dropout):
    tree = init_autoencoder_params("2tight", NC, seed=1)
    jt, state, pt = _trainers(tree)
    batches = []
    for seed in (2, 3):
        b = _batch(seed)
        b["image"] = np.asarray(j_dequantize(jnp.asarray(b["image"]),
                                             jnp.asarray(b["width"])))
        batches.append(b)
    out_j = jt.eval_step(state, *[jnp.asarray(batches[0][k]) for k in
                                  ("image", "label", "label_lengths")])
    out = pt.eval_step(*_args(batches[0]))
    for k in ("val_autoLoss", "val_recogLoss"):
        np.testing.assert_allclose(float(out[k]), float(out_j[k]),
                                   rtol=1e-5, err_msg=k)
    for k in ("recon", "logp"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(out_j[k]),
                                   rtol=0.0, atol=1e-4, err_msg=k)
    jt.state = state
    want = jt.validate(_Batcher(batches))
    got = pt.validate(batches)
    assert set(got) == set(want) == {"val_autoLoss", "val_recogLoss",
                                     "val_CER"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert pt.validate(batches, max_batches=1)["val_CER"] == \
        jt.validate(_Batcher(batches), max_batches=1)["val_CER"]


def test_auto_trainer_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AutoTrainer(load_config(str(AUTO)))


# -- the checkpoint loop, for both trainers --------------------------------


def _cfg(which, save_dir, **trainer):
    cfg = load_config(str(AUTO if which == "auto" else HWR))
    if which == "auto":
        cfg.autoencoder.hwr_classes = NC
    cfg.trainer.save_dir = str(save_dir)
    cfg.trainer.log_step = 1
    cfg.trainer.val_step = 0
    cfg.trainer.save_step = 10 ** 9
    cfg.trainer.save_step_minor = 2
    for k, v in trainer.items():
        setattr(cfg.trainer, k, v)
    return cfg


def _trainer(which, cfg):
    tr = (AutoTrainer if which == "auto" else HWRTrainer)(cfg, device="cpu")
    tr.init_state(seed=0)
    return tr


BATCHES = [_batch(s, w=64) for s in range(3)]


@pytest.mark.parametrize("which", ["auto", "hwr"])
def test_resume_continues_bit_for_bit(which, tmp_path):
    """N steps in one run equal k steps, then a resume into a fresh trainer
    and N - k more: weights, optimizer moments, LR and the generator (the
    dropout masks, or the HWR augmentation's draws)."""
    straight = _trainer(which, _cfg(which, tmp_path / "a"))
    straight.train(BATCHES, iterations=3)
    first = _trainer(which, _cfg(which, tmp_path / "b"))
    first.train(BATCHES[:2], iterations=3)          # stops when they run out
    assert first.step == 2
    second = _trainer(which, _cfg(which, tmp_path / "b"))
    second.init_state(seed=7)                       # the checkpoint decides
    log = second.train(BATCHES[2:], iterations=3, resume=True)
    assert second.step == 3
    assert [e["iteration"] for e in log.entries] == [1, 2, 3]
    want, got = straight.state_dict(), second.state_dict()
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    for i, s in want["optimizer"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(got["optimizer"]["state"][i][k], s[k])
    assert got["scheduler"] == want["scheduler"]
    assert torch.equal(got["generator"], want["generator"])
    meta = ckpt.load_meta(str(tmp_path / "b" / straight.cfg.name),
                          "checkpoint-latest")
    assert meta["iteration"] == 2 and "interrupted" not in meta


@pytest.mark.parametrize("which", ["auto", "hwr"])
def test_refuses_to_clobber(which, tmp_path):
    cfg = _cfg(which, tmp_path, save_step_minor=1)
    _trainer(which, cfg).train(BATCHES[:1], iterations=1)
    with pytest.raises(RuntimeError, match="already contains checkpoints"):
        _trainer(which, cfg).train(BATCHES[1:2], iterations=2, resume=False)
    # numbered checkpoints but no checkpoint-latest: a resume refuses too
    run = tmp_path / cfg.name
    (run / "checkpoint-latest.pt").rename(run / "checkpoint-iteration1.pt")
    with pytest.raises(RuntimeError, match="no checkpoint-latest"):
        _trainer(which, cfg).train(BATCHES[1:2], iterations=2, resume=True)


@pytest.mark.parametrize("which", ["auto", "hwr"])
def test_model_best_written_only_on_improvement(which, tmp_path,
                                                monkeypatch):
    cfg = _cfg(which, tmp_path, save_step_minor=0)
    tr = _trainer(which, cfg)
    cers = iter([0.5, 0.7, 0.3])
    monkeypatch.setattr(tr, "validate",
                        lambda batches, n: {"val_CER": next(cers)})
    saved = []
    real = ckpt.save_checkpoint
    monkeypatch.setattr(ckpt, "save_checkpoint", lambda d, name, obj, meta:
                        saved.append((name, meta["iteration"]))
                        or real(d, name, obj, meta))
    tr.train(BATCHES, iterations=3, val_every=1, valid=[{}])
    assert saved == [("model_best", 1), ("model_best", 3)]
    run = str(tmp_path / cfg.name)
    meta = ckpt.load_meta(run, "model_best")
    assert meta["monitor_value"] == 0.3 and meta["iteration"] == 3
    assert set(ckpt.load_checkpoint(run, "model_best")) == {"model"}
    assert ckpt.CheckpointManager(run).best == 0.3


@pytest.mark.parametrize("which", ["auto", "hwr"])
def test_sigint_saves_latest_and_stops(which, tmp_path):
    cfg = _cfg(which, tmp_path, save_step_minor=0)
    tr = _trainer(which, cfg)

    def batches():
        yield BATCHES[0]
        signal.raise_signal(signal.SIGINT)       # during step 2's batch
        yield BATCHES[1]
        yield BATCHES[2]
    before = signal.getsignal(signal.SIGINT)
    log = tr.train(batches(), iterations=4)
    assert tr.step == 2 and [e["iteration"] for e in log.entries] == [1, 2]
    assert signal.getsignal(signal.SIGINT) is before
    run = str(tmp_path / cfg.name)
    meta = ckpt.load_meta(run, "checkpoint-latest")
    assert meta["interrupted"] is True and meta["iteration"] == 2
    assert ckpt.load_checkpoint(run, "checkpoint-latest")["step"] == 2
    with open(tmp_path / cfg.name / "train_log.json") as f:
        assert [e["iteration"] for e in json.load(f)] == [1, 2]


def test_auto_train_validates_in_loop(tmp_path):
    cfg = _cfg("auto", tmp_path)
    tr = _trainer("auto", cfg)
    entries = []
    tr.train(BATCHES[:2], iterations=2, val_every=2,
             valid=_Batcher(BATCHES[2:]), val_batches=1,
             on_log=entries.append)
    assert [set(e) >= {"loss", "autoLoss", "recogLoss"}
            for e in entries[:2]] == [True, True]
    val = entries[2]
    assert set(val) == {"val_autoLoss", "val_recogLoss", "val_CER"}
    assert all(np.isfinite(v) for v in val.values())
    assert ckpt.CheckpointManager(str(tmp_path / cfg.name)).best == \
        val["val_CER"]
