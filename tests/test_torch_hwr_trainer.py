"""Port parity for HWR training: the port's ``HWRTrainer`` against the JAX
trainer from the same weights and batch (augmentation off, float32), the
LR schedules, greedy decoding, error rates and the ``train`` loop."""

import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from handwriting_line_generation_tpu.charset import (
    IAM_CHARSET as J_CHARSET, collapse_argmax_batch as j_collapse,
    ctc_greedy_decode_batch as j_decode,
)
from handwriting_line_generation_tpu.config import load_config as j_load
from handwriting_line_generation_tpu.ops.augment import \
    dequantize_image as j_dequantize
from handwriting_line_generation_tpu.ops.ctc import (
    ctc_loss_fast as j_ctc_fast, mask_frames_to_blank as j_mask,
)
from handwriting_line_generation_tpu.training.hwr_trainer import (
    HWRState, HWRTrainer as JHWRTrainer,
)
from handwriting_line_generation_tpu.training.train_state import \
    make_lr_schedule as j_schedule
from handwriting_line_generation_tpu.utils.error_rates import \
    batch_cer_wer as j_cer_wer
from handwriting_line_generation_tpu_torch.charset import (
    IAM_CHARSET, collapse_argmax_batch, ctc_greedy_decode_batch,
)
from handwriting_line_generation_tpu_torch.config import load_config
from handwriting_line_generation_tpu_torch.convert import convert_hwr_params
from handwriting_line_generation_tpu_torch.init import init_hwr_params
from handwriting_line_generation_tpu_torch.training.hwr_trainer import \
    HWRTrainer
from handwriting_line_generation_tpu_torch.training.train_state import \
    make_lr_schedule
from handwriting_line_generation_tpu_torch.utils.error_rates import \
    batch_cer_wer
from test_torch_threads import one_thread  # noqa: F401 (autouse)

CONFIG = pathlib.Path(__file__).resolve().parents[1] / "configs/iam_hwr.json"
B, W, L = 2, 64, 6
LR = 1e-3                            # configs/iam_hwr.json
STEPS = 3


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, (B, 64, W, 1)).astype(np.uint8)
    label_lengths = np.array([L, 3], np.int32)
    label = np.zeros((B, L), np.int32)
    for b in range(B):
        label[b, :label_lengths[b]] = rng.integers(1, 80, label_lengths[b])
    width = np.array([W, 40], np.int32)
    return image, label, label_lengths, width


def _trainers(tree):
    jcfg, tcfg = j_load(str(CONFIG)), load_config(str(CONFIG))
    jcfg.data.augmentation = tcfg.data.augmentation = None
    jt = JHWRTrainer(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = HWRState(step=jnp.zeros((), jnp.int32), params=params,
                     opt_state=jt.tx.init(params),
                     rng=jax.random.PRNGKey(1))
    pt = HWRTrainer(tcfg, device="cpu")
    pt.init_state(seed=0, params=tree)
    return jt, state, pt


def _jax_grads(jt, params, image, label, label_lengths, width):
    """The gradient the JAX train step takes, with augmentation off."""
    def loss_fn(p):
        logp = jt.model.apply(p, j_dequantize(image, width))
        frames = jnp.clip(jnp.ceil(width / 4.0).astype(jnp.int32), 1,
                          logp.shape[1])
        return j_ctc_fast(j_mask(logp, frames), label, label_lengths)
    return jax.grad(loss_fn)(params)


def _flat_jax(tree):
    """JAX tree leaves keyed by the port's state_dict names."""
    return convert_hwr_params(jax.tree_util.tree_map(np.asarray, tree))


@pytest.mark.compile
def test_hwr_trajectory_matches_jax():
    tree = init_hwr_params(load_config(str(CONFIG)).model.hwr,
                           J_CHARSET.num_class, seed=0)
    jt, state, pt = _trainers(tree)
    batch = _batch()
    jbatch = [jnp.asarray(a) for a in batch]

    g_want = _flat_jax(_jax_grads(jt, state.params, *jbatch))
    for step in range(STEPS):
        state, out = jt.train_step(state, *jbatch)
        loss, logp = pt.train_step(*batch)
        # a float32 forward of 11 convs and the CTC recursion, summed in
        # other orders: losses agree to ~1e-6 relative
        np.testing.assert_allclose(float(loss), float(out["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(logp.numpy(), np.asarray(out["logp"]),
                                   rtol=0.0, atol=1e-4)
        if step == 0:
            # step-1 gradients, against each tensor's largest entry: the
            # backward sums convs of up to 4608 terms in other orders
            for name, p in pt.model.named_parameters():
                want = g_want[name].numpy()
                scale = np.abs(want).max()
                np.testing.assert_allclose(p.grad.numpy(), want, rtol=0.0,
                                           atol=1e-3 * scale, err_msg=name)

    # Adam's first updates are lr * g / (|g| + eps): a gradient entry near
    # zero becomes about +-lr, so a coordinate whose tiny gradient differs
    # in sign between the two frameworks may differ by up to 2 * lr per
    # step.  Bound every parameter by that worst case, and the mean by a
    # small fraction of one lr.
    p_want = _flat_jax(state.params)
    diffs = []
    for name, p in pt.model.named_parameters():
        d = np.abs(p.detach().numpy() - p_want[name].numpy())
        assert d.max() <= 2 * LR * STEPS + 1e-6, (name, d.max())
        diffs.append(d.ravel())
    assert np.concatenate(diffs).mean() <= 0.01 * LR


@pytest.mark.parametrize("kind", ["none", "warmup", "cyclic", "cyclic-full",
                                  "1cycle", "rampup", "LR_test"])
def test_lr_schedules_match_jax(kind):
    want = j_schedule(kind, LR, 1000, warmup_steps=10, cycle_size=4)
    got = make_lr_schedule(kind, LR, 1000, warmup_steps=10, cycle_size=4)
    for step in range(6):
        w = want if not callable(want) else float(want(jnp.asarray(step)))
        # JAX evaluates the schedule in float32: a few float32 ulps of the
        # base lr (cyclic's cycle end is 1 - 0.999, which cancels)
        np.testing.assert_allclose(got(step), w, rtol=1e-6, atol=1e-7 * LR)


def test_greedy_decode_and_error_rates_match_jax():
    rng = np.random.default_rng(2)
    logp = rng.standard_normal((3, 30, J_CHARSET.num_class)).astype(
        np.float32)
    logp[:, ::3, 0] += 4.0                     # blanks between characters
    logp[1, 5:9, 7] += 9.0                     # a repeated run
    preds = ctc_greedy_decode_batch(logp, IAM_CHARSET)
    assert preds == j_decode(logp, J_CHARSET)
    arg = logp.argmax(-1)
    assert collapse_argmax_batch(arg, IAM_CHARSET) == j_collapse(arg,
                                                                 J_CHARSET)
    gts = ["the cat  sat", "", "Hello World"]
    for cs in (True, False):
        assert batch_cer_wer(gts, preds, cs) == j_cer_wer(gts, preds, cs)
    assert batch_cer_wer(["abc"], ["abd"]) == (1 / 3, 1.0)


def test_train_loop_logs_loss_and_cer(tmp_path):
    cfg = load_config(str(CONFIG))
    cfg.data.augmentation = "warp"
    cfg.trainer.save_dir = str(tmp_path)
    tr = HWRTrainer(cfg, device="cpu")
    tr.init_state(seed=0)
    image, label, label_lengths, width = _batch(3)
    batch = dict(image=image, label=label, label_lengths=label_lengths,
                 width=width, gt=["abcdef", "xyz"])
    entries = []
    log = tr.train([batch, batch], iterations=5, log_every=1,
                   on_log=entries.append)
    assert [e["iteration"] for e in entries] == [1, 2] and tr.step == 2
    for e in entries:
        assert np.isfinite(e["loss"]) and 0.0 <= e["CER"]
    assert log.entries == entries
    val = tr.validate([dict(batch, image=np.array(j_dequantize(
        jnp.asarray(image), jnp.asarray(width))))])
    assert np.isfinite(val["val_loss"]) and val["val_CER"] >= 0.0
