"""The port's FLOP and byte counter (``flops.py``) against the JAX package's
jaxprs, and the report and profiles built on it, on the CPU.

The JAX sides are traced with ``jax.make_jaxpr`` (no compile), their state
abstract (``jax.eval_shape``); a jaxpr's count is 2·MAC of every
``conv_general_dilated`` (``2 x output elements x kernel taps x rhs input
features``) and ``dot_general`` (``2 x output elements x contracted
size``), inside nested jaxprs too.  Two operations are written as a
contraction in one package and not in the other, and the comparison names
them:

* the final 1x1 equal conv with the last block's AdaIN folded in: the JAX
  layer contracts it as a broadcast multiply and a ``reduce_sum``
  (``models/layers.py:206-212``), the port as an ``einsum``; the jaxpr
  count adds that multiply-and-reduce (a ``reduce_sum`` of a 5-D product);
* a product against a one-hot operand (the CTC and Viterbi emissions
  ``logp · onehot(ext)ᵀ``): a ``dot_general`` in JAX, a gather in the port;
  the jaxpr count leaves it out.

So the forwards must count equal exactly.  Forward and backward are held
within ``LESSON_RTOL`` (see its note).
"""

import ast
import dataclasses
import json
import math
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import threadpoolctl
import torch

from handwriting_line_generation_tpu.models.hw_with_style import \
    HWWithStyle as JHWWithStyle
from handwriting_line_generation_tpu.ops.augment import \
    dequantize_image as j_dequantize
from handwriting_line_generation_tpu.ops.ctc import \
    mask_frames_to_blank as j_mask
from handwriting_line_generation_tpu.training.gan_trainer import \
    GanTrainer as JGanTrainer
from handwriting_line_generation_tpu.training.losses import \
    gen_adv_loss as j_gen_adv_loss
from handwriting_line_generation_tpu.training.train_state import \
    create_gan_state as j_create_gan_state
from handwriting_line_generation_tpu_torch import flops
from handwriting_line_generation_tpu_torch.config import config_from_dict
from handwriting_line_generation_tpu_torch.init import (
    init_autoencoder_params, init_model, init_params, init_spectral,
)
from handwriting_line_generation_tpu_torch.ops.augment import \
    dequantize_image
from handwriting_line_generation_tpu_torch.ops.ctc import \
    mask_frames_to_blank
from handwriting_line_generation_tpu_torch.scripts import mfu_report
from handwriting_line_generation_tpu_torch.training.gan_trainer import \
    GanTrainer
from handwriting_line_generation_tpu_torch.training.losses import \
    gen_adv_loss
from test_trainers import _tiny_gan_cfg

REPO = pathlib.Path(__file__).resolve().parents[1]
B, W, L, A = 4, 96, 12, 2          # lines, width, label length, per author
# forward + backward of the auto lesson: the two autodiffs differentiate the
# same forward into different operations.  The port's head einsum takes two
# batched products in each of the lesson's three VJPs (JAX: elementwise);
# JAX's one-hot emission products and their transposes are dots (port:
# gathers and scatters); and the two choose differently which input
# gradients of the frozen parts to form.  Measured: the port 0.29% above
# the jaxpr at these shapes
LESSON_RTOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port on one torch thread and one BLAS thread (several test
    processes share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


def _producers(jaxpr):
    return {v: e for e in jaxpr.eqns for v in e.outvars}


def _one_hot(var, made) -> bool:
    """``var`` is ``jax.nn.one_hot``'s output: a conversion of an ``eq``
    against an ``iota``."""
    e = made.get(var)
    while e is not None and e.primitive.name in ("convert_element_type",
                                                 "broadcast_in_dim"):
        e = made.get(e.invars[0])
    if e is not None and e.params.get("name") in ("one_hot", "_one_hot"):
        return True                  # jax.nn.one_hot, jitted
    return e is not None and e.primitive.name == "eq" and any(
        made.get(v) is not None and made[v].primitive.name == "iota"
        for v in e.invars if not isinstance(v, jax.core.Literal))


def jaxpr_flops(jaxpr) -> int:
    """2·MAC over a jaxpr's contractions (see the module's note)."""
    made, total = _producers(jaxpr), 0
    for e in jaxpr.eqns:
        name = e.primitive.name
        if name == "conv_general_dilated":
            rhs = e.invars[1].aval.shape
            spec = e.params["dimension_numbers"].rhs_spec
            total += (2 * math.prod(e.outvars[0].aval.shape)
                      * math.prod(rhs[i] for i in spec[2:]) * rhs[spec[1]])
        elif name == "dot_general":
            if not any(_one_hot(v, made) for v in e.invars):
                (lc, _), _ = e.params["dimension_numbers"]
                total += (2 * math.prod(e.outvars[0].aval.shape)
                          * math.prod(e.invars[0].aval.shape[i] for i in lc))
        elif name == "reduce_sum":
            src = made.get(e.invars[0])
            if (src is not None and src.primitive.name == "mul"
                    and len(src.outvars[0].aval.shape) == 5):
                total += 2 * math.prod(src.outvars[0].aval.shape)
        for p in e.params.values():
            for sub in (p if isinstance(p, (list, tuple)) else [p]):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    total += jaxpr_flops(inner)
    return total


def _port_flops(fn, *args, **kwargs) -> int:
    with flops.Counter() as c:
        fn(*args, **kwargs)
    return c.flops


# -- the conventions on single operations -------------------------------------


CONVS = [  # (x, w, torch call, jax call)
    ((2, 5, 9, 11), (7, 5, 3, 3),
     lambda x, w: torch.nn.functional.conv2d(x, w, stride=2, padding=1),
     lambda x, w: jax.lax.conv_general_dilated(
         x, w, (2, 2), ((1, 1), (1, 1)),
         dimension_numbers=("NCHW", "OIHW", "NCHW"))),
    ((2, 5, 9, 11), (5, 7, 4, 4),
     lambda x, w: torch.nn.functional.conv_transpose2d(x, w, stride=2,
                                                       padding=1),
     lambda x, w: jax.lax.conv_transpose(
         x, w, (2, 2), ((2, 2), (2, 2)),
         dimension_numbers=("NCHW", "IOHW", "NCHW"))),
    ((2, 5, 9, 11), (5, 1, 3, 3),
     lambda x, w: torch.nn.functional.conv2d(x, w, padding=1, groups=5),
     lambda x, w: jax.lax.conv_general_dilated(
         x, w, (1, 1), "SAME", dimension_numbers=("NCHW", "OIHW", "NCHW"),
         feature_group_count=5)),
    ((3, 6), (6, 4), lambda x, w: x @ w, lambda x, w: x @ w),
]


@pytest.mark.parametrize("case", CONVS,
                         ids=["strided", "transposed", "depthwise", "mm"])
@pytest.mark.parametrize("grad", [False, True], ids=["forward", "backward"])
def test_single_op_counts_equal_jax(case, grad):
    """A strided, a transposed and a depthwise convolution and a matrix
    product, forward and forward + backward: the port's count equals the
    jaxpr's exactly (the transposed conv's dilation zeros and the strided
    conv's dilated input gradient included)."""
    xs, ws, pt, jx = case
    rng = np.random.default_rng(0)
    x, w = rng.normal(size=xs), rng.normal(size=ws)
    f = lambda x, w: jnp.sum(jnp.sin(jx(x, w)))
    want = jaxpr_flops(jax.make_jaxpr(jax.grad(f, (0, 1)) if grad else f)(
        x.astype(np.float32), w.astype(np.float32)).jaxpr)
    xt, wt = (torch.tensor(a, dtype=torch.float32, requires_grad=grad)
              for a in (x, w))

    def run():
        y = torch.sin(pt(xt, wt)).sum()
        if grad:
            y.backward()
    assert _port_flops(run) == want > 0


def test_byte_counter_hand_count():
    """``y = x * 2; z = y + x`` on 10 float32s: ``mul`` reads x and writes
    y (80 B), ``add`` reads y and x and writes z (120 B); a view moves
    nothing."""
    with flops.Counter() as c:
        x = torch.ones(10)
        y = x * 2
        z = y + x.view(10)
    assert z.shape == (10,)
    assert dict(c.bytes_by_op) == {"aten.ones": 40, "aten.mul": 80,
                                   "aten.add": 120}
    assert c.bytes == 240 and c.flops == 0


# -- the model's forwards and the auto lesson --------------------------------


def _cfgs():
    jcfg = _tiny_gan_cfg()
    return jcfg, config_from_dict(dataclasses.asdict(jcfg))


def _lines():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 256, (B, 64, W, 1)).astype(np.uint8),
            rng.integers(1, 80, (B, L)).astype(np.int32),
            np.full((B,), L, np.int32), rng.random((B, 64, W, 1)) > 0.5,
            np.full((B,), W, np.int32))


def test_generation_forward_counts_equal_jax():
    """Spacer, ``insert_spaces`` and the generator (``HWWithStyle
    .generate``) at the tiny GAN's widths, 2 lines at 48 spaced
    positions: equal counts."""
    jcfg, pcfg = _cfgs()
    rng = np.random.default_rng(1)
    lab = rng.integers(1, 80, (2, L)).astype(np.int32)
    lens = np.full((2,), L, np.int32)
    style = rng.normal(size=(2, pcfg.model.packed_style_dim())).astype(
        np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, init_params(pcfg.model, 0))
    jm = JHWWithStyle(jcfg.model)
    want = jaxpr_flops(jax.make_jaxpr(lambda p, l, n, s: jm.apply(
        {"params": p}, l, n, s, jax.random.PRNGKey(0), spaced_len=48,
        method="generate", rngs={"noise": jax.random.PRNGKey(1)})[0])(
        params, lab, lens, style).jaxpr)
    model = init_model(pcfg.model, 0)
    with torch.no_grad():
        got = _port_flops(model.generate, torch.from_numpy(lab),
                          torch.from_numpy(lens), torch.from_numpy(style),
                          spaced_len=48,
                          generator=torch.Generator().manual_seed(0))
    assert got == want > 0


@pytest.fixture(scope="module")
def lesson():
    """The JAX trainer on an abstract state, the port's trainer, a
    batch."""
    jcfg, pcfg = _cfgs()
    params, spectral = init_params(pcfg.model, 0), init_spectral(pcfg.model,
                                                                  0)
    jt = JGanTrainer(jcfg)
    jt.encoder_params = {"params": jax.tree_util.tree_map(
        jnp.asarray, init_autoencoder_params("2tight", 0, seed=1)["params"]
        ["encoder"])}

    def state():
        st, *txs = j_create_gan_state(
            jcfg, {"params": jax.tree_util.tree_map(jnp.asarray, params),
                   "spectral": jax.tree_util.tree_map(jnp.asarray,
                                                      spectral)},
            jax.random.PRNGKey(1))
        jt.main_tx, jt.disc_tx, jt.gen_only_tx, jt.style_ex_tx = txs
        return st
    pt = GanTrainer(pcfg, device="cpu")
    pt.init_state(seed=0)
    return jt, jax.eval_shape(state), pt, _lines()


def test_auto_lesson_forward_counts_equal_jax(lesson):
    """The auto lesson's forward: ``autoencode`` (style extraction with its
    recognizer and Viterbi, spacer, generator), the fg-masked L1 and the
    perceptual encoder on the line and its reconstruction, the
    discriminator, the recognizer and CTC on the reconstruction: equal
    counts."""
    jt, state, pt, (img, lab, lens, fg, width) = lesson

    def jfwd(p, spectral, img, lab, lens, fg, width):
        image = j_dequantize(img, width)
        frames = jnp.clip(jnp.ceil(width / 4.0).astype(jnp.int32), 1,
                          W // 4)
        recon, _ = jt.model.apply(
            {"params": p}, image, lab, lens, A, method="autoencode",
            rngs={"noise": jax.random.PRNGKey(0)}, frame_lengths=frames)
        f = fg.astype(jnp.float32)
        main = (jnp.mean(jnp.abs(recon * f - image * f))
                + jt._perceptual(image, recon))
        adv = j_gen_adv_loss(jt._apply(p, spectral, "discriminate",
                                       recon)[0])
        logp = j_mask(jt.model.apply({"params": p}, recon,
                                     method="recognize"), frames)
        return main, adv, jt._ctc(logp, lab, lens, 1.0)
    want = jaxpr_flops(jax.make_jaxpr(jfwd)(
        state.params, state.spectral, img, lab, lens, fg, width).jaxpr)

    def pfwd():
        t = torch.as_tensor
        wd = t(width)
        image = dequantize_image(t(img), wd)
        frames = torch.clamp(torch.ceil(wd / 4.0).long(), 1, W // 4)
        recon, _ = pt.model.autoencode(
            image, t(lab), t(lens), A, frame_lengths=frames,
            generator=torch.Generator().manual_seed(0))
        f = t(fg).float()
        ((recon * f - image * f).abs().mean()
         + pt._perceptual(image, recon))
        gen_adv_loss(pt.model.discriminate(recon))
        logp = mask_frames_to_blank(pt.model.recognize(recon), frames)
        pt._ctc(logp, t(lab), t(lens), 1.0)
    with torch.no_grad():
        got = _port_flops(pfwd)
    assert got == want > 0


def test_auto_lesson_counts_within_jax(lesson):
    """The whole auto lesson, forward and the backward it runs (three VJPs
    of the autoencode, the balanced merge, the Adam step): the port's
    ``step_auto`` against JAX's ``GanTrainer.step_auto`` within
    ``LESSON_RTOL``."""
    jt, state, pt, (img, lab, lens, fg, width) = lesson
    want = jaxpr_flops(jax.make_jaxpr(
        lambda st, *a: JGanTrainer.step_auto(jt, st, *a, A, "main", 0,
                                             None))(
        state, img, lab, lens, fg, width).jaxpr)
    got = _port_flops(pt.step_auto, img, lab, lens, fg, width, A)
    assert abs(got - want) <= LESSON_RTOL * want, (got, want)


# -- the report and the profiles ----------------------------------------------


def _jax_report_keys():
    """The keys the repo-root ``scripts/mfu_report.py`` writes into its
    report (its ``report`` dict literal and ``report[...] =``)."""
    tree = ast.parse((REPO / "scripts" / "mfu_report.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "report"
                        for t in node.targets)):
            keys |= {k.value for k in node.value.keys}
        if (isinstance(node, ast.Subscript)
                and getattr(node.value, "id", None) == "report"
                and isinstance(node.slice, ast.Constant)):
            keys.add(node.slice.value)
    return keys


def test_report_has_the_jax_keys(tmp_path):
    """``mfu_report`` on the CPU at the tiny GAN's widths (one author pair
    of lines 96 wide, generated lines at 24 spaced positions, 2 lines
    generated): every key
    of the JAX report, finite positive counts and rates, MFU against the
    datasheet peak of the step's precision; no kernel launches on the
    CPU."""
    jcfg, _ = _cfgs()
    config = tmp_path / "tiny_gan.json"
    config.write_text(json.dumps(dataclasses.asdict(jcfg)))
    rep = mfu_report.report(
        str(config), [f"trainer.save_dir={tmp_path}", "data.batch_size=1",
                      "data.width_buckets=[96]", "model.max_gen_length=24"],
        iters=1, gen_batch=2, device="cpu")
    want = _jax_report_keys()
    assert len(want) >= 20 and want <= set(rep), want - set(rep)
    for k in ("auto_step_gflops", "lessons_per_sec", "auto_sec_per_step",
              "auto_achieved_tflops", "auto_mfu", "gen_step_gflops",
              "gen_lines_per_sec", "gen_mfu", "gen_bytes_accessed_gb",
              "gen_arith_intensity_flop_per_byte", "gen_achieved_hbm_gbps"):
        assert np.isfinite(rep[k]) and rep[k] > 0, k
    assert rep["batch"] == A and rep["image_w"] == 96
    assert rep["peak_tflops"] == flops.PEAK_TFLOPS["float32"]
    assert rep["gen_peak_tflops"] == flops.PEAK_TFLOPS["bfloat16"]
    assert rep["auto_mfu"] == pytest.approx(
        rep["auto_achieved_tflops"] / rep["peak_tflops"])
    assert rep["ctc_launches_per_auto_lesson"] == 0
    assert rep["gen_epilogue_launches_per_forward"] == 0
    assert rep["card"] is None and rep["device"] == "cpu"
