"""Port parity for GAN training: the port's ``GanTrainer`` against the JAX
``GanTrainer`` over one paper-curriculum cycle (count; no-step gen; auto
auto-gen; disc; the last three again) at ``test_trainers._tiny_gan_cfg``'s
shapes, and the gradients of the modules the lessons train.

Both trainers start from the same weights (the port's seeded init with
every bias and norm scale jittered, the discriminator's ``u``'s, a seeded
perceptual encoder) and read the same batches.  The JAX steps run as they
are, jitted (compiled ahead, in parallel threads); every random draw of a
step is recomputed from the JAX state's key the way the step splits it (``bank_sample``'s and
``insert_spaces``' draws), and the generator's noise planes are recorded by
intercepting ``NoiseInjection`` in an apply that derives its ``noise``
stream from the same key, then all of them are injected into the port.

Tolerances:
* losses: the first lesson within rtol 1e-5, later ones within 1e-3 on the
  trajectory, except the adversarial losses, held within ``ADV_ATOL``
  there (see its note); every loss within rtol 1e-4 from the same state;
* gradients from the same state (JAX's updates are read back from its Adam
  first moments): the count update within 1e-3 of each tensor's largest
  entry in float32.  The other groups cross leaky-relu and max-pool kinks:
  where an input lies within the packages' ~1e-6 float32 difference of a
  kink, its slope differs between them, and one such element moves a
  tensor's gradient by up to a few percent of its largest entry (measured:
  one sign flip in the generator's block 2 and one in block 4 of the
  genRecog group, 3.7e-2 of the max; the same gradients in float64 agree
  to 5e-8).  So in float32 each of those groups is held within
  ``KINK_L2`` in relative L2 over all its tensors (measured up to 1.3e-2),
  and the float64 tests hold within 1e-3 of each tensor's max the gen
  lesson's two groups (the generator's VJP of its image cotangents), the
  disc lesson's gradients (real then fake, the ``u``'s advancing), the
  auto lesson's main, adversarial and reconRecog groups and their merge,
  and ``extract_style`` (the recognizer's max pools) alone;
* parameters after the cycle within 2·lr·(that optimizer's steps) + 1e-6,
  each step counted at Adam's largest step for its betas (1 lr at the
  first, 1.054 lr at the second for (0.5, 0.999): ``_adam_step_bound``):
  a near-zero gradient of opposite sign costs up to two steps' worth;
  the style bank within 1e-3 of each tensor's largest entry, the ``u``'s
  within ``U_TRAJECTORY_RTOL`` (see its note);
* the generator's and ``CountCNN``'s parameter gradients at B = 2 within
  1e-3 of each tensor's largest entry in float32.
"""

import contextlib
import dataclasses
import itertools
import multiprocessing
import threading

import numpy as np
import jax
import jax._src.lax.convolution as j_convolution
import jax.numpy as jnp
import pytest
import torch
from flax import linen as nn

import handwriting_line_generation_tpu.models.autoencoder as j_autoencoder
import handwriting_line_generation_tpu.models.char_style as j_char_style
import handwriting_line_generation_tpu.models.count_cnn as j_count_cnn
import handwriting_line_generation_tpu.models.discriminator as j_disc
import handwriting_line_generation_tpu.models.generator as j_generator
import handwriting_line_generation_tpu.models.hw_with_style as j_hws
import handwriting_line_generation_tpu.models.hwr as j_hwr
import handwriting_line_generation_tpu.models.layers as j_layers
import handwriting_line_generation_tpu.ops.align as j_align
import handwriting_line_generation_tpu.ops.spacing as j_spacing
import handwriting_line_generation_tpu.training.gan_trainer as j_gan_trainer
from handwriting_line_generation_tpu.data.datasets import quantize_image_u8
from handwriting_line_generation_tpu.models.count_cnn import \
    CountCNN as JCountCNN
from handwriting_line_generation_tpu.models.generator import \
    SpacedGenerator as JSpacedGenerator
from handwriting_line_generation_tpu.models.hw_with_style import \
    HWWithStyle as JHWWithStyle
from handwriting_line_generation_tpu.models.layers import \
    NoiseInjection as JNoiseInjection
from handwriting_line_generation_tpu.ops.augment import \
    dequantize_image as j_dequantize_image
from handwriting_line_generation_tpu.ops.ctc import \
    mask_frames_to_blank as j_mask_frames_to_blank
from handwriting_line_generation_tpu.training.gan_trainer import \
    GanTrainer as JGanTrainer
from handwriting_line_generation_tpu.training.losses import \
    disc_hinge_loss as j_disc_hinge_loss
from handwriting_line_generation_tpu.training.losses import \
    gen_adv_loss as j_gen_adv_loss
from handwriting_line_generation_tpu.training.train_state import (
    balance_and_merge as j_balance_and_merge,
    multipliers_at as j_multipliers_at,
)
from handwriting_line_generation_tpu.training.train_state import \
    create_gan_state as j_create_gan_state
from handwriting_line_generation_tpu_torch.config import (
    ModelConfig, config_from_dict,
)
from handwriting_line_generation_tpu_torch.convert import (
    convert_autoencoder_params, convert_params,
)
from handwriting_line_generation_tpu_torch.init import (
    init_autoencoder_params, init_params, init_spectral,
)
from handwriting_line_generation_tpu_torch.models.count_cnn import CountCNN
from handwriting_line_generation_tpu_torch.models.generator import \
    SpacedGenerator
from handwriting_line_generation_tpu_torch.models.hw_with_style import \
    HWWithStyle
from handwriting_line_generation_tpu_torch.ops.ctc import \
    mask_frames_to_blank
from handwriting_line_generation_tpu_torch.training import \
    gan_trainer as p_gan_trainer
from handwriting_line_generation_tpu_torch.training.gan_trainer import \
    GanTrainer
from handwriting_line_generation_tpu_torch.training.losses import \
    gen_adv_loss
from handwriting_line_generation_tpu_torch.utils.checkpoint import \
    extract_subtree
from test_trainers import _tiny_gan_cfg

pytestmark = pytest.mark.compile   # the JAX steps' compiles dominate

B, W, L = 4, 192, 12
GRAD_RTOL = 1e-3
KINK_L2 = 3e-2
STATE_RTOL = 1e-3
# a u after the cycle is the power iteration's estimate on discriminator
# weights that differ within the Adam bound: measured 1.3e-3 of its
# largest entry (from the same state the u's agree to 1e-6)
U_TRAJECTORY_RTOL = 5e-3
LOSS_RTOL = {"first": 1e-5, "later": 1e-3, "same state": 1e-4}
# on the trajectory, the discriminator's scores move with its weights'
# Adam sign-flip differences (up to 2 lr a step, ~1e-3 after two steps),
# and the adversarial losses are means of those scores, some near 0:
# measured 1.9e-3 (discriminatorLoss ~2.0) and 2.3e-4 (generatorLoss
# ~8e-3, 2.3% of it)
ADVERSARIAL = ("generatorLoss", "autoGenLoss", "discriminatorLoss")
ADV_ATOL = 5e-3
# the float64 JAX sides compile without LLVM's optimizations: half the
# compile time (the auto lesson's: 39 s -> 21 s on CPU), as fast a run
F64_COMPILE = {"xla_backend_optimization_level": 0}


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    if scale == 0:
        return np.abs(got).max()
    return np.abs(got - want).max() / scale


def _jitter(tree, rng):
    """Every bias and norm scale moved by N(0, 0.05²)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _jitter(v, rng)
        elif k in ("bias", "scale"):
            out[k] = (v + 0.05 * rng.normal(size=v.shape)).astype(np.float32)
        else:
            out[k] = v
    return out


def _batches(n, seed=0):
    """Float lines from u8 pixels (exact under u8 transfer), labels,
    widths, 2 lines per author, fg masks."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lens = rng.integers(3, L + 1, B).astype(np.int32)
        label = np.zeros((B, L), np.int32)
        for b in range(B):
            label[b, :lens[b]] = rng.integers(1, 80, lens[b])
        px = rng.integers(0, 256, (B, 64, W, 1)).astype(np.float32)
        out.append(dict(image=1.0 - px / 128.0, label=label,
                        label_lengths=lens,
                        width=rng.integers(W // 2, W + 1, B).astype(np.int32),
                        gt=["x"] * B, a_batch_size=2,
                        fg_mask=rng.random((B, 64, W, 1)).astype(np.float32)))
    return out


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _is_masked(g):
    return type(g).__name__ == "MaskedNode"


def _masked_as_none(tree):
    return jax.tree_util.tree_map(
        lambda g: None if _is_masked(g) else g, tree, is_leaf=_is_masked)


def _slim(state, hwr):
    """A numpy copy of a JAX train state without the frozen recognizer's
    leaves (they never move: checked against ``hwr``; their saved
    gradients are zero: checked) and with only the first moments of the
    optimizers' stepped partitions."""
    opt = lambda o, part: _masked_as_none(
        o[1].inner_states[part].inner_state[0].mu)
    st = _np(state.replace(opt_main=opt(state.opt_main, "main"),
                           opt_disc=opt(state.opt_disc, "disc")))
    for a, b in zip(jax.tree_util.tree_leaves(st.params.pop("hwr")),
                    jax.tree_util.tree_leaves(hwr)):
        assert np.array_equal(a, b)
    for tree in (st.saved_recog, st.saved_adv):
        assert not any(a.any() for a in
                       jax.tree_util.tree_leaves(tree.pop("hwr")))
    return st


class _JaxRun:
    """The JAX cycle, and what each lesson saw and left."""

    def __init__(self):
        ctx = multiprocessing.get_context("spawn")
        self.auto64, child_end = ctx.Pipe()
        self.child = ctx.Process(target=_auto64_child, args=(child_end,),
                                 daemon=True)
        self.child.start()
        child_end.close()
        self._auto64 = None
        jcfg = _tiny_gan_cfg()
        self.jcfg = jcfg
        self.pcfg = config_from_dict(dataclasses.asdict(jcfg))
        rng = np.random.default_rng(7)
        self.params = _jitter(init_params(self.pcfg.model, seed=0), rng)
        self.spectral = init_spectral(self.pcfg.model, seed=0)
        enc = _jitter(init_autoencoder_params("2tight", 0, seed=1)["params"]
                      ["encoder"], rng)
        self.enc = enc
        self.encoder_state = extract_subtree(
            convert_autoencoder_params({"encoder": enc}), "encoder")
        tr = JGanTrainer(jcfg)
        tr.encoder_params = {"params": enc}
        (tr.state, tr.main_tx, tr.disc_tx, tr.gen_only_tx,
         tr.style_ex_tx) = j_create_gan_state(
            jcfg, {"params": jax.tree_util.tree_map(jnp.asarray, self.params),
                   "spectral": jax.tree_util.tree_map(jnp.asarray,
                                                      self.spectral)},
            jax.random.PRNGKey(1))
        self.tr = tr
        self.interp = (tr.interp_low, tr.interp_high)
        self.gen_spaced_len = tr.gen_spaced_len
        self.batches = _batches(5)
        self.lessons = [tr.curriculum.get_lesson(i) for i in range(7)]
        self.noise_fns = {}
        self.records = []
        hwr = self.params["hwr"]
        self.compile_ahead()
        it = iter(self.batches)
        before = _slim(tr.state, hwr)
        for i, lesson in enumerate(self.lessons):
            kind = next(k for k in ("count", "gen", "auto", "disc")
                        if k in lesson)
            labels = None
            if kind == "gen":
                st = tr.text.rng.bit_generator.state
                labels = tr.text.get_batch(label_len=L)
                tr.text.rng.bit_generator.state = st
            draws = self.draws(kind, tr.state)
            if i == 2:
                self.auto64.send(self._auto64_request(before, draws))
            out = jax.device_get(tr.run_lesson(lesson, it, iteration=i))
            after = _slim(tr.state, hwr)
            self.records.append(dict(kind=kind, before=before, after=after,
                                     out=out, draws=draws, labels=labels))
            before = after
        self.tr = self.noise_fns = None

    def full(self, params):
        """Slimmed params with the recognizer's leaves back."""
        return {**params, "hwr": self.params["hwr"]}

    def _auto64_request(self, st, draws):
        """The inputs of the first auto lesson's float64 groups, in
        float64: the state before it (the recognizer's saved groups are
        zero), its line dequantized as the step does, frames, fg mask and
        noise planes; the line and frames are kept for the test."""
        b = self.batches[1]
        image = np.asarray(j_dequantize_image(
            jnp.asarray(quantize_image_u8(b["image"])),
            jnp.asarray(b["width"])), np.float64)
        frames = np.clip(np.ceil(b["width"] / 4.0), 1, W // 4).astype(
            np.int32)
        self.auto64_inputs = dict(image=image, frames=frames)
        f64 = lambda t: jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), t)
        hwr0 = jax.tree_util.tree_map(np.zeros_like, self.params["hwr"])
        return (f64(self.full(st.params)), f64(st.spectral), f64(self.enc),
                image, b["label"], b["label_lengths"], frames,
                (b["fg_mask"] > 0.5).astype(np.float64), f64(draws["noise"]),
                *(f64({**getattr(st, k), "hwr": hwr0})
                  for k in ("saved_recog", "saved_adv")))

    def auto_groups64(self):
        """The child's answer: the JAX main, adversarial and reconRecog
        groups and their merge, float64 trees."""
        if self._auto64 is None:
            if not self.auto64.poll(900):
                raise TimeoutError("float64 auto groups: no answer")
            self._auto64 = self.auto64.recv()
            self.close()
        return self._auto64

    def close(self):
        if self.child.is_alive():
            self.child.kill()
        self.child.join()

    def compile_ahead(self):
        """Compile, each in its own thread, the four lesson steps (the auto
        step first, the largest), the two noise recorders and the float64
        JAX sides of the gen and disc lessons' float64 tests (kept as
        ``gen_vjp64``, ``disc_grad64``) and of
        ``test_extract_style_gradients_match_jax_float64`` (run here:
        ``style_grads64``).  XLA compiles outside the GIL, so
        this takes about the longest compile, not their sum (~50 s less on
        CPU); the lessons' own calls then find their executables in JAX's
        caches.  The tracing runs one after another on this thread."""
        tr, it = self.tr, iter(self.batches)
        state = tr.state
        text = tr.text.rng.bit_generator.state
        tb = tr.text.get_batch(label_len=L)
        tr.text.rng.bit_generator.state = text
        calls = {}
        for lesson in self.lessons[:4]:
            if "gen" in lesson:
                calls["step_gen_nostep"] = (
                    state, jnp.asarray(tb["label"]),
                    jnp.asarray(tb["label_lengths"]), tr.gen_spaced_len)
                continue
            b = next(it)
            args = (state, jnp.asarray(quantize_image_u8(b["image"])),
                    jnp.asarray(b["label"]), jnp.asarray(b["label_lengths"]))
            w = jnp.asarray(b["width"])
            if "count" in lesson:
                calls["step_count"] = args + (w, 2, None)
            elif "auto" in lesson:
                calls["step_auto"] = args + (
                    jnp.asarray(b["fg_mask"] > 0.5), w, 2, "main", 0, None)
            else:
                calls["step_disc"] = args + (w, 2, None)
        threads = []

        def start(job):
            threads.append(threading.Thread(target=job))
            threads[-1].start()
        # each compile starts as soon as its tracing ends, the largest first
        for name in sorted(calls, key=lambda n: n != "step_auto"):
            start(getattr(JGanTrainer, name).lower(tr, *calls[name]).compile)
            if name == "step_auto":
                self._compile_float64(start)
        key = jax.random.PRNGKey(0)
        for t in (W // 4, tr.gen_spaced_len):
            start(self._noise_fn(t).lower(state.params, key).compile)
        for t in threads:
            t.join()

    def _compile_float64(self, start):
        """Trace the float64 JAX pieces and ``start`` their compiles."""
        c, T = self.jcfg.model, self.tr.gen_spaced_len
        planes = jax.eval_shape(self._noise_fn(T), self.tr.state.params,
                                jax.random.PRNGKey(0))
        spec = lambda *shape: jax.ShapeDtypeStruct(shape, jnp.float64)
        sub = lambda *keys: _f64({k: self.params[k] for k in keys})
        with _jax_float64():
            jobs = {
                "gen_vjp64": lambda: jax.jit(_gen_vjps(c)).lower(
                    sub("generator")["generator"], spec(B, T, c.num_class),
                    spec(B, c.style.style_dim),
                    [spec(*p.shape) for p in planes],
                    [spec(B, 64, 4 * T, 1)] * 2),
                "disc_grad64": lambda: jax.jit(_disc_grad(c)).lower(
                    sub("discriminator"), _f64(self.spectral),
                    spec(B, 64, W, 1), spec(B, 64, W, 1))}
            for name, lower in jobs.items():
                start(lambda n=name, lw=lower():
                      setattr(self, n, lw.compile(F64_COMPILE)))
            args = (sub("hwr", "style_extractor"), *_style_case(c))
            style = jax.jit(_style_grad(c)).lower(*args)

            def style_job():
                with jax.enable_x64(True):
                    self.style_grads64 = _np(style.compile(F64_COMPILE)(
                        *args))
            start(style_job)

    def noise(self, nrng, T):
        """The generator's 10 noise planes for the ``noise`` stream key
        ``nrng`` at ``T`` spaced positions: each ``NoiseInjection`` draws
        ``normal(rng, x.shape[:3] + (1,))`` from the key its block passes
        it, which depends on the module path only."""
        return [np.asarray(p) for p in
                self._noise_fn(T)(self.tr.state.params, nrng)]

    def _noise_fn(self, T):
        if T not in self.noise_fns:
            model = JHWWithStyle(self.jcfg.model)

            def fn(params, key):
                planes = []

                def icpt(next_fun, args, kwargs, ctx):
                    if (isinstance(ctx.module, JNoiseInjection)
                            and ctx.method_name == "__call__"):
                        x, key_ = args[0], args[1]
                        planes.append(jax.random.normal(
                            key_, x.shape[:3] + (1,), x.dtype))
                    return next_fun(*args, **kwargs)
                with nn.intercept_methods(icpt):
                    model.apply({"params": params},
                                jnp.zeros((B, T), jnp.int32),
                                jnp.zeros((B, self.jcfg.model.style.style_dim)),
                                method="generate_spaced",
                                rngs={"noise": key})
                return planes
            self.noise_fns[T] = jax.jit(fn)
        return self.noise_fns[T]

    def draws(self, kind, state):
        """The step's random draws, split from ``state.rng`` as the step
        splits it."""
        tr, c = self.tr, self.jcfg
        if kind == "count":
            return {}
        if kind == "auto":
            _, _, nrng, _ = jax.random.split(state.rng, 4)
            return {"noise": self.noise(nrng, W // 4)}
        if kind == "gen":
            _, krng, nrng, srng = jax.random.split(state.rng, 4)
            T = tr.gen_spaced_len
        else:
            _, _, krng, nrng, srng = jax.random.split(state.rng, 5)
            T = W // 4
        k1, k2, k3 = jax.random.split(srng, 3)
        limit = jnp.clip(state.bank_count, 1, state.style_bank.shape[0])
        D = c.model.packed_style_dim()
        a, b = jax.random.split(krng)
        return {"bank": tuple(np.asarray(v) for v in (
                    jax.random.randint(k1, (B, 2), 0, limit),
                    jax.random.uniform(k2, (B, 1), minval=tr.interp_low,
                                       maxval=tr.interp_high),
                    jax.random.normal(k3, (B, D)))),
                "normals": (np.asarray(jax.random.normal(a, (B, L))),
                            np.asarray(jax.random.normal(b, (B, L)))),
                "noise": self.noise(nrng, T)}


@pytest.fixture(scope="module")
def run():
    r = _JaxRun()
    yield r
    r.close()


def _noise_shapes(T):
    """The generator's 10 noise planes at ``T`` spaced positions."""
    return [(B, h, w, 1) for h, w in [(4, T)] * 2 + [(8, T)] * 2
            + [(16, T)] * 2 + [(32, 2 * T)] * 2 + [(64, 4 * T)] * 2]


def _auto64_child(conn):
    """The JAX side of ``test_auto_lesson_float64_matches_jax`` in a
    process of its own, started with the fixture: its ~14 s of tracing run
    beside the parent's (one interpreter traces one function at a time),
    its compile and run beside the parent's JAX cycle.  Compiles
    ``_auto_groups`` at the tiny config's shapes, then answers the one
    request the parent sends (``_JaxRun._auto64_request``)."""
    jcfg = _tiny_gan_cfg()
    c = config_from_dict(dataclasses.asdict(jcfg)).model
    spec = lambda *shape: jax.ShapeDtypeStruct(shape, jnp.float64)
    ints = lambda *shape: jax.ShapeDtypeStruct(shape, jnp.int32)
    with _jax_float64():
        params = _f64(init_params(c, seed=0))
        fn = jax.jit(_auto_groups(jcfg)).lower(
            params, _f64(init_spectral(c, seed=0)),
            _f64(init_autoencoder_params("2tight", 0, seed=1)["params"]
                 ["encoder"]),
            spec(B, 64, W, 1), ints(B, L), ints(B), ints(B),
            spec(B, 64, W, 1), [spec(*s) for s in _noise_shapes(W // 4)],
            params, params).compile(F64_COMPILE)
        conn.send(_np(fn(*conn.recv())))


class _Float64Jnp:
    """``jnp`` with ``float32`` meaning ``float64``."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


J_MODULES = (j_autoencoder, j_char_style, j_count_cnn, j_disc, j_gan_trainer,
             j_generator, j_hws, j_hwr, j_layers, j_align, j_spacing)


def _conv_im2col(lhs, rhs, window_strides, padding, lhs_dilation=None,
                 rhs_dilation=None, dimension_numbers=None,
                 feature_group_count=1, batch_group_count=1, precision=None,
                 preferred_element_type=None):
    """``lax.conv_general_dilated`` as one shifted strided slice of the
    padded (and dilated) input per kernel tap, and one matmul."""
    assert batch_group_count == 1
    nd = lhs.ndim - 2
    dn = jax.lax.conv_dimension_numbers(lhs.shape, rhs.shape,
                                        dimension_numbers)
    x = jnp.transpose(lhs, (dn.lhs_spec[0], *dn.lhs_spec[2:],
                            dn.lhs_spec[1]))                # N, S..., C
    k = jnp.transpose(rhs, (*dn.rhs_spec[2:], dn.rhs_spec[1],
                            dn.rhs_spec[0]))                # S..., I, O
    lhs_dilation = tuple(lhs_dilation or (1,) * nd)
    rhs_dilation = tuple(rhs_dilation or (1,) * nd)
    ksz = k.shape[:nd]
    if isinstance(padding, str):
        padding = jax.lax.padtype_to_pads(
            [(s - 1) * d + 1 for s, d in zip(x.shape[1:-1], lhs_dilation)],
            [(s - 1) * d + 1 for s, d in zip(ksz, rhs_dilation)],
            window_strides, padding)
    x = jax.lax.pad(x, jnp.zeros((), x.dtype),
                    [(0, 0, 0)] + [(lo, hi, d - 1) for (lo, hi), d in
                                   zip(padding, lhs_dilation)] + [(0, 0, 0)])
    out = [(x.shape[1 + i] - (ksz[i] - 1) * rhs_dilation[i] - 1)
           // window_strides[i] + 1 for i in range(nd)]
    taps = []
    for off in itertools.product(*map(range, ksz)):
        start = [0] + [o * d for o, d in zip(off, rhs_dilation)] + [0]
        limit = ([x.shape[0]] + [b + (n - 1) * s + 1 for b, n, s in
                                  zip(start[1:], out, window_strides)]
                 + [x.shape[-1]])
        taps.append(jax.lax.slice(x, start, limit,
                                  [1, *window_strides, 1]))
    g, (I, O) = feature_group_count, k.shape[-2:]
    p = jnp.stack(taps, axis=-2)                            # N, out..., K, C
    p = p.reshape(p.shape[:-1] + (g, I))
    y = jnp.einsum("...kgc,kcgo->...go", p, k.reshape((-1, I, g, O // g)))
    y = y.reshape(y.shape[:-2] + (O,))
    return jnp.transpose(y, tuple(np.argsort(
        (dn.out_spec[0], *dn.out_spec[2:], dn.out_spec[1]))))


@contextlib.contextmanager
def _jax_float64():
    """The JAX model modules with ``float32`` meaning ``float64``, x64 on,
    and their convolutions as ``_conv_im2col``: XLA's CPU convolution in
    float64 is a plain loop nest, ~20x slower than its float64 matmul (the
    auto lesson's JAX side took 63 s), and the two agree to ~1e-14
    (``test_conv_im2col_matches_lax``)."""
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        for mod in J_MODULES:
            mp.setattr(mod, "jnp", _Float64Jnp())
        # flax's and the JAX package's convolutions, and lax.conv_transpose
        mp.setattr(jax.lax, "conv_general_dilated", _conv_im2col)
        mp.setattr(j_convolution, "conv_general_dilated", _conv_im2col)
        yield


CONV_CASES = [   # (lhs, rhs, strides, padding, lhs_dil, rhs_dil, groups, dn)
    ((2, 9, 11, 6), (3, 3, 6, 4), (1, 1), "SAME", None, None, 1,
     ("NHWC", "HWIO", "NHWC")),
    ((2, 9, 11, 6), (3, 2, 6, 4), (2, 1), "VALID", None, (1, 2), 1,
     ("NHWC", "HWIO", "NHWC")),
    ((2, 9, 11, 6), (3, 3, 1, 6), (1, 1), ((1, 1), (1, 1)), None, None, 6,
     ("NHWC", "HWIO", "NHWC")),
    ((2, 9, 11, 6), (4, 3, 6, 4), (1, 1), ((2, 2), (1, 1)), (2, 1), None, 1,
     ("NHWC", "HWIO", "NHWC")),
    ((2, 13, 6), (3, 6, 5), (1,), "SAME", None, (2,), 1,
     ("NWC", "WIO", "NWC")),
    ((2, 6, 9, 11), (4, 3, 3, 3), (1, 2), ((0, 1), (2, 0)), None, None, 2,
     ("NCHW", "OIHW", "NCHW")),
]


@pytest.mark.parametrize("case", CONV_CASES,
                         ids=["same", "strided-dilated", "depthwise",
                              "transposed", "1d-dilated", "grouped-nchw"])
def test_conv_im2col_matches_lax(case):
    """The float64 tests' convolution against ``lax.conv_general_dilated``
    in float64: outputs and both operands' gradients within 1e-12."""
    ls, rs, st, pad, ld, rd, g, dn = case
    rng = np.random.default_rng(5)
    a, b = rng.normal(size=ls), rng.normal(size=rs)
    with jax.enable_x64(True):
        def f(conv):
            def out_and_grads(a, b):
                y = lambda a, b: conv(a, b, st, pad, ld, rd, dn,
                                      feature_group_count=g)
                return y(a, b), jax.grad(lambda a, b: jnp.sum(jnp.sin(
                    y(a, b))), (0, 1))(a, b)
            return jax.jit(out_and_grads)(a, b)
        (got, got_g), (want, want_g) = (f(_conv_im2col),
                                        f(jax.lax.conv_general_dilated))
        assert got.shape == want.shape and got.dtype == jnp.float64
        for x, y in zip((got, *got_g), (want, *want_g)):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-12)


@pytest.fixture
def float64(monkeypatch):
    """Both packages in float64: the JAX modules' explicit float32 casts
    and the port's ``.float()`` casts and compute dtype widened."""
    monkeypatch.setattr(torch.Tensor, "float", lambda t: t.double())
    monkeypatch.setattr(ModelConfig, "torch_compute_dtype",
                        lambda self: torch.float64)
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        with _jax_float64():
            yield
    finally:
        torch.set_default_dtype(prev)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _gen_vjps(c):
    """``(params, onehot, style, noise, cts)`` -> the JAX generator's
    parameter VJP of each image cotangent in ``cts``, float64."""
    jg = JSpacedGenerator(num_class=c.num_class, style_dim=c.style.style_dim,
                          dim=c.generator.dim, dtype=jnp.float64)
    return lambda p, oh, style, noise, cts: [jax.vjp(
        lambda q: jg.apply({"params": q}, oh, style, noise=noise),
        p)[1](ct)[0] for ct in cts]


def _disc_grad(c):
    """``(params, spectral, real, fake)`` -> the gradient of the disc
    lesson's hinge loss w.r.t. the discriminator's parameters, float64:
    real then fake in two applies, the ``u``'s advancing between them."""
    jm = JHWWithStyle(c)

    def loss(p, spec, real, fake):
        r, v = jm.apply({"params": p, "spectral": spec}, real,
                        method="discriminate", mutable=["spectral"])
        f, _ = jm.apply({"params": p, "spectral": v["spectral"]}, fake,
                        method="discriminate", mutable=["spectral"])
        return j_disc_hinge_loss(r, f)
    return jax.grad(loss)


def _auto_groups(jcfg):
    """``(params, spectral, encoder, image, label, lens, frames, fg, noise,
    saved_recog, saved_adv)`` -> the auto lesson's main, adversarial and
    reconRecog gradient groups and their balanced merge with the saved
    groups, float64: ``GanTrainer.step_auto``'s autoencode VJP of each
    head's image cotangent, on the given noise planes."""
    tr = JGanTrainer(jcfg)
    assert tr.balance and tr.use_perceptual and not jcfg.model.style.vae
    jm, w = tr.model, tr.w
    mults = (j_multipliers_at(jcfg.trainer.balance_var_x, 0) + [1.0] * 4)[:4]

    def fn(params, spectral, enc, image, label, lens, frames, fg, noise,
           saved_recog, saved_adv):
        tr.encoder_params = {"params": enc}

        def autoencode(p):
            planes = list(noise)

            def icpt(next_fun, args, kwargs, ctx):
                if (isinstance(ctx.module, JNoiseInjection)
                        and ctx.method_name == "__call__"):
                    return next_fun(args[0], None, noise=planes.pop(0))
                return next_fun(*args, **kwargs)
            with nn.intercept_methods(icpt):
                return jm.apply({"params": p}, image, label, lens, 2,
                                method="autoencode", frame_lengths=frames,
                                rngs={"noise": jax.random.PRNGKey(0)})
        recon, vjp, _ = jax.vjp(autoencode, params, has_aux=True)

        def main(r):
            m = fg if tr.no_bg_loss else 1.0
            return (w["auto"] * jnp.mean(jnp.abs(r * m - image * m))
                    + w["perceptual"] * tr._perceptual(image, r))

        def adv(r):
            return w["generator"] * j_gen_adv_loss(
                tr._apply(params, spectral, "discriminate", r)[0])

        def recog(r):
            logp = j_mask_frames_to_blank(
                jm.apply({"params": params}, r, method="recognize"), frames)
            return tr._ctc(logp, label, lens, w["reconRecog"])
        main_g, adv_g, recog_g = (vjp(jax.grad(h)(recon))[0]
                                  for h in (main, adv, recog))
        merged = j_balance_and_merge(
            main_g, [saved_recog, saved_adv, adv_g, recog_g], mults)
        return main_g, adv_g, recog_g, merged
    return fn


def _style_case(c):
    """One author pair of 64 x 96 lines, its frames and a style
    cotangent, float64."""
    rng = np.random.default_rng(4)
    return (np.tanh(rng.normal(size=(2, 64, 96, 1))),
            np.array([24, 17], np.int32),
            rng.normal(size=(2, c.style.style_dim)))


def _style_grad(c):
    """``(params, image, frames, ct)`` -> the gradient of ``sum(style *
    ct)`` of ``extract_style`` w.r.t. the recognizer's and the style
    encoder's parameters."""
    jm = JHWWithStyle(c)
    return jax.grad(lambda p, image, frames, ct: jnp.sum(jm.apply(
        {"params": p}, image, 2, frame_lengths=frames,
        method="extract_style")[0] * ct))


def _torch_draws(draws):
    out = {}
    for k, v in draws.items():
        if k == "noise":
            out[k] = [torch.tensor(p) for p in v]
        else:
            out[k] = tuple(torch.tensor(np.asarray(p)) for p in v)
    return out


def _by_name(run, tree):
    """A slimmed params-shaped JAX tree (None for masked leaves) -> the
    port's tensors by parameter name, zeros for the recognizer's and the
    masked leaves."""
    def fill(p, g):
        if g is None:
            return jax.tree_util.tree_map(
                lambda a: np.zeros(a.shape, np.float32), p)
        if isinstance(p, dict):
            return {k: fill(v, g.get(k)) for k, v in p.items()}
        return g
    return convert_params(fill(run.params, {**tree, "hwr": None}),
                          run.spectral)


def _trainer(run):
    pt = GanTrainer(config_from_dict(dataclasses.asdict(run.jcfg)),
                    device="cpu")
    pt.init_state(seed=0, params=run.params, spectral=run.spectral,
                  encoder_state=run.encoder_state)
    return pt


def _load(pt, run, st):
    """The port's state set to a slimmed JAX state (weights, ``u``'s, saved
    groups, bank)."""
    s = pt.state
    with torch.no_grad():
        pt.model.load_state_dict(convert_params(run.full(st.params),
                                                st.spectral))
        for slot in ("saved_recog", "saved_adv"):
            got = _by_name(run, getattr(st, slot))
            for t, name in zip(getattr(s, slot), s.names):
                t.copy_(got[name])
        s.style_bank.copy_(torch.from_numpy(st.style_bank))
    s.have_saved = bool(st.have_saved)
    s.bank_count = int(st.bank_count)


def _adam_step_bound(b1, b2, t):
    """The largest |update| / lr of Adam's t-th step over all gradient
    sequences: ``|m̂| / sqrt(v̂)`` with ``m̂ = sum a_k g_k``, ``v̂ = sum
    w_k g_k²`` is at most ``sqrt(sum a_k² / w_k)`` (Cauchy-Schwarz); 1 at
    the first step, 1.054 at the second for betas (0.5, 0.999)."""
    a = [(1 - b1) * b1 ** (t - k) / (1 - b1 ** t) for k in range(1, t + 1)]
    w = [(1 - b2) * b2 ** (t - k) / (1 - b2 ** t) for k in range(1, t + 1)]
    return float(np.sqrt(sum(x * x / y for x, y in zip(a, w))))


def _rel_l2(got, want):
    a = np.concatenate([g.ravel() for g in got])
    b = np.concatenate([w.ravel() for w in want])
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _u8(image):
    return torch.from_numpy(np.clip(np.rint((1.0 - image) * 128), 0, 255)
                            .astype(np.uint8))


def test_lessons_from_the_same_state_match_jax(run):
    """Each lesson from JAX's state before it: losses, the gradients it
    produces and the ``u``'s it leaves."""
    pt = _trainer(run)
    b1 = run.jcfg.optimizer.betas[0]
    it = iter(run.batches)
    for i, rec in enumerate(run.records):
        _load(pt, run, rec["before"])
        draws = _torch_draws(rec["draws"])
        kind = rec["kind"]
        if kind == "gen":
            out = pt.step_gen_nostep(rec["labels"]["label"],
                                     rec["labels"]["label_lengths"],
                                     pt.gen_spaced_len, draws)
            groups = [(out["recog_g"], "saved_recog"),
                      (out["adv_g"], "saved_adv")]
            for mine, slot in groups:
                want = _by_name(run, getattr(rec["after"], slot))
                err = _rel_l2([g.numpy() for g in mine],
                              [want[n].numpy() for n in pt.state.names])
                assert err <= KINK_L2, (i, slot, err)
        else:
            batch = next(it)
            args = [_u8(batch["image"]), batch["label"],
                    batch["label_lengths"]]
            if kind == "count":
                out = pt.step_count(*args, batch["width"], 2, draws=draws)
                grads, opt, part = out["grads"], "opt_main", "main"
            elif kind == "auto":
                out = pt.step_auto(*args, batch["fg_mask"] > 0.5,
                                   batch["width"], 2, draws=draws)
                grads, opt, part = out["merged"], "opt_main", "main"
            else:
                out = pt.step_disc(*args, batch["width"], 2, draws=draws)
                grads, opt, part = out["grads"], "opt_disc", "disc"
            # optax's update from its first moments: clip(g) =
            # (mu' - b1 mu) / (1 - b1)
            mu = jax.tree_util.tree_map(
                lambda a, b: None if a is None else (a - b1 * b) / (1 - b1),
                getattr(rec["after"], opt), getattr(rec["before"], opt),
                is_leaf=lambda g: g is None)
            want = _by_name(run, mu)
            mine = [(n, torch.clamp(g, -2.0, 2.0).numpy())
                    for n, g, l in zip(pt.state.names, grads,
                                       pt.state.labels) if l == part]
            if kind == "count":
                for n, g in mine:
                    assert _max_rel(g, want[n].numpy()) <= GRAD_RTOL, (i, n)
            else:
                err = _rel_l2([g for _, g in mine],
                              [want[n].numpy() for n, _ in mine])
                assert err <= KINK_L2, (i, kind, err)
        for k, v in rec["out"].items():
            if k.endswith("Loss"):
                np.testing.assert_allclose(
                    float(out[k]), float(v), rtol=LOSS_RTOL["same state"],
                    err_msg=f"lesson {i} {k}")
        spec = convert_params(run.full(rec["after"].params),
                              rec["after"].spectral)
        for name, t in pt.model.state_dict().items():
            if name.endswith(".u"):
                np.testing.assert_allclose(t.numpy(), spec[name].numpy(),
                                           atol=1e-6, err_msg=(i, name))


def test_cycle_matches_jax(run):
    """The port's own 7 lessons through ``run_lesson`` with the JAX draws:
    losses lesson by lesson; parameters, ``u``'s and the bank after."""
    pt = _trainer(run)
    it = iter(run.batches)
    diffs = []
    for i, rec in enumerate(run.records):
        out = pt.run_lesson(run.lessons[i], it, iteration=i,
                            draws=_torch_draws(rec["draws"]))
        assert {k for k in out if k.endswith("Loss")} == \
            {k for k in rec["out"] if k.endswith("Loss")}
        for k, v in rec["out"].items():
            if k.endswith("Loss"):
                diffs.append((i, k, float(out[k]), float(v)))
    for i, k, got, want in diffs:
        if i > 0 and k in ADVERSARIAL:
            assert abs(got - want) <= ADV_ATOL, (i, k, got, want)
        else:
            rtol = LOSS_RTOL["first" if i == 0 else "later"]
            assert abs(got - want) <= rtol * abs(want), (i, k, got, want)
    end = run.records[-1]["after"]
    s = pt.state
    assert s.step == int(end.step) == 7
    assert s.bank_count == int(end.bank_count) == 4
    lr = run.jcfg.optimizer.lr
    b1, b2 = run.jcfg.optimizer.betas
    steps = {"main": 3, "disc": 2, "frozen": 0}
    bound = {k: 2 * lr * sum(_adam_step_bound(b1, b2, t)
                             for t in range(1, n + 1)) + 1e-6
             for k, n in steps.items()}
    want = convert_params(run.full(end.params), end.spectral)
    start = convert_params(run.params, run.spectral)
    for name, p, label in zip(s.names, s.params, s.labels):
        d = np.abs(p.detach().numpy() - want[name].numpy()).max()
        assert d <= bound[label], (name, d)
        if label == "frozen":
            assert torch.equal(p.detach(), start[name]), name
    for name, t in pt.model.state_dict().items():
        if name.endswith(".u"):
            err = _max_rel(t.numpy(), want[name].numpy())
            assert err <= U_TRAJECTORY_RTOL, (name, err)
    assert _max_rel(s.style_bank.numpy(), end.style_bank) <= STATE_RTOL


def test_gen_lesson_float64_matches_jax(run, float64):
    """The first gen lesson's saved genRecog and genAdv groups in float64,
    from the same state: the port's step against the JAX generator's VJP
    of the same two image cotangents (the frozen recognizer's CTC and the
    discriminator's adversarial loss, differentiated with respect to the
    generated line), on the same spaced text, style and noise."""
    rec = run.records[1]
    st = rec["before"]
    assert rec["kind"] == "gen"
    pt = _f64_trainer(run, st)
    draws = _torch_draws(rec["draws"])
    label = torch.from_numpy(rec["labels"]["label"])
    lens = torch.from_numpy(rec["labels"]["label_lengths"])
    T, w = pt.gen_spaced_len, pt.w
    style = pt._bank_style(B, draws)
    img, aux = pt._generate(label, lens, style, T, draws)
    im = img.detach().requires_grad_(True)
    frames = torch.clamp(aux["total_len"], 1, T)
    logp = mask_frames_to_blank(pt.model.recognize(im), frames)
    ct_recog, = torch.autograd.grad(
        pt._ctc(logp, label, lens, w["genRecog"]), im)
    ct_adv, = torch.autograd.grad(w["generator"] * gen_adv_loss(
        pt.model.discriminate(im, update_u=False)), im)
    out = pt.step_gen_nostep(label, lens, T, draws)
    assert out["recog_g"][0].dtype == torch.float64

    oh = jax.nn.one_hot(aux["spaced"].numpy(), run.jcfg.model.num_class,
                        dtype=jnp.float64)
    noise = [jnp.asarray(n, jnp.float64) for n in rec["draws"]["noise"]]
    vjps = run.gen_vjp64(_f64(st.params["generator"]), oh, style.numpy(),
                         noise, [ct_recog.numpy(), ct_adv.numpy()])
    _check_groups([{"generator": g} for g in vjps],
                  (out["recog_g"], out["adv_g"]), pt.state.names)


def _check_groups(want_trees, groups, names, spectral=None):
    """Each of the port's gradient groups against the JAX gradient tree of
    the same cotangent: within ``GRAD_RTOL`` of each tensor's largest
    entry, and zero for a parameter the JAX tree does not hold."""
    for tree, mine in zip(want_trees, groups):
        want = convert_params(_np(tree), spectral)
        for name, g in zip(names, mine):
            if name in want:
                assert _max_rel(g.numpy(), want[name].numpy()) \
                    <= GRAD_RTOL, name
            else:
                assert not g.any(), name


def _f64_trainer(run, st):
    pt = _trainer(run)
    pt.model.double()
    _load(pt, run, st)
    return pt


def test_disc_lesson_float64_matches_jax(run, float64, monkeypatch):
    """The first disc lesson's gradients in float64, from the same state:
    the port's step against JAX's gradient of the hinge loss on the same
    real and generated lines, real then fake, from the same ``u``'s."""
    rec = run.records[3]
    st = rec["before"]
    assert rec["kind"] == "disc"
    pt = _f64_trainer(run, st)
    assert pt.w["discriminator"] == 1.0
    seen = []
    discriminate = pt.model.discriminate

    def spy(image, **kw):
        seen.append(image.detach().numpy())
        return discriminate(image, **kw)
    monkeypatch.setattr(pt.model, "discriminate", spy)
    b = run.batches[2]
    out = pt.step_disc(_u8(b["image"]), b["label"], b["label_lengths"],
                       b["width"], 2, draws=_torch_draws(rec["draws"]))
    assert len(seen) == 2
    g_j = run.disc_grad64(_f64({"discriminator": st.params["discriminator"]}),
                          _f64(st.spectral), *seen)
    _check_groups([g_j], [out["grads"]], pt.state.names, st.spectral)


def test_auto_lesson_float64_matches_jax(run, float64, monkeypatch):
    """The first auto lesson's gradient groups in float64, from the same
    state (the gen lesson's saved groups in place): the main (fg-masked L1
    + perceptual), adversarial and reconRecog groups and their balanced
    merge with the saved ones, every parameter's tensor (the frozen
    recognizer's through ``pred`` included) against the JAX lesson's on the
    same line, frames and noise."""
    rec = run.records[2]
    st = rec["before"]
    assert rec["kind"] == "auto" and bool(st.have_saved)
    pt = _f64_trainer(run, st)
    pt.encoder.double()
    s = pt.state
    s.saved_recog[:] = [g.double() for g in s.saved_recog]
    s.saved_adv[:] = [g.double() for g in s.saved_adv]
    seen = {}
    autoencode = pt.model.autoencode

    def spy(image, *a, **kw):
        seen.update(image=image.numpy(), frames=kw["frame_lengths"].numpy())
        return autoencode(image, *a, **kw)
    monkeypatch.setattr(pt.model, "autoencode", spy)
    b = run.batches[1]
    draws = _torch_draws(rec["draws"])
    want = run.auto_groups64()
    out = pt.step_auto(_u8(b["image"]), b["label"], b["label_lengths"],
                       b["fg_mask"] > 0.5, b["width"], 2, draws=draws)
    assert out["merged"][0].dtype == torch.float64
    # the JAX side read the same line and frames
    np.testing.assert_array_equal(seen["image"], run.auto64_inputs["image"])
    np.testing.assert_array_equal(seen["frames"],
                                  run.auto64_inputs["frames"])
    _check_groups(want, [out[k] for k in ("main_g", "adv_g", "recog_g",
                                          "merged")],
                  s.names, st.spectral)


# -- gradients of the modules the lessons train, B = 2 ------------------------


def _grad_check(named, grads_want):
    for name, p in named:
        assert _max_rel(p.grad.numpy(), grads_want[name].numpy()) \
            <= GRAD_RTOL, name


def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def test_generator_and_spacer_gradients_match_jax(run):
    """``SpacedGenerator`` (plain path, injected noise) and ``CountCNN``:
    parameter gradients of a random cotangent, float32."""
    c = run.pcfg.model
    rng = np.random.default_rng(3)
    T, S = 16, c.style.style_dim
    spaced = rng.integers(0, c.num_class, (2, T)).astype(np.int32)
    style = rng.normal(size=(2, S)).astype(np.float32)
    noise = [rng.normal(size=(2,) + s[1:]).astype(np.float32)
             for s in _noise_shapes(T)]
    ct = rng.normal(size=(2, 64, 4 * T, 1)).astype(np.float32)
    gp = run.params["generator"]
    jg = JSpacedGenerator(num_class=c.num_class, style_dim=S,
                          dim=c.generator.dim)
    g_j = jax.jit(jax.grad(lambda p: jnp.sum(jg.apply(
        {"params": p}, jax.nn.one_hot(spaced, c.num_class), style,
        noise=noise) * ct)))(gp)
    pg = SpacedGenerator(num_class=c.num_class, style_dim=S,
                         dim=c.generator.dim)
    pg.load_state_dict(_sub(convert_params({"generator": gp}),
                            "generator."))
    out = pg(torch.nn.functional.one_hot(torch.from_numpy(spaced).long(),
                                         c.num_class).float(),
             torch.from_numpy(style),
             noise=[torch.from_numpy(n) for n in noise])
    (out * torch.from_numpy(ct)).sum().backward()
    _grad_check(pg.named_parameters(),
                _sub(convert_params({"generator": _np(g_j)}), "generator."))

    sp = run.params["spacer"]
    lab = rng.integers(1, c.num_class, (2, L)).astype(np.int32)
    ct = rng.normal(size=(2, L, 2)).astype(np.float32)
    jc = JCountCNN(hidden=c.spacer.dim, n_out=2)
    g_j = jax.jit(jax.grad(lambda p: jnp.sum(jc.apply(
        {"params": p}, jax.nn.one_hot(lab, c.num_class), style) * ct)))(sp)
    pc = CountCNN(c.num_class + S, c.spacer.dim, 2)
    pc.load_state_dict(_sub(convert_params({"spacer": sp}), "spacer."))
    (pc(torch.nn.functional.one_hot(torch.from_numpy(lab).long(),
                                    c.num_class).float(),
        torch.from_numpy(style)) * torch.from_numpy(ct)).sum().backward()
    _grad_check(pc.named_parameters(),
                _sub(convert_params({"spacer": _np(g_j)}), "spacer."))


def test_extract_style_gradients_match_jax_float64(run, float64):
    """``extract_style`` (the recognizer and ``CharStyleEncoder``, one
    author pair, frames masked): gradients of every parameter it uses, in
    float64 (in float32 a recognizer max-pool window whose two largest
    entries lie within the packages' difference routes its gradient to
    another element: 1.4e-2 of the max of one trunk conv's weights)."""
    image, frames, ct = _style_case(run.pcfg.model)
    pm = HWWithStyle(run.pcfg.model).double()
    pm.load_state_dict(convert_params(run.params, run.spectral))
    style, _ = pm.extract_style(torch.from_numpy(image), 2,
                                frame_lengths=torch.from_numpy(frames))
    assert style.dtype == torch.float64
    (style * torch.from_numpy(ct)).sum().backward()
    want = convert_params(run.style_grads64)
    _grad_check([(n, p) for n, p in pm.named_parameters() if n in want],
                want)
