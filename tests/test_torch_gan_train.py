"""Port parity for the GAN's training run: the lesson branches off the paper
path, ``eval_step``/``eval_gen_step``/``validate``, SWA, the pseudo-labels
and the sample strips against the JAX ``GanTrainer``, the loop's schedule
against JAX's ``train``, and the port's own guarantees (resume bit for bit,
SIGINT, clobber refusal, no host sync between log steps).

The JAX sides run in spawned child processes started by the module
fixture, beside the port-only tests of the parent (one interpreter traces
one function at a time): ``_variant_child`` runs a gen, an auto and a disc
lesson of the *variant* config (``_variant_cfg``: the unbalanced merge,
``hwr_frozen`` off, a ``cond`` discriminator, ``"affine"`` augmentation and
a VAE style, all at once), ``_variant64_child`` compiles the variant auto
lesson's gradient groups and the gen lesson's direct recognizer gradient in
float64, and ``_eval_child`` runs the evaluation pieces on the paper config.
Each step's draws are recomputed from the JAX state's key the way the step
splits it (the augmentation's ``(stretch, skew)``, the VAE eps, the bank,
the spacer's normals and the noise planes) and injected into the port.

Tolerances:
* each variant lesson from JAX's state before it: the gradient it hands its
  optimizer (JAX's read back from the Adam first moments) or saves within
  ``KINK_L2`` relative L2 (the float32 kink flips of
  ``test_torch_gan_trainer``), its losses within rtol 1e-4; the float64
  groups the branches change (the main group with the KL, the unbalanced
  merge with the recognizer's direct gradient, the gen lesson's direct
  recognizer gradient) within 1e-3 of each tensor's largest entry;
* an ``auto-style`` / ``style-ex-only`` lesson: the same gradient into the
  ``gen_only`` / ``style_ex`` optimizer (their partitions JAX's), and only
  the parameters of that partition move;
* ``eval_step``/``eval_gen_step``: losses within rtol 1e-4, the
  reconstruction and the generated line within 1e-4 max abs, argmaxes equal
  wherever JAX's top-2 margin exceeds 1e-4; ``validate`` over 2 batches:
  every ``val_*`` within rtol 1e-4, CER/WER equal;
* ``swa_update`` after three updates within 1e-6; pseudo-labels and sample
  strips equal.
"""

import dataclasses
import itertools
import multiprocessing
import os
import shutil
import signal
import sys
import threading
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as nn
from flax import struct

import handwriting_line_generation_tpu.models.hw_with_style as j_hws
import handwriting_line_generation_tpu.ops.augment as j_augment
import handwriting_line_generation_tpu.training.gan_trainer as j_gan_trainer
import handwriting_line_generation_tpu.utils.checkpoint as j_checkpoint
from handwriting_line_generation_tpu.data.datasets import quantize_image_u8
from handwriting_line_generation_tpu.models.hw_with_style import \
    HWWithStyle as JHWWithStyle
from handwriting_line_generation_tpu.models.layers import \
    NoiseInjection as JNoiseInjection
from handwriting_line_generation_tpu.ops.ctc import \
    mask_frames_to_blank as j_mask_frames_to_blank
from handwriting_line_generation_tpu.training.gan_trainer import \
    GanTrainer as JGanTrainer
from handwriting_line_generation_tpu.training.losses import \
    gen_adv_loss as j_gen_adv_loss
from handwriting_line_generation_tpu.training.losses import \
    vae_kl as j_vae_kl
from handwriting_line_generation_tpu.training.train_state import \
    create_gan_state as j_create_gan_state
from handwriting_line_generation_tpu.training.train_state import \
    swa_update as j_swa_update
from handwriting_line_generation_tpu_torch.config import config_from_dict
from handwriting_line_generation_tpu_torch.convert import (
    convert_autoencoder_params, convert_params,
)
from handwriting_line_generation_tpu_torch.init import (
    init_autoencoder_params, init_params, init_spectral,
)
from handwriting_line_generation_tpu_torch.training import \
    gan_trainer as p_gan_trainer
from handwriting_line_generation_tpu_torch.training.gan_trainer import \
    GanTrainer
from handwriting_line_generation_tpu_torch.training.train_state import \
    swa_update
from handwriting_line_generation_tpu_torch.utils import \
    checkpoint as p_checkpoint
from handwriting_line_generation_tpu_torch.utils.checkpoint import \
    extract_subtree
from test_torch_gan_trainer import (
    B, F64_COMPILE, KINK_L2, L, W, _batches, _f64, _jax_float64, _jitter,
    _masked_as_none, _max_rel, _noise_shapes, _np, _rel_l2, _u8,
    float64,  # noqa: F401 (the fixture)
)
from test_torch_kernels import _assert_states_equal
from test_trainers import _tiny_gan_cfg

pytestmark = pytest.mark.compile   # the JAX steps' compiles dominate

GRAD_RTOL = 1e-3
LOSS_RTOL = 1e-4
EVAL_ATOL = 1e-4
MARGIN = 1e-4
VARIANT_LESSONS = (["no-step", "gen"], ["auto", "auto-gen"], ["disc"])
MAX_STRETCH, MAX_ROT = 0.4, 45 / 180 * 3.14159265   # apply_augmentation's
THREADS = 2                # the port's, beside the three JAX children


def _variant_cfg():
    """The tiny GAN with every non-paper branch the lessons have: the
    unbalanced merge, a trained recognizer, a ``cond`` discriminator, the
    affine augmentation and a VAE style; its curriculum holds ``auto-style``
    and ``style-ex-only`` lessons, so both separate optimizers exist."""
    cfg = _tiny_gan_cfg()
    cfg.trainer.balance_loss = False
    cfg.model.hwr_frozen = False
    cfg.model.discriminator.cond = True
    cfg.data.augmentation = "affine"
    cfg.model.style.vae = True
    cfg.trainer.curriculum = {"0": [
        list(l) for l in VARIANT_LESSONS
        + (["auto", "auto-gen", "auto-style"],
           ["auto", "auto-gen", "style-ex-only"])]}
    return cfg


def _weights(jcfg):
    """The weights both packages start from: the port's seeded init with
    every bias and norm scale jittered, the discriminator's ``u``'s and a
    seeded perceptual encoder (jittered)."""
    pcfg = config_from_dict(dataclasses.asdict(jcfg))
    rng = np.random.default_rng(7)
    params = _jitter(init_params(pcfg.model, seed=0), rng)
    enc = _jitter(init_autoencoder_params("2tight", 0, seed=1)["params"]
                  ["encoder"], rng)
    return params, init_spectral(pcfg.model, seed=0), enc


def _port_trainer(jcfg, weights, **trainer):
    params, spectral, enc = weights
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    for k, v in trainer.items():
        setattr(cfg.trainer, k, v)
    pt = GanTrainer(cfg, device="cpu")
    pt.init_state(seed=0, params=params, spectral=spectral,
                  encoder_state=extract_subtree(
                      convert_autoencoder_params({"encoder": enc}),
                      "encoder"))
    return pt


def _jax_trainer(jcfg, weights):
    params, spectral, enc = weights
    tr = JGanTrainer(jcfg)
    tr.encoder_params = {"params": enc}
    (tr.state, tr.main_tx, tr.disc_tx, tr.gen_only_tx,
     tr.style_ex_tx) = j_create_gan_state(
        jcfg, {"params": jax.tree_util.tree_map(jnp.asarray, params),
               "spectral": jax.tree_util.tree_map(jnp.asarray, spectral)},
        jax.random.PRNGKey(1), need_sep_gen_opt=True,
        need_sep_style_ex_opt=True)
    return tr


# -- the JAX side: draws ------------------------------------------------------


class _Draws:
    """A JAX step's random draws, split from its key as the step splits
    them, and the generator's noise planes (recorded by intercepting
    ``NoiseInjection`` in an apply that derives its ``noise`` stream from
    the same key)."""

    def __init__(self, tr, jcfg):
        self.tr, self.jcfg, self.fns = tr, jcfg, {}

    def noise(self, key, T):
        if T not in self.fns:
            model = JHWWithStyle(self.jcfg.model)

            def fn(params, key):
                planes = []

                def icpt(next_fun, args, kwargs, ctx):
                    if (isinstance(ctx.module, JNoiseInjection)
                            and ctx.method_name == "__call__"):
                        x = args[0]
                        planes.append(jax.random.normal(
                            args[1], x.shape[:3] + (1,), x.dtype))
                    return next_fun(*args, **kwargs)
                with nn.intercept_methods(icpt):
                    model.apply({"params": params},
                                jnp.zeros((B, T), jnp.int32),
                                jnp.zeros((B, self.jcfg.model.style.style_dim)),
                                method="generate_spaced",
                                rngs={"noise": key})
                return planes
            self.fns[T] = jax.jit(fn)
        return [np.asarray(p) for p in
                self.fns[T](self.tr.state.params, key)]

    def bank(self, key, krng, bank_count, bank_size):
        tr = self.tr
        k1, k2, k3 = jax.random.split(key, 3)
        limit = jnp.clip(bank_count, 1, bank_size)
        a, b = jax.random.split(krng)
        return {"bank": tuple(np.asarray(v) for v in (
                    jax.random.randint(k1, (B, 2), 0, limit),
                    jax.random.uniform(k2, (B, 1), minval=tr.interp_low,
                                       maxval=tr.interp_high),
                    jax.random.normal(k3, (B, self.jcfg.model
                                           .packed_style_dim())))),
                "normals": (np.asarray(jax.random.normal(a, (B, L))),
                            np.asarray(jax.random.normal(b, (B, L))))}

    @staticmethod
    def affine(key):
        k1, k2 = jax.random.split(key)
        return {"stretch": np.asarray(jax.random.uniform(
                    k1, (), minval=1 - MAX_STRETCH, maxval=1 + MAX_STRETCH)),
                "skew": np.asarray(jax.random.uniform(
                    k2, (), minval=-MAX_ROT, maxval=MAX_ROT))}

    def vae_eps(self, key):
        """``HWWithStyle.autoencode``'s eps: a normal from the root scope's
        first ``make_rng("vae")``."""
        k = self.tr.model.apply({}, method=lambda m: m.make_rng("vae"),
                                rngs={"vae": key})
        return np.asarray(jax.random.normal(
            k, (B, self.jcfg.model.style.style_dim)))

    def lesson(self, kind, state):
        tr = self.tr
        if kind == "gen":
            _, krng, nrng, srng = jax.random.split(state.rng, 4)
            return {**self.bank(srng, krng, state.bank_count,
                                state.style_bank.shape[0]),
                    "noise": self.noise(nrng, tr.gen_spaced_len)}
        if kind == "auto":
            _, aug, nrng, vrng = jax.random.split(state.rng, 4)
            return {"noise": self.noise(nrng, W // 4),
                    "aug": self.affine(aug), "vae": self.vae_eps(vrng)}
        _, aug, krng, nrng, srng = jax.random.split(state.rng, 5)
        return {**self.bank(srng, krng, state.bank_count,
                            state.style_bank.shape[0]),
                "noise": self.noise(nrng, W // 4), "aug": self.affine(aug)}

    def eval_gen(self, rng, bank_count, bank_size):
        """``eval_gen_step``'s / ``eval_gen_render``'s draws from
        ``rng``."""
        krng, nrng, srng = jax.random.split(rng, 3)
        return {**self.bank(srng, krng, bank_count, bank_size),
                "noise": self.noise(nrng, self.tr.gen_spaced_len)}


def _torch_draws(draws):
    if draws is None:
        return None
    out = {}
    for k, v in draws.items():
        if k == "noise":
            out[k] = [torch.tensor(p) for p in v]
        elif k == "aug":
            out[k] = {a: torch.tensor(np.asarray(b)) for a, b in v.items()}
        elif k == "vae":
            out[k] = torch.tensor(v)
        else:
            out[k] = tuple(torch.tensor(np.asarray(p)) for p in v)
    return out


def _slim(state):
    """A numpy copy of a JAX train state with only the first moments of the
    main and disc optimizers' stepped partitions."""
    opt = lambda o, part: _masked_as_none(
        o[1].inner_states[part].inner_state[0].mu)
    return _np(state.replace(opt_main=opt(state.opt_main, "main"),
                             opt_disc=opt(state.opt_disc, "disc"),
                             opt_gen_only=(), opt_style_ex=()))


def _on_leaves(tx, params):
    """A params-shaped tree: ones where a separate optimizer steps the
    parameter, zeros elsewhere."""
    mu = tx.init(params)[1].inner_states["on"].inner_state[0].mu
    masked = lambda g: type(g).__name__ == "MaskedNode"
    return jax.tree_util.tree_map(
        lambda m, p: np.full(p.shape, 0.0 if masked(m) else 1.0, np.float32),
        mu, params, is_leaf=masked)


def _unoptimized_xla():
    """A child's compiles without LLVM's optimizations (``F64_COMPILE`` for
    every jit): half the compile time, and the pieces run at tiny shapes.
    Set before the child's first JAX computation starts its backend."""
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_backend_optimization_level=0")


def _compile_steps(tr, draws, calls):
    """Trace ``calls`` (step name -> args) one after another here and
    compile each in its own thread, without LLVM's optimizations (half the
    compile time; the steps run at tiny shapes), the noise recorders
    beside them.  Returns the executables, which take the steps' dynamic
    arguments."""
    threads, out = [], {}
    for name, args in calls.items():
        lowered = getattr(JGanTrainer, name).lower(tr, *args)
        threads.append(threading.Thread(target=lambda n=name, lw=lowered:
                                        out.__setitem__(n, lw.compile(
                                            F64_COMPILE))))
        threads[-1].start()
    for T in (W // 4, tr.gen_spaced_len):
        draws.noise(jax.random.PRNGKey(0), T)
    for t in threads:
        t.join()
    return out


def _variant_child(conn, to64):
    """The variant config's gen, auto and disc lessons from ``_weights``
    (``run_lesson``'s calls of the compiled steps), each lesson's state
    before and after, draws, labels and outputs; and which parameters the
    separate optimizers step.  The auto lesson's record also goes to
    ``_variant64_child`` (``to64``)."""
    _unoptimized_xla()
    jcfg = _variant_cfg()
    tr = _jax_trainer(jcfg, _weights(jcfg))
    dr = _Draws(tr, jcfg)
    batches = iter(_batches(2))
    st = tr.state
    text = tr.text.rng.bit_generator.state
    tb = tr.text.get_batch(label_len=L)
    tr.text.rng.bit_generator.state = text
    image = lambda b: (jnp.asarray(quantize_image_u8(b["image"])),
                       jnp.asarray(b["label"]),
                       jnp.asarray(b["label_lengths"]))
    b = _batches(1)[0]
    w = jnp.asarray(b["width"])
    steps = _compile_steps(tr, dr, {
        "step_auto": (st, *image(b), jnp.asarray(b["fg_mask"] > 0.5), w, 2,
                      "main", 0, None),
        "step_gen_nostep": (st, jnp.asarray(tb["label"]),
                            jnp.asarray(tb["label_lengths"]),
                            tr.gen_spaced_len),
        "step_disc": (st, *image(b), w, 2, None)})
    records = []
    for lesson in VARIANT_LESSONS:
        kind = next(k for k in ("gen", "auto", "disc") if k in lesson)
        draws = dr.lesson(kind, tr.state)
        before = _slim(tr.state)
        labels = None
        if kind == "gen":
            labels = tr.text.get_batch(label_len=L)
            tr.state, out = steps["step_gen_nostep"](
                tr.state, jnp.asarray(labels["label"]),
                jnp.asarray(labels["label_lengths"]))
        else:
            b = next(batches)
            w = jnp.asarray(b["width"])
            tr.state, out = (
                steps["step_auto"](tr.state, *image(b),
                                   jnp.asarray(b["fg_mask"] > 0.5), w, None)
                if kind == "auto" else
                steps["step_disc"](tr.state, *image(b), w, None))
        records.append(dict(kind=kind, before=before, after=_slim(tr.state),
                            out=jax.device_get(out), draws=draws,
                            labels=labels))
    to64.send(records[1])
    params = tr.state.params
    conn.send({"records": records,
               "on": {"gen_only": _on_leaves(tr.gen_only_tx, params),
                      "style_ex": _on_leaves(tr.style_ex_tx, params)}})


class _EpsJax:
    """``jax`` for the JAX ``hw_with_style`` module, its
    ``random.normal`` returning the given VAE eps."""

    def __init__(self, eps):
        self.random = types.SimpleNamespace(normal=lambda *a, **k: eps)

    def __getattr__(self, name):
        return getattr(jax, name)


def _variant_auto_groups(jcfg):
    """``(params, spectral, encoder, image, label, lens, width, fg, noise,
    eps, stretch, skew, saved_recog, saved_adv)`` -> the variant auto
    lesson's main group (the reconstruction's cotangent and the KL's
    ``styleReg``, one VJP) and its unbalanced merge (main + the adversarial
    and reconRecog cotangents' VJP + the recognizer's direct reconRecog
    gradient + the saved groups): ``GanTrainer.step_auto``'s arithmetic on
    the dequantized line and fg mask, augmented by the given ``(stretch,
    skew)``, with the given noise planes and eps."""
    tr = JGanTrainer(jcfg)
    assert not tr.balance and not jcfg.model.hwr_frozen
    jm, w = tr.model, tr.w

    def fn(params, spectral, enc, image, label, lens, width, fg, noise, eps,
           stretch, skew, saved_recog, saved_adv):
        tr.encoder_params = {"params": enc}
        sk, st = jnp.full((B,), skew), jnp.full((B,), stretch)
        image = j_augment.affine_slant_stretch(image, sk, st)
        fg = j_augment.affine_slant_stretch(fg, sk, st, fill=0.0)
        frames = jnp.clip(jnp.ceil(width * stretch / 4.0).astype(jnp.int32),
                          1, W // 4)

        def autoencode(p):
            planes = list(noise)

            def icpt(next_fun, args, kwargs, ctx):
                if (isinstance(ctx.module, JNoiseInjection)
                        and ctx.method_name == "__call__"):
                    return next_fun(args[0], None, noise=planes.pop(0))
                return next_fun(*args, **kwargs)
            real = j_hws.jax
            j_hws.jax = _EpsJax(eps)
            try:
                with nn.intercept_methods(icpt):
                    recon, aux = jm.apply(
                        {"params": p}, image, label, lens, 2,
                        method="autoencode", frame_lengths=frames,
                        rngs={"noise": jax.random.PRNGKey(0),
                              "vae": jax.random.PRNGKey(0)})
            finally:
                j_hws.jax = real
            return (recon, j_vae_kl(*aux["style"])), aux
        (recon, kl), vjp, aux = jax.vjp(autoencode, params, has_aux=True)
        cond = jax.lax.stop_gradient(aux["style"][0])

        def main(r):
            m = fg if tr.no_bg_loss else 1.0
            return (w["auto"] * jnp.mean(jnp.abs(r * m - image * m))
                    + w["perceptual"] * tr._perceptual(image, r))

        def adv(r):
            return w["generator"] * j_gen_adv_loss(tr._apply(
                params, spectral, "discriminate", r, style=cond)[0])

        def recog(r, p):
            logp = j_mask_frames_to_blank(
                jm.apply({"params": p}, r, method="recognize"), frames)
            return tr._ctc(logp, label, lens, w["reconRecog"])
        zero = jnp.zeros((), recon.dtype)
        main_g = vjp((jax.grad(main)(recon),
                      jnp.asarray(w["styleReg"], recon.dtype)))[0]
        ct_recog, recog_p = jax.grad(recog, (0, 1))(recon, params)
        both = vjp((jax.grad(adv)(recon) + ct_recog, zero))[0]
        merged = jax.tree_util.tree_map(
            lambda m, b, p, r, a: m + b + p + (r + a), main_g, both, recog_p,
            saved_recog, saved_adv)
        return main_g, merged
    return fn


def _recog_param_grad(jcfg):
    """``(params, image, label, lens, frames)`` -> the gradient of the gen
    lesson's genRecog CTC on a generated line with respect to the
    recognizer's own parameters (``hwr_frozen`` off)."""
    tr = JGanTrainer(jcfg)
    return jax.grad(lambda p, image, label, lens, frames: tr._ctc(
        j_mask_frames_to_blank(tr.model.apply({"params": p}, image,
                                              method="recognize"), frames),
        label, lens, tr.w["genRecog"]))


def _variant64_child(conn, from_variant):
    """Compile the float64 JAX pieces of the variant lessons at the tiny
    shapes; run the auto lesson's groups from ``_variant_child``'s record
    of it (its state before, batch and draws); then answer the parent's
    one request, the gen lesson's generated line, with both."""
    jcfg = _variant_cfg()
    c = config_from_dict(dataclasses.asdict(jcfg)).model
    spec = lambda *shape: jax.ShapeDtypeStruct(shape, jnp.float64)
    ints = lambda *shape: jax.ShapeDtypeStruct(shape, jnp.int32)
    T = JGanTrainer(jcfg).gen_spaced_len
    with _jax_float64():
        params = _f64(init_params(c, seed=0))
        enc = _f64(_weights(jcfg)[2])
        auto = jax.jit(_variant_auto_groups(jcfg)).lower(
            params, _f64(init_spectral(c, seed=0)), enc,
            spec(B, 64, W, 1), ints(B, L), ints(B), ints(B),
            spec(B, 64, W, 1), [spec(*s) for s in _noise_shapes(W // 4)],
            spec(B, c.style.style_dim), spec(), spec(), params,
            params).compile(F64_COMPILE)
        gen = jax.jit(_recog_param_grad(jcfg)).lower(
            {"hwr": params["hwr"]}, spec(B, 64, 4 * T, 1), ints(B, L),
            ints(B), ints(B)).compile(F64_COMPILE)
        rec = from_variant.recv()
        st, d, b = rec["before"], rec["draws"], _batches(1)[0]
        image = j_augment.dequantize_image(
            jnp.asarray(quantize_image_u8(b["image"])),
            jnp.asarray(b["width"]))
        groups = _np(auto(
            _f64(st.params), _f64(st.spectral), enc,
            np.asarray(image, np.float64), b["label"], b["label_lengths"],
            b["width"], (b["fg_mask"] > 0.5).astype(np.float64),
            _f64(d["noise"]), _f64(d["vae"]), _f64(d["aug"]["stretch"]),
            _f64(d["aug"]["skew"]), _f64(st.saved_recog),
            _f64(st.saved_adv)))
        req = conn.recv()
        conn.send((groups, _np(gen(*req))))


# -- the JAX side: evaluation on the paper config ------------------------------


def _eval_bank(rng_seed=11, count=3):
    """A style bank with ``count`` filled rows, so the probes interpolate."""
    jcfg = _tiny_gan_cfg()
    rng = np.random.default_rng(rng_seed)
    D = config_from_dict(dataclasses.asdict(jcfg)).model.packed_style_dim()
    bank = np.zeros((jcfg.trainer.prev_style_size, D), np.float32)
    bank[:count] = rng.normal(size=(count, D))
    return bank, count


def _unknown_batch(batch):
    return dict(batch, gt=["$UNKOWN$", "abc", "$UNKOWN$", "de"])


def _eval_child(conn):
    """The paper config's ``eval_step``, ``eval_gen_step``, render pieces,
    ``validate`` over 2 batches and pseudo-labels from ``_weights`` and a
    style bank, the draws each used, and the recognizer's top-2 margins of
    every argmax."""
    _unoptimized_xla()
    jcfg = _tiny_gan_cfg()
    tr = _jax_trainer(jcfg, _weights(jcfg))
    bank, count = _eval_bank()
    tr.state = tr.state.replace(style_bank=jnp.asarray(bank),
                                bank_count=jnp.asarray(count, jnp.int32))
    dr = _Draws(tr, jcfg)
    jm, st, T = tr.model, tr.state, tr.gen_spaced_len
    batches = _batches(2, seed=3)

    def margins(params, image, frames):
        logp = j_mask_frames_to_blank(
            jm.apply({"params": params}, image, method="recognize"), frames)
        top = jax.lax.top_k(logp, 2)[0]
        return top[..., 0] - top[..., 1]

    def gen_frames(params, label, lens, rng):
        krng, _, srng = jax.random.split(rng, 3)
        style = j_gan_trainer.bank_sample(
            st.style_bank, st.bank_count, srng, B, tr.interp_low,
            tr.interp_high, jcfg.model.packed_style_dim())
        counts = jm.apply({"params": params}, label, lens, style, krng,
                          spaced_len=T, method="space")[1]["total_len"]
        return jnp.clip(counts, 1, T)
    margins, gen_frames = jax.jit(margins), jax.jit(gen_frames)
    out = []
    for i, b in enumerate(batches):
        args = [jnp.asarray(b[k]) for k in ("label", "label_lengths")]
        w = jnp.asarray(b["width"])
        image = jnp.asarray(b["image"])
        frames = jnp.clip((w + 3) // 4, 1, W // 4)
        key = jax.random.PRNGKey(1000 + i)
        ev = tr.eval_step(st.params, image, *args, w, 2)
        gen = tr.eval_gen_step(st.params, *args, T, st.style_bank,
                               st.bank_count, key)
        rec = tr._recon_render(st.params, st.spectral, image, *args, w, 2)
        ren = tr.eval_gen_render(st.params, st.spectral, *args, T,
                                 st.style_bank, st.bank_count, key)
        gf = gen_frames(st.params, *args, key)
        out.append(jax.device_get(dict(
            eval=ev, gen=gen, rec=rec, render=ren,
            margin_pred=margins(st.params, image, frames),
            margin_recon=margins(st.params, rec["recon"], frames),
            margin_gen=margins(st.params, ren["img"], gf),
            draws_eval={"noise": dr.noise(jax.random.PRNGKey(0), W // 4)},
            draws_gen=dr.eval_gen(key, count, bank.shape[0]))))

    class Batcher:
        def batches(self, rng, shuffle=False):
            return iter(batches)
    val = tr.validate(Batcher(), 2)
    pseudo = tr.pseudo_label_unknown(_unknown_batch(batches[0]))
    conn.send({"batches": out, "validate": val,
               "pseudo": {k: pseudo[k] for k in ("label", "label_lengths",
                                                 "gt")}})


# -- the fixture: children beside the parent's tests --------------------------


class _Children:
    def __init__(self):
        ctx = multiprocessing.get_context("spawn")
        self.procs, self.conns, self.results = {}, {}, {}
        to64, from_variant = ctx.Pipe()
        for name, target, extra in (
                ("variant", _variant_child, to64),
                ("variant64", _variant64_child, from_variant),
                ("eval", _eval_child, None)):
            mine, theirs = ctx.Pipe()
            args = (theirs,) + ((extra,) if extra is not None else ())
            p = ctx.Process(target=target, args=args, daemon=True)
            p.start()
            theirs.close()
            self.procs[name], self.conns[name] = p, mine
        to64.close()
        from_variant.close()
        self.variant_w = _weights(_variant_cfg())
        self.paper_w = _weights(_tiny_gan_cfg())

    def get(self, name):
        if name not in self.results:
            if not self.conns[name].poll(900):
                raise TimeoutError(f"{name}: no answer")
            self.results[name] = self.conns[name].recv()
        return self.results[name]

    def close(self):
        for p in self.procs.values():
            if p.is_alive():
                p.kill()
            p.join()


@pytest.fixture(scope="module", autouse=True)
def children():
    """The JAX children, started before the first test; and the port's
    CPU kernels deterministic (a threaded backward of the style
    extractor's gathers sums in varying order otherwise) on few threads
    beside them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    torch.use_deterministic_algorithms(True)
    ch = _Children()
    yield ch
    ch.close()
    torch.use_deterministic_algorithms(False)
    torch.set_num_threads(threads)


# -- helpers of the port side -------------------------------------------------


def _named(template, tree, spectral=None):
    """A params-shaped JAX tree (None for masked leaves) -> the port's
    tensors by parameter name, zeros for the masked leaves."""
    def fill(p, g):
        if g is None:
            return jax.tree_util.tree_map(
                lambda a: np.zeros(a.shape, np.float32), p)
        if isinstance(p, dict):
            return {k: fill(v, g.get(k)) for k, v in p.items()}
        return g
    return convert_params(fill(template, tree), spectral)


def _load(pt, st):
    """The port's state set to a slimmed JAX state (weights, ``u``'s, saved
    groups, bank)."""
    s = pt.state
    with torch.no_grad():
        pt.model.load_state_dict(convert_params(st.params, st.spectral))
        for slot in ("saved_recog", "saved_adv"):
            got = convert_params(getattr(st, slot))
            for t, name in zip(getattr(s, slot), s.names):
                t.copy_(got[name])
        s.style_bank.copy_(torch.from_numpy(st.style_bank))
    s.have_saved = bool(st.have_saved)
    s.bank_count = int(st.bank_count)


def _received(rec, opt, b1):
    """The clipped gradient JAX's optimizer ``opt`` took in the lesson:
    ``(mu' - b1 mu) / (1 - b1)``."""
    return jax.tree_util.tree_map(
        lambda a, b: None if a is None else (a - b1 * b) / (1 - b1),
        getattr(rec["after"], opt), getattr(rec["before"], opt),
        is_leaf=lambda g: g is None)


def _check_losses(out, want, where):
    for k, v in want.items():
        if k.endswith("Loss"):
            np.testing.assert_allclose(float(out[k]), float(v),
                                       rtol=LOSS_RTOL, err_msg=f"{where} {k}")


def _check_groups(want, mine, names, where):
    """Each of the port's float64 tensors within ``GRAD_RTOL`` of the JAX
    tensor's largest entry."""
    for name, g in zip(names, mine):
        assert _max_rel(g.numpy(), want[name].numpy()) <= GRAD_RTOL, \
            (where, name)


def _cfg(tmp_path, **trainer):
    cfg = config_from_dict(dataclasses.asdict(_tiny_gan_cfg()))
    cfg.trainer.save_dir = str(tmp_path)
    for k, v in trainer.items():
        setattr(cfg.trainer, k, v)
    return cfg


def _seeded(cfg):
    tr = GanTrainer(cfg, device="cpu")
    tr.init_state(seed=0)
    return tr


def _narrow(batches, width=96):
    """The batches cut to ``width`` columns (the port-only tests' lines:
    half the work of an image lesson)."""
    return [dict(b, image=b["image"][:, :, :width],
                 fg_mask=b["fg_mask"][:, :, :width],
                 width=np.minimum(b["width"], width)) for b in batches]


BATCHES = _narrow(_batches(10, seed=5))


# -- the port's own guarantees --------------------------------------------------


def test_vae_and_unknown_lines_train(tmp_path):
    """A VAE style no longer raises, and a batch with ``$UNKOWN$`` lines
    trains (its lines pseudo-labelled); the lesson logs the KL."""
    jcfg = _tiny_gan_cfg()
    jcfg.model.style.vae = True
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    tr = _seeded(cfg)
    batch = _unknown_batch(BATCHES[0])
    out = tr.run_lesson(["auto", "auto-gen"], iter([batch]))
    assert np.isfinite(float(out["klLoss"])) and float(out["klLoss"]) > 0
    assert tr.state.bank_count == 2


def test_pseudo_labels_keep_empty_decodes(monkeypatch):
    """A batch without ``$UNKOWN$`` lines comes back as the same object; a
    line whose decode is empty stays, with length 0; a decode longer than
    the label bucket is cut to it."""
    tr = _seeded(_cfg("/nonexistent"))
    batch = BATCHES[1]
    assert tr.pseudo_label_unknown(batch) is batch
    monkeypatch.setattr(p_gan_trainer, "ctc_greedy_decode_batch",
                        lambda logp, cs: ["", "b", "x" * (L + 5), "d"])
    out = tr.pseudo_label_unknown(dict(batch, gt=["$UNKOWN$", "b",
                                                  "$UNKOWN$", "d"]))
    assert list(out["label_lengths"]) == [0, batch["label_lengths"][1], L,
                                          batch["label_lengths"][3]]
    assert not out["label"][0].any() and out["gt"][0] == ""
    assert out["gt"][2] == "x" * (L + 5)
    np.testing.assert_array_equal(out["label"][1], batch["label"][1])


def _copy_run_at(batches, pull, src, dst):
    """``batches``, copying the run directory ``src`` to ``dst`` when the
    ``pull``-th batch is asked for: the run as it stood after the lesson
    before the one pulling it."""
    for n, b in enumerate(batches):
        if n == pull:
            shutil.copytree(src, dst)
        yield b


def test_resume_is_bit_for_bit(tmp_path):
    """14 lessons uninterrupted against a fresh trainer resuming the same
    run directory as it stood after lesson 7 (copied when lesson 8 pulls
    its batch, the 6th) for 7 more: every tensor of the state, the SWA
    average and its count, the generator, the text sampler and the log
    equal bit for bit."""
    kw = dict(swa=True, swa_start=3, val_step=7, print_every=0,
              save_step=10 ** 9, save_step_minor=7)
    a = _seeded(_cfg(tmp_path / "a", **kw))
    run = lambda d: str(d / a.cfg.name)
    log_a = a.train(_copy_run_at(BATCHES, 5, run(tmp_path / "a"),
                                 run(tmp_path / "b")),
                    iterations=14, valid=BATCHES[:1], val_batches=1)
    assert p_checkpoint.load_meta(run(tmp_path / "b"),
                                  "checkpoint-latest")["iteration"] == 7
    # train() builds the state from trainer.seed (the frozen perceptual
    # encoder too, which no checkpoint holds), then loads checkpoint-latest
    c = GanTrainer(_cfg(tmp_path / "b", **kw), device="cpu")
    log_c = c.train(iter(BATCHES[5:]), iterations=14, valid=BATCHES[:1],
                    val_batches=1)
    assert c.step == 14
    strip = lambda log: [{k: v for k, v in e.items() if k != "sec_per_iter"}
                         for e in log.entries]
    # the entries up to 7 come from the run directory's train_log.json; at
    # 14 the averages differ (the resumed run's windows hold only lessons
    # 8-14, as in JAX), the validations must not
    assert [e["iteration"] for e in log_c.entries] == [7, 7, 14, 14]
    assert strip(log_c)[:2] == strip(log_a)[:2]
    val = lambda log: {k: v for k, v in log.entries[-1].items()
                       if "val_" in k}
    assert val(log_c) == val(log_a) and "swa_val_gen_CER" in val(log_c)
    _assert_states_equal(a.state_dict(), c.state_dict())
    assert c.swa_n == a.swa_n == 12
    for x, y in zip(a.swa, c.swa):
        assert torch.equal(x, y)


def test_state_dict_round_trip(tmp_path):
    """A checkpoint of a GAN mid-curriculum (saved groups held, the bank
    filling, both separate optimizers) loads into a fresh trainer equal to
    the one saved."""
    jcfg = _variant_cfg()
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    tr = _seeded(cfg)
    it = iter(BATCHES)
    for lesson in tr.curriculum.stages[0][1][3:] + [["no-step", "gen"]]:
        tr.run_lesson(lesson, it)
    assert tr.state.have_saved and tr.state.bank_count == 4
    p_checkpoint.save_checkpoint(str(tmp_path), "x", tr.state_dict())
    other = _seeded(config_from_dict(dataclasses.asdict(jcfg)))
    other.load_state_dict(p_checkpoint.load_checkpoint(str(tmp_path), "x"))
    _assert_states_equal(tr.state_dict(), other.state_dict())


def test_sigint_saves_both_checkpoints(tmp_path):
    """SIGINT during a lesson: the loop finishes it, writes
    ``checkpoint-latest`` (interrupted) and ``checkpoint-latest-swa`` and
    leaves; the handler is restored."""
    cfg = _cfg(tmp_path, swa=True, swa_start=1, val_step=0, print_every=0,
               save_step=10 ** 9, save_step_minor=0)
    tr = _seeded(cfg)

    def batches():
        yield BATCHES[0]
        yield BATCHES[1]
        signal.raise_signal(signal.SIGINT)     # during lesson 4's batch
        yield BATCHES[2]
        yield BATCHES[3]
    before = signal.getsignal(signal.SIGINT)
    tr.train(batches(), iterations=14)
    assert tr.step == 4 and signal.getsignal(signal.SIGINT) is before
    run = str(tmp_path / cfg.name)
    meta = p_checkpoint.load_meta(run, "checkpoint-latest")
    assert meta["interrupted"] is True and meta["iteration"] == 4
    assert p_checkpoint.load_checkpoint(run, "checkpoint-latest")["step"] == 4
    swa_meta = p_checkpoint.load_meta(run, "checkpoint-latest-swa")
    assert swa_meta["swa_n"] == 4
    swa = p_checkpoint.load_checkpoint(run, "checkpoint-latest-swa")
    assert set(swa) == set(tr.state.names)


def test_clobber_refused(tmp_path):
    cfg = _cfg(tmp_path, val_step=0, print_every=0, save_step=10 ** 9,
               save_step_minor=1)
    _seeded(cfg).train(iter(BATCHES), iterations=1)
    with pytest.raises(RuntimeError, match="already contains checkpoints"):
        _seeded(cfg).train(iter(BATCHES), iterations=2, resume=False)


OPTIM = os.path.join("torch", "optim", "")


def test_no_host_sync_between_log_steps(tmp_path, monkeypatch):
    """The loop reads no device value between log steps: no ``item``,
    ``float``, ``int``, ``bool``, ``tolist``, ``numpy`` or ``cpu`` of a
    tensor in any lesson; the log step reads them.  (torch's Adam reads its
    step counters with ``item``: they live on the host unless the
    optimizer is capturable, so those calls are not counted.)"""
    cfg = _cfg(tmp_path, val_step=0, print_every=0, save_step=10 ** 9,
               save_step_minor=0)
    tr = _seeded(cfg)
    calls = []

    def wrap(real, name):
        def read(self, *a, **k):
            if OPTIM not in sys._getframe(1).f_code.co_filename:
                calls.append(name)
            return real(self, *a, **k)
        return read
    for name in ("item", "__float__", "__int__", "__bool__", "tolist",
                 "numpy", "cpu"):
        monkeypatch.setattr(torch.Tensor, name,
                            wrap(getattr(torch.Tensor, name), name))
    per_lesson = []
    run = tr.run_lesson

    def counted(*a, **k):
        n = len(calls)
        out = run(*a, **k)
        per_lesson.append(len(calls) - n)
        return out
    monkeypatch.setattr(tr, "run_lesson", counted)
    n0 = len(calls)
    log = tr.train(iter(BATCHES), iterations=7, log_every=7)
    monkeypatch.undo()
    assert per_lesson == [0] * 7
    assert len(calls) > n0 and log.entries[-1]["iteration"] == 7


def test_swa_update_matches_jax():
    """Three running-mean updates from a start, against JAX's."""
    rng = np.random.default_rng(2)
    ps = [[rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,))]
          for _ in range(4)]
    want = {i: jnp.asarray(a) for i, a in enumerate(ps[0])}
    mine = [torch.from_numpy(a.copy()) for a in ps[0]]
    for n, p in enumerate(ps[1:], start=1):
        want, _ = j_swa_update(want, {i: jnp.asarray(a)
                                      for i, a in enumerate(p)},
                               jnp.float32(n))
        swa_update(mine, [torch.from_numpy(a) for a in p], n)
    for i, t in enumerate(mine):
        np.testing.assert_allclose(t.numpy(), np.asarray(want[i]), rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(mine[0].numpy(), np.mean(
        [p[0] for p in ps], axis=0), atol=1e-6)


@pytest.mark.parametrize("originals", [False, True])
def test_write_strip_matches_jax_png(tmp_path, originals):
    """The port's zlib PNG strip, read back by OpenCV, equals the JAX
    trainer's ``cv2.imwrite`` strip pixel for pixel (originals narrower
    than the lines are padded white)."""
    import cv2
    rng = np.random.default_rng(4)
    imgs = np.tanh(rng.normal(size=(10, 64, 96, 1))).astype(np.float32)
    orig = (np.tanh(rng.normal(size=(10, 64, 80, 1))).astype(np.float32)
            if originals else None)
    JGanTrainer._write_strip(str(tmp_path / "j.png"), imgs, [""] * 10,
                             originals=orig)
    GanTrainer._write_strip(str(tmp_path / "p.png"), imgs, [""] * 10,
                            originals=orig)
    want = cv2.imread(str(tmp_path / "j.png"), cv2.IMREAD_UNCHANGED)
    got = cv2.imread(str(tmp_path / "p.png"), cv2.IMREAD_UNCHANGED)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# -- the loop's schedule against JAX's train --------------------------------


@struct.dataclass
class _StubState:
    step: jnp.ndarray
    params: dict
    spectral: dict


LOOP = dict(iterations=15, log_step=3, val_step=4, save_step=10,
            save_step_minor=3, swa=True, swa_start=5, swa_c_iters=2,
            print_every=6, monitor="val_gen_CER", monitor_mode="min")
# val_gen_CER at the validations of iterations 4, 8 and 12: the best at 8
VAL_GEN_CER = [0.5, 0.25, 0.375]


def _jax_loop_events(tmp_path, monkeypatch):
    cfg = _tiny_gan_cfg()
    cfg.trainer.save_dir = str(tmp_path / "jax")
    for k, v in LOOP.items():
        if k != "iterations":
            setattr(cfg.trainer, k, v)
    events, vals = [], iter(VAL_GEN_CER)
    tr = JGanTrainer(cfg)
    monkeypatch.setattr(j_gan_trainer, "make_batcher", lambda d, s: None)
    monkeypatch.setattr(j_gan_trainer, "forever",
                        lambda b, seed: itertools.repeat({}))
    monkeypatch.setattr(j_gan_trainer, "Prefetcher", iter)
    monkeypatch.setattr(tr, "init_state", lambda first, seed: _StubState(
        jnp.zeros((), jnp.int32), {"w": jnp.zeros(3)}, {}))

    def run_lesson(lesson, it, iteration):
        events.append(("lesson", iteration, "+".join(lesson)))
        tr.state = tr.state.replace(step=tr.state.step + 1, params={
            "w": tr.state.params["w"] + iteration})
        return {"loss": 1.0}
    monkeypatch.setattr(tr, "run_lesson", run_lesson)

    def validate(batcher, n, params=None):
        events.append(("validate", "swa" if params is not None else "model"))
        return {"val_gen_CER": VAL_GEN_CER[0] if params is not None
                else next(vals)}
    monkeypatch.setattr(tr, "validate", validate)
    monkeypatch.setattr(tr, "_dump_samples",
                        lambda i, v, d: events.append(("dump", i)))
    swa = tr._swa_step
    monkeypatch.setattr(tr, "_swa_step",
                        lambda: events.append(("swa",)) or swa())
    monkeypatch.setattr(
        j_checkpoint, "save_checkpoint", lambda d, name, tree, meta=None:
        events.append(("save", name, meta["iteration"], meta.get("swa_n"))))
    log = tr.train(iterations=LOOP["iterations"],
                   on_log=lambda e: events.append(("log", e.get("iteration"))))
    return events, tr.swa_n, np.asarray(tr.swa_params["w"]), log


def _port_loop_events(tmp_path, monkeypatch):
    cfg = _cfg(tmp_path / "port", **{k: v for k, v in LOOP.items()
                                     if k != "iterations"})
    events, vals = [], iter(VAL_GEN_CER)
    tr = GanTrainer(cfg, device="cpu")
    tr.model = types.SimpleNamespace(state_dict=lambda: {})
    w = torch.zeros(3)
    tr.state = types.SimpleNamespace(step=0, params=[w], names=["w"])
    tr.state_dict = lambda: {}

    def run_lesson(lesson, it, iteration):
        events.append(("lesson", iteration, "+".join(lesson)))
        tr.state.step += 1
        w.add_(iteration)
        return {"loss": torch.ones(())}
    tr.run_lesson = run_lesson

    def validate(batches, n, params=None):
        events.append(("validate", "swa" if params is not None else "model"))
        return {"val_gen_CER": VAL_GEN_CER[0] if params is not None
                else next(vals)}
    tr.validate = validate
    tr._dump_samples = lambda i, v, d: events.append(("dump", i))
    swa = tr._swa_step
    tr._swa_step = lambda: events.append(("swa",)) or swa()
    monkeypatch.setattr(
        p_checkpoint, "save_checkpoint", lambda d, name, obj, meta=None:
        events.append(("save", name, meta["iteration"], meta.get("swa_n"))))
    log = tr.train(itertools.repeat({}), iterations=LOOP["iterations"],
                   valid=[{}],
                   on_log=lambda e: events.append(("log", e.get("iteration"))))
    return events, tr.swa_n, tr.swa[0].numpy(), log


def test_loop_schedule_matches_jax(tmp_path, monkeypatch):
    """``GanTrainer.train`` against JAX's over 15 iterations, both with
    their lessons and validation stubbed (deterministic values): the same
    sequence of lessons (and their 0-based iteration), log records,
    validations (the SWA weights' once SWA has started), SWA steps, sample
    dumps and checkpoint saves (``-swa`` beside each, ``swa_n`` in the
    metadata), ``model_best`` at the same iteration, the same SWA count and
    average."""
    want, n_j, w_j, log_j = _jax_loop_events(tmp_path, monkeypatch)
    monkeypatch.undo()
    got, n_p, w_p, log_p = _port_loop_events(tmp_path, monkeypatch)
    assert got == want
    assert ("save", "model_best", 8, 2) in got
    assert n_p == n_j == 6
    np.testing.assert_allclose(w_p, w_j, rtol=1e-6)
    strip = lambda log: [{k: v for k, v in e.items() if k != "sec_per_iter"}
                         for e in log.entries]
    assert strip(log_p) == strip(log_j)


# -- parity with the JAX trainer -------------------------------------------------


def _variant_pt(children):
    return _port_trainer(_variant_cfg(), children.variant_w)


def test_variant_lessons_from_the_same_state_match_jax(children):
    """The variant config's gen, auto and disc lessons, each from JAX's
    state before it, with its draws: the saved groups (gen) or the gradient
    handed to the optimizer (auto: the unbalanced merge with the KL and the
    recognizer's direct gradient; disc: real and fake through the cond
    head), the losses and the ``u``'s."""
    recs = children.get("variant")["records"]
    pt = _variant_pt(children)
    template = children.variant_w[0]
    b1 = _variant_cfg().optimizer.betas[0]
    it = iter(_batches(2))
    for i, rec in enumerate(recs):
        _load(pt, rec["before"])
        draws = _torch_draws(rec["draws"])
        kind = rec["kind"]
        if kind == "gen":
            lab = rec["labels"]
            out = pt.step_gen_nostep(lab["label"], lab["label_lengths"],
                                     pt.gen_spaced_len, draws)
            for mine, slot in ((out["recog_g"], "saved_recog"),
                               (out["adv_g"], "saved_adv")):
                want = _named(template, getattr(rec["after"], slot))
                err = _rel_l2([g.numpy() for g in mine],
                              [want[n].numpy() for n in pt.state.names])
                assert err <= KINK_L2, (i, slot, err)
        else:
            b = next(it)
            args = [_u8(b["image"]), b["label"], b["label_lengths"]]
            if kind == "auto":
                out = pt.step_auto(*args, b["fg_mask"] > 0.5, b["width"], 2,
                                   draws=draws)
                grads, opt, part = out["merged"], "opt_main", "main"
            else:
                out = pt.step_disc(*args, b["width"], 2, draws=draws)
                grads, opt, part = out["grads"], "opt_disc", "disc"
            want = _named(template, _received(rec, opt, b1))
            mine = [(n, torch.clamp(g, -2.0, 2.0).numpy())
                    for n, g, l in zip(pt.state.names, grads,
                                       pt.state.labels) if l == part]
            err = _rel_l2([g for _, g in mine],
                          [want[n].numpy() for n, _ in mine])
            assert err <= KINK_L2, (i, kind, err)
        assert {k for k in out if k.endswith("Loss")} == \
            {k for k in rec["out"] if k.endswith("Loss")}
        _check_losses(out, rec["out"], f"lesson {i}")
        spec = convert_params(rec["after"].params, rec["after"].spectral)
        for name, t in pt.model.state_dict().items():
            if name.endswith(".u"):
                np.testing.assert_allclose(t.numpy(), spec[name].numpy(),
                                           atol=1e-6, err_msg=(i, name))


@pytest.mark.parametrize("tag, opt, moves", [
    ("auto-style", "gen_only", "generator."),
    ("style-ex-only", "style_ex", "style_extractor.")])
def test_separate_optimizer_lessons(children, tag, opt, moves):
    """An ``auto-style`` / ``style-ex-only`` lesson through ``run_lesson``
    from the state before JAX's auto lesson: its optimizer steps JAX's
    partition (the separate optimizer's ``on`` leaves), takes the merged
    gradient JAX's auto lesson formed, and moves nothing outside it."""
    res = children.get("variant")
    rec = res["records"][1]
    assert rec["kind"] == "auto"
    pt = _variant_pt(children)
    _load(pt, rec["before"])
    s = pt.state
    on = {n for n, t in convert_params(res["on"][opt]).items() if t.all()}
    assert on and all(n.startswith(moves) for n in on)
    optimizer = getattr(s, "opt_" + opt)
    assert {s.names[i] for i in optimizer.index} == on
    before = [p.detach().clone() for p in s.params]
    pt.run_lesson(["auto", "auto-gen", tag], iter(_batches(1)), iteration=1,
                  draws=_torch_draws(rec["draws"]))
    moved = {n for n, p, q in zip(s.names, s.params, before)
             if not torch.equal(p.detach(), q)}
    assert moved and moved <= on
    b1 = _variant_cfg().optimizer.betas[0]
    want = _named(children.variant_w[0], _received(rec, "opt_main", b1))
    got = [(n, optimizer.optimizer.state[p]["exp_avg"].numpy() / (1 - b1))
           for n, p in zip(s.names, s.params) if n in on]
    err = _rel_l2([g for _, g in got], [want[n].numpy() for n, _ in got])
    assert err <= KINK_L2, err


def _spy(mp, owner, name, record):
    """Wrap ``owner.name`` so each call first passes its arguments and
    result to ``record``."""
    real = getattr(owner, name)

    def spy(*a, **k):
        out = real(*a, **k)
        record(a, k, out)
        return out
    mp.setattr(owner, name, spy)


def test_variant_groups_float64_match_jax(children, float64):
    """The groups the branches change, in float64 from JAX's states: the
    gen lesson's direct recognizer gradient (``hwr_frozen`` off), and the
    auto lesson's main group (reconstruction and KL through one VJP) and
    unbalanced merge (with the recognizer's direct reconRecog gradient and
    the saved groups), on the same line, augmentation draws, noise and
    eps."""
    recs = children.get("variant")["records"]
    pt = _variant_pt(children)
    pt.model.double()
    pt.encoder.double()
    s = pt.state
    seen = {}

    # gen: the recognizer's own gradient of the genRecog CTC, on the line
    # the recognizer read and the frames it was masked to
    rec = recs[0]
    _load(pt, rec["before"])
    lab = rec["labels"]
    with pytest.MonkeyPatch.context() as mp:
        _spy(mp, pt.model, "recognize",
             lambda a, k, out: seen.setdefault("gen_image", a[0]))
        _spy(mp, p_gan_trainer, "mask_frames_to_blank",
             lambda a, k, out: seen.setdefault("gen_frames", a[1]))
        gen = pt.step_gen_nostep(lab["label"], lab["label_lengths"],
                                 pt.gen_spaced_len,
                                 _torch_draws(rec["draws"]))
    assert gen["recog_g"][0].dtype == torch.float64
    children.conns["variant64"].send((
        _f64({"hwr": rec["before"].params["hwr"]}),
        seen["gen_image"].detach().numpy(), lab["label"],
        lab["label_lengths"], seen["gen_frames"].numpy().astype(np.int32)))

    # auto: the main group (+ KL) and the unbalanced merge
    rec = recs[1]
    _load(pt, rec["before"])
    s.saved_recog[:] = [g.double() for g in s.saved_recog]
    s.saved_adv[:] = [g.double() for g in s.saved_adv]
    b = _batches(1)[0]
    out = pt.step_auto(_u8(b["image"]), b["label"], b["label_lengths"],
                       b["fg_mask"] > 0.5, b["width"], 2,
                       draws=_torch_draws(rec["draws"]))
    (main_g, merged), recog_p = children.get("variant64")

    hwr = convert_params({"hwr": recog_p["hwr"]})
    names = [n for n in s.names if n in hwr]
    assert names
    _check_groups(hwr, [g for n, g in zip(s.names, gen["recog_g"])
                        if n in hwr], names, "gen recog")
    for label, tree, mine in (("main", main_g, out["main_g"]),
                              ("merged", merged, out["merged"])):
        _check_groups(convert_params(tree), mine, s.names, label)

def _eval_pt(children):
    pt = _port_trainer(_tiny_gan_cfg(), children.paper_w)
    bank, count = _eval_bank()
    pt.state.style_bank.copy_(torch.from_numpy(bank))
    pt.state.bank_count = count
    return pt


def _check_argmax(got, want, margin, where):
    """Equal wherever JAX's top-2 margin exceeds ``MARGIN``."""
    ok = np.asarray(margin) > MARGIN
    assert ok.mean() > 0.9, where
    np.testing.assert_array_equal(got.numpy()[ok], np.asarray(want)[ok],
                                  err_msg=where)


def test_eval_steps_match_jax(children):
    """``eval_step`` and ``eval_gen_step``, and the sample dumps' renders,
    with JAX's draws on the same state (weights, a style bank of 3 rows):
    losses, reconstructions, generated lines, discriminator scores and
    argmaxes."""
    res = children.get("eval")
    pt = _eval_pt(children)
    T = pt.gen_spaced_len
    for i, (b, r) in enumerate(zip(_batches(2, seed=3), res["batches"])):
        d_eval = _torch_draws(r["draws_eval"])
        d_gen = _torch_draws(r["draws_gen"])
        args = (b["label"], b["label_lengths"])
        ev = pt.eval_step(b["image"], *args, b["width"], 2, d_eval)
        assert {k for k in ev if k.startswith("val_")} == \
            {k for k in r["eval"] if k.startswith("val_")}
        for k, v in r["eval"].items():
            if k.startswith("val_"):
                np.testing.assert_allclose(float(ev[k]), float(v),
                                           rtol=LOSS_RTOL, err_msg=(i, k))
        _check_argmax(ev["pred_am"], r["eval"]["pred_am"], r["margin_pred"],
                      (i, "pred"))
        _check_argmax(ev["recon_am"], r["eval"]["recon_am"],
                      r["margin_recon"], (i, "recon"))
        gen = pt.eval_gen_step(*args, T, draws=d_gen)
        _check_argmax(gen["gen_am"], r["gen"]["gen_am"], r["margin_gen"],
                      (i, "gen"))
        rec = pt._recon_render(b["image"], *args, b["width"], 2, d_eval)
        ren = pt.eval_gen_render(*args, T, draws=d_gen)
        for got, want in ((rec["recon"], r["rec"]["recon"]),
                          (ren["img"], r["render"]["img"])):
            assert np.abs(got.numpy() - want).max() <= EVAL_ATOL, i
        np.testing.assert_allclose(float(rec["d_real"]),
                                   float(r["rec"]["d_real"]), rtol=LOSS_RTOL,
                                   atol=1e-6)
        np.testing.assert_allclose(float(ren["d_fake"]),
                                   float(r["render"]["d_fake"]),
                                   rtol=LOSS_RTOL, atol=1e-6)


def test_validate_matches_jax(children):
    """``validate`` over 2 batches with JAX's draws: every ``val_*`` loss
    within rtol 1e-4, the CERs and the WER equal."""
    res = children.get("eval")
    pt = _eval_pt(children)
    draws = [(_torch_draws(r["draws_eval"]), _torch_draws(r["draws_gen"]))
             for r in res["batches"]]
    got = pt.validate(iter(_batches(2, seed=3)), 2, draws=draws)
    want = res["validate"]
    assert set(got) == set(want) >= {"val_gen_CER", "val_recon_CER",
                                     "val_CER", "val_WER"}
    for k, v in want.items():
        if "CER" in k or "WER" in k:
            assert got[k] == v, k
        else:
            np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, err_msg=k)


def test_pseudo_labels_match_jax(children):
    """``$UNKOWN$`` lines relabelled from the same weights: labels, lengths
    and text equal to JAX's."""
    want = children.get("eval")["pseudo"]
    got = _eval_pt(children).pseudo_label_unknown(
        _unknown_batch(_batches(2, seed=3)[0]))
    np.testing.assert_array_equal(got["label"], want["label"])
    np.testing.assert_array_equal(got["label_lengths"],
                                  want["label_lengths"])
    assert got["gt"] == want["gt"] and "$UNKOWN$" not in got["gt"]
