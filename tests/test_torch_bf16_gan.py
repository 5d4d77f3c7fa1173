"""Port parity for the GAN's bfloat16 mixed-precision lessons: the port's
``GanTrainer`` with ``model.compute_dtype = "bfloat16"`` against the JAX
``GanTrainer``'s bf16 lessons at ``test_trainers._tiny_gan_cfg``'s shapes
(the first four lessons of the paper curriculum: count, no-step gen, auto
auto-gen, disc), each from the same state, with the same draws; and
``train -r -a model.compute_dtype=bfloat16`` over the port's float32 GAN
run (``scripts/continue_gan_bf16.sh``'s flow).

Both packages start from the weights of ``tests/test_torch_gan_trainer.py``
(the port's seeded init with every bias and norm scale jittered, a seeded
perceptual encoder).  The JAX bf16 lessons run as they are (compiled ahead
in parallel threads); their draws are recomputed from the state's key as
the steps split it and injected into the port (the noise planes drawn in
bf16, as JAX draws them).  bf16 rounds each conv's sum and the two
frameworks sum in other orders, so each tolerance is a multiple
(``RATIO``, at most 3) of the JAX package's own bf16-vs-float32 distance:
the JAX float32 lesson from the same state with the same draws (its noise
planes the bf16 ones, injected while it is traced).  The spectral norms'
power iteration stays float32 in all three, so the ``u``'s a lesson
leaves are held as the float32 tests hold them (1e-6).
"""

import copy
import dataclasses
import hashlib
import json
import multiprocessing
import pathlib
import threading
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import threadpoolctl
import torch
from flax import linen as nn

from handwriting_line_generation_tpu.data.datasets import quantize_image_u8
from handwriting_line_generation_tpu.models.layers import \
    NoiseInjection as JNoiseInjection
from handwriting_line_generation_tpu.training.gan_trainer import \
    GanTrainer as JGanTrainer
from handwriting_line_generation_tpu.training.train_state import \
    create_gan_state as j_create_gan_state
from handwriting_line_generation_tpu_torch import train as p_train
from handwriting_line_generation_tpu_torch.config import config_from_dict
from handwriting_line_generation_tpu_torch.convert import (
    convert_autoencoder_params, convert_params,
)
from handwriting_line_generation_tpu_torch.init import (
    init_autoencoder_params, init_params, init_spectral,
)
from handwriting_line_generation_tpu_torch.models.hw_with_style import \
    HWWithStyle
from handwriting_line_generation_tpu_torch.ops.align import viterbi_align
from handwriting_line_generation_tpu_torch.ops.augment import \
    dequantize_image
from handwriting_line_generation_tpu_torch.ops.ctc import \
    mask_frames_to_blank as p_mask_frames_to_blank
from handwriting_line_generation_tpu_torch.training import \
    gan_trainer as p_gan
from handwriting_line_generation_tpu_torch.utils.checkpoint import \
    extract_subtree
from test_torch_gan_trainer import (
    B, F64_COMPILE, L, W, _JaxRun, _batches, _by_name, _jitter, _load, _np, _rel_l2,
    _slim, _torch_draws, _trainer,
)
from test_torch_jax_resume import (
    CONFIGS as CONFIGS_RUN, RUN, _gan_widths,
)
from test_trainers import _tiny_gan_cfg

pytestmark = pytest.mark.compile   # the JAX lessons' compiles dominate

REPO = pathlib.Path(__file__).resolve().parents[1]
RATIO = 3.0
KINDS = ("count", "gen", "auto", "disc")
SAMPLES = 3                 # inputs a lesson runs on from the same state
U_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's side on one torch thread and one BLAS thread (several
    test processes share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


def _host(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _dev(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _f32(planes):
    return [np.asarray(p, np.float32) for p in planes]


def _setup():
    """The bf16 config and the weights both packages start from (as
    ``tests/test_torch_gan_trainer.py`` makes them)."""
    jcfg = _tiny_gan_cfg()
    jcfg.model.compute_dtype = "bfloat16"
    pcfg = config_from_dict(dataclasses.asdict(jcfg))
    rng = np.random.default_rng(7)
    params = _jitter(init_params(pcfg.model, seed=0), rng)
    spectral = init_spectral(pcfg.model, seed=0)
    enc = _jitter(init_autoencoder_params("2tight", 0, seed=1)["params"]
                  ["encoder"], rng)
    return jcfg, pcfg, params, spectral, enc


def _jax_trainer(jcfg, dtype, params, spectral, enc):
    cfg = copy.deepcopy(jcfg)
    cfg.model.compute_dtype = dtype
    tr = JGanTrainer(cfg)
    tr.encoder_params = {"params": enc}
    (tr.state, tr.main_tx, tr.disc_tx, tr.gen_only_tx,
     tr.style_ex_tx) = j_create_gan_state(
        cfg, {"params": _dev(params), "spectral": _dev(spectral)},
        jax.random.PRNGKey(1))
    return tr


def _step(kind):
    return "step_gen_nostep" if kind == "gen" else f"step_{kind}"


def _dynamic(kind, args):
    """A lesson's arguments without its static ones (a compiled step takes
    only the others)."""
    static = {"count": (4,), "gen": (2,), "auto": (5, 6, 7),
              "disc": (4,)}[kind]
    return [jnp.asarray(a) if isinstance(a, np.ndarray) else a
            for i, a in enumerate(args) if i not in static]


def _lower(tr, kind, args, planes=None):
    """``JGanTrainer.<step>`` lowered at ``args``; ``planes``: the
    generator's noise planes, injected while it is traced."""
    planes = None if planes is None else [jnp.asarray(p) for p in planes]

    def icpt(next_fun, a, kw, ctx):
        if (planes is not None and isinstance(ctx.module, JNoiseInjection)
                and ctx.method_name == "__call__"):
            return next_fun(a[0], None, noise=planes.pop(0))
        return next_fun(*a, **kw)
    with nn.intercept_methods(icpt):
        lw = getattr(JGanTrainer, _step(kind)).lower(
            tr, tr.state, *[jnp.asarray(a) if isinstance(a, np.ndarray)
                            else a for a in args])
    assert not planes, (kind, len(planes))
    return lw


def _compile_in_thread(lowered, out, key, threads):
    """Compile without LLVM's optimizations (half the time), in a thread
    of its own: XLA compiles outside the GIL."""
    threads.append(threading.Thread(target=lambda: out.__setitem__(
        key, lowered.compile(F64_COMPILE))))
    threads[-1].start()


def _sample_state(kind, state, s):
    """The state sample ``s`` of a lesson starts from: the trajectory's,
    except for the gen and disc lessons' later samples, whose style bank
    is filled with seeded normal rows (this init's generator hardly reads
    its text, so another text would give the same lines: a style does
    not)."""
    if s == 0 or kind not in ("gen", "disc"):
        return state
    n, d = state.style_bank.shape
    bank = np.random.default_rng(100 + s).normal(size=(n, d))
    return state.replace(style_bank=jnp.asarray(bank, jnp.float32),
                         bank_count=jnp.asarray(n, jnp.int32))


class _Inputs:
    """Each lesson's ``SAMPLES`` inputs (texts; batches with the count and
    auto lessons' alignments) and the trajectory's planned draws, built
    alike in the parent and in the child (``digest`` compares them).  The
    count and auto lessons read an alignment given with their batch (the
    ``spaced_loc`` cache's path), the port's float32 recognizer's Viterbi
    path: bf16 log-probs flip a few Viterbi decisions in both packages (7
    of 768 positions of the count batch between JAX's bf16 and float32
    runs), a discrete change of the count targets that no tolerance on
    the losses could absorb."""

    noise = _JaxRun.noise
    _noise_fn = _JaxRun._noise_fn
    draws = _JaxRun.draws

    def __init__(self, jcfg, pcfg, params, spectral, tr):
        self.jcfg, self.pcfg, self.tr = jcfg, pcfg, tr
        self.params, self.spectral = params, spectral
        self.noise_fns = {}
        self.texts = [tr.text.get_batch(label_len=L)
                      for _ in range(SAMPLES)]
        self.batches = _batches(3 + 3 * (SAMPLES - 1))
        self.spaced = self._alignments()
        self.gen_spaced_len = tr.gen_spaced_len
        self.samples = {k: [self.args(k, s) for s in range(SAMPLES)]
                        for k in KINDS}

    def plan(self):
        """Each lesson's draws on the trajectory, split from the state's
        key as the steps split it (the key after a step is the first of
        its split; the auto lesson pushes ``B / 2`` styles into the
        bank), and the keys."""
        state = self.tr.state
        self.planned, self.keys, rng, count = [], [], state.rng, 0
        for kind in KINDS:
            st = types.SimpleNamespace(rng=rng, bank_count=count,
                                       style_bank=state.style_bank)
            self.planned.append(self.draws(kind, st))
            self.keys.append(np.asarray(rng))
            rng = jax.random.split(rng)[0]
            count += B // 2 if kind == "auto" else 0
        self.planes = {k: _f32(d["noise"]) for k, d in
                       zip(KINDS, self.planned) if "noise" in d}

    def digest(self):
        h = hashlib.sha256()
        for a in jax.tree_util.tree_leaves((self.samples, self.planes)):
            if isinstance(a, np.ndarray):
                h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()

    def batch(self, kind, s):
        """Sample ``s``'s batch of an image lesson: the trajectory's
        (batches 0, 1, 2 for count, auto, disc) first, then others."""
        j = KINDS.index(kind) - (kind != "count")
        return self.batches[j if s == 0 else 3 + 3 * (s - 1) + j]

    def args(self, kind, s):
        """Sample ``s``'s arguments of a lesson after the state, its
        static ones in place (numpy)."""
        if kind == "gen":
            t = self.texts[s]
            return (t["label"], t["label_lengths"], self.gen_spaced_len)
        b = self.batch(kind, s)
        head = (quantize_image_u8(b["image"]), b["label"],
                b["label_lengths"])
        if kind == "count":
            return head + (b["width"], 2, self.spaced[id(b)])
        if kind == "auto":
            return head + (b["fg_mask"] > 0.5, b["width"], 2, "main", 0,
                           self.spaced[id(b)])
        return head + (b["width"], 2, None)

    def _alignments(self):
        """The port's float32 recognizer's Viterbi path of each batch."""
        cfg = copy.deepcopy(self.pcfg.model)
        cfg.compute_dtype = "float32"
        model = HWWithStyle(cfg)
        model.load_state_dict(convert_params(self.params, self.spectral))
        out = {}
        with torch.no_grad():
            for b in self.batches:
                width = torch.from_numpy(b["width"])
                image = dequantize_image(torch.from_numpy(
                    quantize_image_u8(b["image"])), width)
                frames = torch.clamp(torch.ceil(width / 4.0).long(), 1,
                                     W // 4)
                pred = p_mask_frames_to_blank(model.recognize(image), frames)
                out[id(b)] = viterbi_align(
                    pred, torch.from_numpy(b["label"]),
                    torch.from_numpy(b["label_lengths"])).numpy()
        return out


def _f32_child(conn):
    """The JAX float32 lessons, in a process of its own so that their
    tracing runs beside the parent's bf16 tracing: builds the same inputs
    and noise planes, compiles the four steps (the planes injected), then
    answers each ``(kind, states' leaves)`` with every sample's outputs,
    the slimmed state after sample 0 and the inputs' digest."""
    jcfg, pcfg, params, spectral, enc = _setup()
    tr = _jax_trainer(jcfg, "float32", params, spectral, enc)
    inp = _Inputs(jcfg, pcfg, params, spectral, tr)
    inp.plan()
    compiled, threads = {}, []
    for kind in ("auto", "gen", "disc", "count"):
        _compile_in_thread(_lower(tr, kind, inp.samples[kind][0],
                                  inp.planes.get(kind)),
                           compiled, kind, threads)
    for t in threads:
        t.join()
    treedef = jax.tree_util.tree_structure(tr.state)
    while (msg := conn.recv()) is not None:
        kind, states = msg
        outs = []
        for leaves, args in zip(states, inp.samples[kind]):
            st, o = compiled[kind](
                _dev(jax.tree_util.tree_unflatten(treedef, leaves)),
                *_dynamic(kind, args))
            outs.append(_np(o))
            after = after if outs[1:] else _slim(st, params["hwr"])
        conn.send((outs, after, inp.digest()))


class _Run16(_Inputs):
    """The JAX bf16 lessons in order, and from each bf16 state the same
    lesson on ``SAMPLES`` inputs in bf16 and (in a child process) in
    float32; what each saw and left."""

    def __init__(self):
        ctx = multiprocessing.get_context("spawn")
        self.conn, child_end = ctx.Pipe()
        child = ctx.Process(target=_f32_child, args=(child_end,),
                            daemon=True)
        child.start()
        child_end.close()
        try:
            self._build()
        finally:
            self.conn.send(None)
            child.join(60)
            if child.is_alive():
                child.kill()

    def _build(self):
        jcfg, pcfg, params, spectral, enc = _setup()
        self.encoder_state = extract_subtree(
            convert_autoencoder_params({"encoder": enc}), "encoder")
        tr = _jax_trainer(jcfg, "bfloat16", params, spectral, enc)
        super().__init__(jcfg, pcfg, params, spectral, tr)
        compiled, threads = {}, []
        _compile_in_thread(_lower(tr, "auto", self.samples["auto"][0]),
                           compiled, "auto", threads)
        self.plan()
        for kind in ("gen", "disc", "count"):
            _compile_in_thread(_lower(tr, kind, self.samples[kind][0]),
                               compiled, kind, threads)
        for t in threads:
            t.join()

        hwr, self.records = params["hwr"], []
        before = tr.state
        for i, kind in enumerate(KINDS):
            # the draws were planned from this key
            np.testing.assert_array_equal(np.asarray(before.rng),
                                          self.keys[i])
            states = [_sample_state(kind, before, s) for s in range(SAMPLES)]
            draws = [self.planned[i]] + [
                self.draws(kind, st) if kind in ("gen", "disc")
                else self.planned[i] for st in states[1:]]
            self.conn.send((kind, [[np.asarray(a) for a in
                                    jax.tree_util.tree_leaves(st)]
                                   for st in states]))
            outs = []
            for st, args in zip(states, self.samples[kind]):
                st, o = compiled[kind](_dev(_host(st)),
                                       *_dynamic(kind, args))
                outs.append(_np(o))
                after = after if outs[1:] else st
            outs32, after32, digest = self.conn.recv()
            assert digest == self.digest()
            self.records.append(dict(
                kind=kind, draws=draws,
                outs={"bfloat16": outs, "float32": outs32},
                befores=[_slim(st, hwr) for st in states],
                after={"bfloat16": _slim(after, hwr), "float32": after32}))
            before = after
        self.tr = self.noise_fns = None

    def full(self, params):
        """Slimmed params with the recognizer's leaves back."""
        return {**params, "hwr": self.params["hwr"]}


@pytest.fixture(scope="module")
def run16():
    return _Run16()


def _port_draws(draws):
    d = dict(draws)
    if "noise" in d:
        d["noise"] = _f32(d["noise"])
    return _torch_draws(d)


def _grads_from_moments(run, rec, dtype, opt, b1):
    """The clipped gradient a lesson's Adam took, read back from its first
    moments: ``(mu' - b1 mu) / (1 - b1)``, by parameter name."""
    mu = jax.tree_util.tree_map(
        lambda a, b: None if a is None else (a - b1 * b) / (1 - b1),
        getattr(rec["after"][dtype], opt), getattr(rec["befores"][0], opt),
        is_leaf=lambda g: g is None)
    return _by_name(run, mu)


def _port_lesson(pt, run, kind, s, draws):
    """The port's lesson ``kind`` on sample ``s``'s inputs (the state
    loaded by the caller)."""
    args = run.args(kind, s)
    if kind == "gen":
        return pt.step_gen_nostep(*args, draws)
    if kind == "count":
        return pt.step_count(*args[:5], spaced_label=args[5], draws=draws)
    if kind == "auto":
        return pt.step_auto(*args[:6], spaced_label=args[8], draws=draws)
    return pt.step_disc(*args[:5], draws=draws)


@pytest.mark.parametrize("i", range(4), ids=KINDS)
def test_bf16_lesson_matches_jax(run16, i):
    """One lesson from JAX's bf16 state before it, with its draws, each
    held within ``RATIO`` times the distance of JAX's float32 lesson from
    its bf16 one: the gradients it produces on the trajectory's input
    (the gen lesson's genRecog and genAdv groups; the gradient the count,
    auto and disc lessons' Adam took, read back from its first moments),
    relative L2 over the stepped partition; and every loss, as the
    median over ``SAMPLES`` inputs from the same state of the port's
    distance from JAX's bf16 value against the median of JAX's float32
    value's.  A single scalar is no yardstick: two bf16 runs of a mean of
    discriminator scores near zero (``generatorLoss``) differ from each
    other as much as from the float32 run, in either direction; and the
    median passes over a sample where the spacer's bf16 counts round to
    another line length in one package than in the other (which frames
    CTC reads: 0.9% of ``genRecogLoss`` in one of the gen lesson's four
    samples, where JAX's float32 lesson rounds as its bf16 one does).  The ``u``'s the lesson leaves
    within ``U_ATOL`` of JAX's (a float32 power iteration in every
    dtype); every gradient and ``u`` float32."""
    run, rec = run16, run16.records[i]
    kind = rec["kind"]
    pt = _trainer(run)
    ratios, losses = {}, []
    for s in range(SAMPLES):
        _load(pt, run, rec["befores"][s])
        out = _port_lesson(pt, run, kind, s, _port_draws(rec["draws"][s]))
        losses.append({k: float(v) for k, v in out.items()
                       if k.endswith("Loss")})
        if s == 0:
            first = out
            u = {n: t.clone() for n, t in pt.model.state_dict().items()
                 if n.endswith(".u")}
    out = first
    if kind == "gen":
        names = pt.state.names
        for mine, slot in ((out["recog_g"], "saved_recog"),
                           (out["adv_g"], "saved_adv")):
            assert all(g.dtype == torch.float32 for g in mine), slot
            want, ref = (_by_name(run, getattr(rec["after"][d], slot))
                         for d in ("bfloat16", "float32"))
            err = _rel_l2([g.numpy() for g in mine],
                          [want[n].numpy() for n in names])
            own = _rel_l2([ref[n].numpy() for n in names],
                          [want[n].numpy() for n in names])
            ratios[slot] = err / own
            assert err <= RATIO * own, (slot, err, own)
    else:
        grads, opt, part = {
            "count": (out.get("grads"), "opt_main", "main"),
            "auto": (out.get("merged"), "opt_main", "main"),
            "disc": (out.get("grads"), "opt_disc", "disc")}[kind]
        betas = (run.jcfg.optimizer_discriminator.betas if kind == "disc"
                 else run.jcfg.optimizer.betas)
        want, ref = (_grads_from_moments(run, rec, d, opt, betas[0])
                     for d in ("bfloat16", "float32"))
        mine = [(n, torch.clamp(g, -2.0, 2.0).numpy())
                for n, g, lab in zip(pt.state.names, grads, pt.state.labels)
                if lab == part]
        assert all(g.dtype == np.float32 for _, g in mine)
        err = _rel_l2([g for _, g in mine],
                      [want[n].numpy() for n, _ in mine])
        own = _rel_l2([ref[n].numpy() for n, _ in mine],
                      [want[n].numpy() for n, _ in mine])
        ratios["gradient"] = err / own
        assert err <= RATIO * own, (kind, err, own)
    o16, o32 = rec["outs"]["bfloat16"], rec["outs"]["float32"]
    for k in losses[0]:
        err = np.median([abs(p[k] - float(a[k]))
                         for p, a in zip(losses, o16)])
        own = np.median([abs(float(b[k]) - float(a[k]))
                         for a, b in zip(o16, o32)])
        ratios[k] = err / own
        assert err <= RATIO * own, (k, err, own)
    spec = convert_params(run.full(rec["after"]["bfloat16"].params),
                          rec["after"]["bfloat16"].spectral)
    for name, t in u.items():
        assert t.dtype == torch.float32, name
        np.testing.assert_allclose(t.numpy(), spec[name].numpy(),
                                   rtol=0, atol=U_ATOL, err_msg=name)
    print(f"bf16 {kind} lesson ratios:", json.dumps(
        {k: round(float(v), 3) for k, v in ratios.items()}))


def _moments(opt):
    """Every Adam moment tensor of a ``PartitionAdam``."""
    return [v for st in opt.optimizer.state_dict()["state"].values()
            for k, v in st.items() if k.startswith("exp_avg")]


def test_bf16_cycle_keeps_float32_state(run16, monkeypatch):
    """The port's four lessons through ``run_lesson`` in bf16 (live
    alignment, its own draws): finite losses; every parameter, saved
    group, Adam moment, bank row and ``u`` float32; CTC fed float32
    log-probs, once in each of the gen and auto lessons; every ``u``
    unit-norm, and moved unless it has one entry; the frozen recognizer and perceptual encoder
    bit-unchanged."""
    pt = _trainer(run16)
    s = pt.state
    seen = []
    real = p_gan.ctc_loss_fast

    def spy(logp, *a, **kw):
        seen.append(logp.dtype)
        return real(logp, *a, **kw)
    monkeypatch.setattr(p_gan, "ctc_loss_fast", spy)
    u0 = {n: t.clone() for n, t in pt.model.state_dict().items()
          if n.endswith(".u")}
    frozen = {n: p.detach().clone() for n, p, lab in
              zip(s.names, s.params, s.labels) if lab == "frozen"}
    encoder = {n: t.clone() for n, t in pt.encoder.state_dict().items()}
    assert frozen and u0
    it = iter(run16.batches[:3])
    for i in range(4):
        out = pt.run_lesson(pt.curriculum.get_lesson(i), it, iteration=i)
        for k, v in out.items():
            if k.endswith("Loss"):
                assert np.isfinite(float(v)), (i, k)
    assert seen == [torch.float32] * 2
    tensors = (list(s.params) + list(s.saved_recog) + list(s.saved_adv)
               + _moments(s.opt_main) + _moments(s.opt_disc)
               + [s.style_bank])
    assert all(t.dtype == torch.float32 for t in tensors)
    assert len(_moments(s.opt_main)) > 0 and len(_moments(s.opt_disc)) > 0
    for name, t in pt.model.state_dict().items():
        if name.endswith(".u"):
            assert t.dtype == torch.float32, name
            # a one-channel conv's u is +-1 for good
            assert t.numel() == 1 or not torch.equal(t, u0[name]), name
            assert abs(float(t.norm()) - 1.0) <= 1e-5, name
    for name, p, lab in zip(s.names, s.params, s.labels):
        if lab == "frozen":
            assert torch.equal(p.detach(), frozen[name]), name
    for n, t in pt.encoder.state_dict().items():
        assert torch.equal(t, encoder[n]), n


def _equal(a, b, path="state"):
    """Bit-equality of two nested checkpoint states."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif torch.is_tensor(a):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def test_port_f32_gan_run_continues_in_bf16(tmp_path, monkeypatch):
    """``scripts/continue_gan_bf16.sh``'s flow on the port's own GAN run
    (``iam_gan_paper`` over the mini-IAM fixture at the JAX fixture's
    narrow widths): ``train`` of two lessons (count, gen) in float32, then
    ``train -r -a model.compute_dtype=bfloat16`` through the auto and disc
    lessons.  The resumed state (weights and ``u``'s, both Adams, the gen
    lesson's saved groups, bank, step, generators, text position) equals
    the float32 checkpoint bit for bit; the bf16 lessons log finite
    losses; every parameter, moment and ``u`` stays float32 and every
    ``u`` unit-norm."""
    name, ovs = CONFIGS_RUN["gan"]
    argv = ["-c", str(REPO / "configs" / name), "--device", "cpu"]
    for ov in RUN + ovs + _gan_widths() + [f"trainer.save_dir={tmp_path}"]:
        argv += ["-a", ov]
    assert p_train.main(argv + ["-i", "2"]) == 0
    run_dir = next(p for p in tmp_path.iterdir() if p.is_dir())
    saved = torch.load(run_dir / "checkpoint-latest.pt", weights_only=False)
    seen, made = [], []
    real_lesson, real_train = (p_gan.GanTrainer.run_lesson,
                               p_gan.GanTrainer.train)

    def lesson(self, *a, **kw):
        if not seen:
            seen.append(copy.deepcopy(self.state_dict()))
        return real_lesson(self, *a, **kw)

    def train(self, *a, **kw):
        made.append(self)
        return real_train(self, *a, **kw)
    monkeypatch.setattr(p_gan.GanTrainer, "run_lesson", lesson)
    monkeypatch.setattr(p_gan.GanTrainer, "train", train)
    assert p_train.main(argv + ["-i", "4", "-r", "-a",
                                "model.compute_dtype=bfloat16"]) == 0
    pt = made[0]
    assert pt.cfg.model.torch_compute_dtype() == torch.bfloat16
    assert seen[0]["step"] == saved["step"] == 2 and pt.state.step == 4
    _equal(seen[0], {k: v for k, v in saved.items() if k in seen[0]})
    log = json.loads((run_dir / "train_log.json").read_text())
    assert [e["iteration"] for e in log] == [1, 2, 3, 4]
    for e in log[2:]:
        losses = [v for k, v in e.items() if k.endswith("Loss")]
        assert losses and all(np.isfinite(losses)), e
    s = pt.state
    assert all(t.dtype == torch.float32 for t in
               list(s.params) + _moments(s.opt_main) + _moments(s.opt_disc))
    for n, t in pt.model.state_dict().items():
        if n.endswith(".u"):
            assert t.dtype == torch.float32
            assert abs(float(t.norm()) - 1.0) <= 1e-5, n
