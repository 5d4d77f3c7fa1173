"""The port's spans and counters (``utils/tracing.py``): off, the timed
paths record nothing and run the same tensor ops; under a profiler, the
generation session's and the style extractor's spans nest, share a request
id and hold their ``record_function`` ranges; the fill counters equal
their hand counts, and the prepare counters the per-text encode; a GAN
lesson cycle records the ``gan.*`` spans."""

from contextlib import nullcontext

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from handwriting_line_generation_tpu_torch.charset import IAM_CHARSET
from handwriting_line_generation_tpu_torch.config import (
    Config, DataConfig, DiscriminatorConfig, GeneratorConfig, HWRConfig,
    ModelConfig, SpacerConfig, StyleConfig, TrainerConfig,
)
from handwriting_line_generation_tpu_torch.convert import convert_params
from handwriting_line_generation_tpu_torch.inference.generate import \
    GenerationSession
from handwriting_line_generation_tpu_torch.inference.styles import \
    StyleExtractor
from handwriting_line_generation_tpu_torch.init import init_params
from handwriting_line_generation_tpu_torch.models.hw_with_style import \
    HWWithStyle
from handwriting_line_generation_tpu_torch.utils import tracing
from test_torch_threads import one_thread  # noqa: F401 (autouse)

NC, S, W = IAM_CHARSET.num_class, 16, 64
TEXTS = ["a quick line", "hi", "the slow brown fox", "ok then"]
SPACED = 16
GEN_SPANS = {"gen.request", "gen.prepare", "gen.spacer", "gen.insert_spaces",
             "gen.generator"}
STYLE_SPANS = {"style.extract", "style.recognizer", "style.char_style"}
# the profiler stamps its events on a clock of its own, converted to the
# epoch by a linear fit: it and the spans' clock read 5-11 us apart on
# the CPU, so a range may seem to start or end that much outside its span
CLOCK_SLACK_NS = 50_000


@pytest.fixture(autouse=True)
def _fresh():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _model(seed=0):
    cfg = ModelConfig(
        style=StyleConfig(style_dim=S, dim=8, char_dim=16, char_capacity=4),
        generator=GeneratorConfig(dim=32), spacer=SpacerConfig(dim=16),
        discriminator=DiscriminatorConfig(enabled=False),
        hwr=HWRConfig(kind="cnn_only", norm="group"), num_class=NC)
    model = HWWithStyle(cfg)
    model.load_state_dict(convert_params(init_params(cfg, seed)))
    return model


@pytest.fixture(scope="module")
def model():
    return _model()


def _styles():
    return np.random.default_rng(0).normal(
        size=(len(TEXTS), S)).astype(np.float32)


def _lines(B=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((B, 64, W, 1), generator=g) * 2 - 1


def _generate(model):
    sess = GenerationSession(model, IAM_CHARSET, device="cpu")
    return sess.render_tensor(TEXTS, _styles(), seed=3, spaced_len=SPACED)


def _extract(model, frames=(16, 9, 40, 1)):
    ext = StyleExtractor(model, device="cpu")
    return ext.extract(_lines(len(frames)), torch.tensor(frames), 2)


RUNS = {"generate": _generate, "extract": _extract}


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("path", sorted(RUNS))
def test_off_records_nothing_and_adds_no_op(path, model, monkeypatch):
    """Tracing off: nothing recorded, and the same aten ops dispatched as
    with the recorder stubbed out."""
    run = RUNS[path]
    with _Ops() as live:
        out = run(model)
    assert tracing.records() == [] and tracing.counters() == {}
    monkeypatch.setattr(tracing, "span", lambda name: nullcontext())
    monkeypatch.setattr(tracing, "count", lambda name, n: None)
    monkeypatch.setattr(tracing, "enabled", lambda: False)
    with _Ops() as stub:
        want = run(model)
    assert live.ops == stub.ops and len(live.ops) > 50
    for a, b in zip(out if isinstance(out, tuple) else (out,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(a, b)


def _ranges(prof, names):
    """``{name: [(start_ns, end_ns)]}`` of the profile's ranges by name."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in names:
            a = e.start_ns()
            out.setdefault(e.name(), []).append((a, a + e.duration_ns()))
    return out


@pytest.mark.parametrize("path,names,root", [
    ("generate", GEN_SPANS, "gen.request"),
    ("extract", STYLE_SPANS, "style.extract")])
def test_spans_nest_on_the_profilers_clock(path, names, root, model):
    """Under a CPU profiler, two requests: each request's spans share its
    root's id and lie inside the root, the children name the root as
    parent, and each span holds its own ``record_function`` range, the
    two clocks agreeing within ``CLOCK_SLACK_NS``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            RUNS[path](model)
    assert not tracing.enabled()
    spans = tracing.records()
    assert {s.name for s in spans} == names
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == [root, root]
    assert roots[0].request != roots[1].request
    for s in spans:
        top = next(r for r in roots if r.request == s.request)
        assert top.start_ns <= s.start_ns <= s.end_ns <= top.end_ns
        if s is not top:
            assert s.parent == root
    ranges = _ranges(prof, names)
    for name in names:
        mine = sorted((s.start_ns, s.end_ns) for s in spans
                      if s.name == name)
        got = sorted(ranges[name])
        assert len(got) == len(mine)
        for (a, b), (ra, rb) in zip(mine, got):
            assert a - CLOCK_SLACK_NS <= ra <= rb <= b + CLOCK_SLACK_NS


def test_fill_counters_equal_the_hand_counts(model):
    """``gen.spaced_used`` = sum of min(total, T) over the lines, from the
    spacer's rounded counts by hand; ``style.frames_used`` = sum of the
    frames, each at most the recognizer's T; the slots are B * T."""
    tracing.enable()
    _generate(model)
    _extract(model)
    got = tracing.counters()
    sess = GenerationSession(model, IAM_CHARSET, device="cpu")
    with torch.inference_mode():
        label, lens = sess.encode_texts(TEXTS)
        counts = sess._counts(label, torch.from_numpy(_styles()))
        pred = model.hwr(_lines())
    c = torch.clamp(torch.round(counts.float()), min=0).long()
    total = [int(c[b, :lens[b]].sum()) for b in range(len(TEXTS))]
    assert max(total) > SPACED > min(total)        # the clip is exercised
    assert got["gen.spaced_used"] == sum(min(t, SPACED) for t in total)
    assert got["gen.spaced_slots"] == len(TEXTS) * SPACED
    T = pred.shape[1]
    assert T == W // 4 < 40
    assert got["style.frames_used"] == 16 + 9 + T + 1
    assert got["style.frames_slots"] == 4 * T


PREPARE_TEXTS = ["a quíck líne", "hi\x00", "the slow brown fox",
                 "ok \U0001F600 then"]


@pytest.mark.parametrize("on,label_len", [
    (True, None), (True, 5), (False, None)])
def test_prepare_counters(on, label_len, model):
    """One ``render_tensor`` under ``enable()``: ``gen.prepare_chars`` is
    every character of the texts, ``gen.prepare_dropped`` those in no
    label (unknown, or past ``label_len``), by the per-text ``encode``.
    Tracing off: no counter."""
    if on:
        tracing.enable()
    sess = GenerationSession(model, IAM_CHARSET, device="cpu")
    sess.render_tensor(PREPARE_TEXTS, _styles(), seed=3, spaced_len=SPACED,
                       label_len=label_len)
    got = tracing.counters()
    if not on:
        assert got == {}
        return
    chars = sum(len(t) for t in PREPARE_TEXTS)
    known = [len(IAM_CHARSET.encode(t)) for t in PREPARE_TEXTS]
    L = label_len or max(known)
    assert got["gen.prepare_chars"] == chars == 42
    assert got["gen.prepare_dropped"] == chars - sum(min(k, L)
                                                     for k in known)
    assert got["gen.prepare_dropped"] == (4 if label_len is None else 25)


def test_counters_sum_across_calls_and_reset():
    tracing.enable()
    tracing.count("x", 2)
    tracing.count("x", 3)
    tracing.count("y", torch.tensor([1, 2, 3]))
    with torch.inference_mode():
        tracing.count("y", torch.tensor(4))
    tracing.count("y", torch.tensor([5.0]))
    assert tracing.counters() == {"x": 5, "y": 15}
    tracing.disable()
    tracing.count("x", 7)
    with tracing.span("z"):
        pass
    assert tracing.counters() == {"x": 5, "y": 15}
    assert tracing.records() == []
    tracing.reset()
    assert tracing.counters() == {}


GAN_SPANS = {"gan.viterbi_align", "gan.vjp", "gan.balance_and_merge",
             "gan.ctc", "gan.discriminator", "gan.optimizer"}
LESSONS = [["count"], ["no-step", "gen"], ["auto", "auto-gen"], ["disc"]]


def _gan_trainer():
    from handwriting_line_generation_tpu_torch.training.gan_trainer import \
        GanTrainer
    cfg = Config(name="t")
    cfg.data = DataConfig(batch_size=2, a_batch_size=2, label_buckets=(8,),
                          augmentation=None)
    cfg.model = ModelConfig(
        hwr=HWRConfig(kind="cnn_only", norm="group"),
        style=StyleConfig(style_dim=S, dim=8, char_dim=16, char_capacity=4),
        generator=GeneratorConfig(dim=32),
        discriminator=DiscriminatorConfig(dim=8), spacer=SpacerConfig(dim=16))
    cfg.trainer = TrainerConfig(curriculum={"0": LESSONS})
    tr = GanTrainer(cfg, device="cpu")
    tr.init_state(seed=0)
    return tr


def _gan_batch(seed):
    rng = np.random.default_rng(seed)
    B, L = 2, 8
    lens = np.array([8, 5], np.int32)
    label = np.zeros((B, L), np.int32)
    for b in range(B):
        label[b, :lens[b]] = rng.integers(1, NC, lens[b])
    return dict(image=rng.integers(0, 256, (B, 64, W, 1), dtype=np.uint8),
                label=label, label_lengths=lens,
                width=np.array([W, 48], np.int32),
                fg_mask=rng.random((B, 64, W, 1)) > 0.5,
                gt=["x" * int(n) for n in lens], a_batch_size=2)


def test_gan_lesson_cycle_records_gan_spans():
    """One cycle of the paper's four lesson kinds under ``enable()``: a
    root ``gan.lesson[...]`` a lesson, named with its kinds, and every
    ``gan.*`` child inside its root, with the root's request id."""
    tr = _gan_trainer()
    it = iter([_gan_batch(s) for s in range(3)])
    tracing.enable()
    for lesson in LESSONS:
        tr.run_lesson(lesson, it)
    spans = tracing.records()
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == [
        "gan.lesson[count]", "gan.lesson[no-step+gen]",
        "gan.lesson[auto+auto-gen]", "gan.lesson[disc]"]
    assert GAN_SPANS <= {s.name for s in spans}
    for s in spans:
        top = next(r for r in roots if r.request == s.request)
        assert top.start_ns <= s.start_ns <= s.end_ns <= top.end_ns
    # the auto lesson: its alignment, three group VJPs, the merge, a step
    auto = [s.name for s in spans if s.request == roots[2].request]
    assert auto.count("gan.vjp") == 3
    assert {"gan.viterbi_align", "gan.balance_and_merge",
            "gan.optimizer"} <= set(auto)
