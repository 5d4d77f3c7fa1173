"""The served reconstruction, ``StyleExtractor.reconstruct``: equal bit for
bit to ``HWWithStyle.autoencode``; the evaluator's reconstruct branch (and
with it the ``spaced_loc`` cache) runs it with unchanged outputs; it
agrees with the benchmark's plain reference
(``benchmark/reference/reconstruction.py``) within the limits of the cell
``autoencode_paper_b64``; the program's Viterbi path attains the best
score of the reference's independent float64 dynamic programme; its spans
nest under ``recon.request`` and its counters read what the batch implies,
while a GAN lesson's alignment keeps its ``gan.viterbi_align`` span."""

import itertools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from handwriting_line_generation_tpu_torch.charset import IAM_CHARSET
from handwriting_line_generation_tpu_torch.config import config_from_dict
from handwriting_line_generation_tpu_torch.inference.eval import Evaluator
from handwriting_line_generation_tpu_torch.inference.styles import \
    StyleExtractor
from handwriting_line_generation_tpu_torch.models.hw_with_style import (
    HWWithStyle, pack_style,
)
from handwriting_line_generation_tpu_torch.ops.align import viterbi_align
from handwriting_line_generation_tpu_torch.ops.augment import \
    dequantize_image
from handwriting_line_generation_tpu_torch.ops.ctc import \
    mask_frames_to_blank
from handwriting_line_generation_tpu_torch.utils import tracing
from test_torch_threads import one_thread  # noqa: F401 (autouse)

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

from harness import inputs, registry, weights  # noqa: E402
from harness.dry import shrunk_config  # noqa: E402
from reference import build as ref_build  # noqa: E402
from reference import reconstruction as ref_rec  # noqa: E402

CELL = "autoencode_paper_b64"
A = 2                      # lines an author, the configuration's
W, L = 256, 24             # 32 frames or more: each label fits the ink


def _cfg_file():
    wl = registry.workload(CELL)
    return shrunk_config(registry.config(wl["config"]),
                         wl["dry_run"]["config"])


def _model(seed=3):
    cfg = config_from_dict(_cfg_file()["config"])
    model = HWWithStyle(cfg.model)
    weights.fill(model, seed)
    return model.eval()


def _lines(seed, n=4, width=W, label_len=L):
    """``(u8 image, label, lens, width)`` tensors of seeded glyph lines."""
    got = inputs.glyph_lines(np.random.default_rng(seed), n, width,
                             label_len, IAM_CHARSET.num_class)
    return tuple(torch.from_numpy(x) for x in got)


def _request(seed, width=W, label_len=L):
    image, label, lens, w = _lines(seed, width=width, label_len=label_len)
    x = dequantize_image(image, w)
    frames = torch.clamp((w + 3) // 4, 1, x.shape[2] // 4)
    return image, x, frames, label, lens, w


@pytest.fixture(autouse=True)
def _fresh():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.mark.parametrize("given_pred", [False, True])
def test_entry_is_autoencode_bit_for_bit(given_pred):
    model = _model()
    _, x, frames, label, lens, _ = _request(1)
    pred = model.recognize(x).detach() if given_pred else None
    recon, spaced, style = StyleExtractor(model, device="cpu").reconstruct(
        x, frames, label, lens, A, torch.Generator().manual_seed(9),
        pred=pred)
    with torch.inference_mode():
        want, aux = model.autoencode(x, label, lens, A, frame_lengths=frames,
                                     generator=torch.Generator()
                                     .manual_seed(9))
    assert recon.shape == (4, 64, 4 * (W // 4), 1)
    assert torch.equal(recon, want)
    assert torch.equal(spaced, aux["spaced_label"])
    assert torch.equal(style, pack_style(aux["style"])[::A])


class _Batches:
    def __init__(self, items):
        self.items = items

    def batches(self, rng, shuffle=True):
        return iter(self.items)


def _eval_batches():
    out = []
    for k in range(2):
        image, label, lens, width = (t.numpy() for t in _lines(20 + k))
        x = dequantize_image(torch.from_numpy(image),
                             torch.from_numpy(width)).numpy()
        out.append(dict(
            image=x, label=label, label_lengths=lens, width=width,
            gt=["x" * int(n) for n in lens],
            author=[f"w{k}{j // A}" for j in range(len(x))],
            rid=[f"r{k}_{j}" for j in range(len(x))], a_batch_size=A))
    return out


def test_evaluator_reconstructs_through_the_entry(tmp_path):
    """``Evaluator.run(save_spaced=True)``'s reconstruct branch: its
    ``autoLoss``, spaced rows and styles equal those of the branch as it
    read before the entry (``autoencode`` on the recognizer's pass, noise
    from a generator seeded 0)."""
    model = _model(4)
    batches = _eval_batches()
    got = Evaluator(model, IAM_CHARSET, device="cpu").run(
        _Batches(batches), out_dir=str(tmp_path), save_spaced=True,
        save_styles=True)
    auto, spaced, styles = [], {}, []
    with torch.inference_mode():
        for b in batches:
            image = torch.from_numpy(b["image"])
            width = torch.from_numpy(b["width"])
            frames = torch.clamp((width + 3) // 4, 1, image.shape[2] // 4)
            raw = model.recognize(image)
            recon, aux = model.autoencode(
                image, torch.from_numpy(b["label"]),
                torch.from_numpy(b["label_lengths"]), A,
                frame_lengths=frames, pred=raw,
                generator=torch.Generator().manual_seed(0))
            auto.append((recon - image).abs().mean().item())
            spaced.update(zip(b["rid"], aux["spaced_label"].numpy()))
            styles.append(pack_style(aux["style"]).numpy()[::A])
    assert got["autoLoss"] == sum(auto) / len(auto)
    with np.load(tmp_path / "spaced.npz") as d:
        assert sorted(d.files) == sorted(spaced)
        for rid, row in spaced.items():
            assert np.array_equal(d[rid], row)
    with np.load(tmp_path / "styles.npz") as d:
        assert np.array_equal(d["styles"], np.concatenate(styles))


def test_entry_agrees_with_the_reference_within_the_cell_limits():
    """The entry's outputs, judged by the cell's reference on the same
    weights, inputs and noise seed: every number inside its limit."""
    model = _model(6)
    seen = {}
    model.style_extractor.register_forward_pre_hook(
        lambda mod, args: seen.__setitem__("pred", args[1]))
    image, x, frames, label, lens, width = _request(2)
    recon, spaced, style = StyleExtractor(model, device="cpu").reconstruct(
        x, frames, label, lens, A, torch.Generator().manual_seed(11))
    out = {"recon": recon, "spaced": spaced, "styles": style,
           "pred": seen["pred"].reshape(4, W // 4, -1)}
    ref = ref_build.model(_cfg_file(), 6, "cpu")
    got = ref_rec.judge(ref, image, width, label, lens, A, 11, out)
    limits = registry.workload(CELL)["limits"]
    assert set(got) == set(limits)
    for k, v in got.items():
        assert v <= limits[k], (k, v)
    assert got["spaced_mismatch"] == 0
    # the same path a frame late: a path of the lattice, but not its best
    late = dict(out, spaced=torch.roll(spaced, 1, dims=1))
    bad = ref_rec.judge(ref, image, width, label, lens, A, 11, late)
    assert bad["spaced_mismatch"] > 0
    assert bad["path_score_gap"] > limits["path_score_gap"]


def _collapse(path):
    """CTC's many-to-one map: repeats merged, then blanks dropped."""
    return [int(c) for c, _ in itertools.groupby(path) if c != 0]


def _lattice(case):
    """``(log_probs, labels, lens)`` of one case: 6 lines, 24 frames, 12
    classes."""
    g = torch.Generator().manual_seed(sum(map(ord, case)))
    B, T, C = 6, 24, 12
    logp = torch.log_softmax(3 * torch.randn(B, T, C, generator=g), dim=-1)
    lens = torch.randint(1, 8, (B,), generator=g)
    labels = torch.randint(1, C, (B, 7), generator=g)
    if case == "repeats":                  # no skip between equal labels
        labels[:, 1::2] = labels[:, 0::2][:, :3]
        labels[0, :] = 5
        lens[0] = 7
    elif case == "one_label":
        lens[:] = 1
    elif case == "masked":                 # frames past each line blank
        frames = torch.tensor([24, 20, 18, 16, 15, 14])
        logp = mask_frames_to_blank(logp, frames)
    labels = torch.where(torch.arange(7)[None] < lens[:, None], labels, 0)
    return logp, labels.int(), lens


@pytest.mark.parametrize("case", ["random", "repeats", "one_label",
                                  "masked"])
def test_viterbi_attains_the_best_path_score(case):
    logp, labels, lens = _lattice(case)
    path = viterbi_align(logp, labels, lens)
    for b in range(len(path)):
        assert _collapse(path[b].tolist()) == labels[b, :lens[b]].tolist()
    best = ref_rec.best_path_score(logp, labels, lens)
    got = ref_rec.path_score(logp, path)
    # the program's recursion adds in float32: 24 frames of log-probs
    # above -40 round by less than 24 * 40 * 2^-24 each way
    assert torch.all(best > -1e20)
    assert (best - got).abs().max() < 1e-4


def test_best_path_score_is_the_best_over_every_path():
    """The reference's dynamic programme against every state sequence of
    a small lattice enumerated by brute force."""
    g = torch.Generator().manual_seed(0)
    T, C = 5, 4
    logp = torch.log_softmax(torch.randn(3, T, C, generator=g), dim=-1)
    labels = torch.tensor([[1, 1], [2, 3], [3, 0]])
    lens = torch.tensor([2, 2, 1])
    got = ref_rec.best_path_score(logp, labels, lens)
    for b in range(3):
        lab = labels[b, :lens[b]].tolist()
        ext = [0]
        for c in lab:
            ext += [c, 0]
        best = max(sum(float(logp[b, t, ext[s]]) for t, s in enumerate(seq))
                   for seq in itertools.product(range(len(ext)), repeat=T)
                   if _collapse([ext[s] for s in seq]) == lab)
        assert got[b].item() == pytest.approx(best, abs=1e-9)


def test_spans_nest_under_the_request_and_counters_read_the_batch():
    model = _model()
    _, x, frames, label, lens, _ = _request(3)
    ext = StyleExtractor(model, device="cpu")
    tracing.enable()
    ext.reconstruct(x, frames, label, lens, A,
                    torch.Generator().manual_seed(1))
    spans = tracing.records()
    root, = [s for s in spans if s.parent is None]
    assert root.name == "recon.request"
    kids = [s for s in spans if s is not root]
    assert {s.name for s in kids} == {"style.recognizer", "style.char_style",
                                      "recon.align", "recon.generator"}
    for s in kids:
        assert s.parent == "recon.request" and s.request == root.request
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    got = tracing.counters()
    B, Lp = label.shape
    assert got["recon.lattice_used"] == int((2 * lens + 1).sum())
    assert got["recon.lattice_slots"] == B * (2 * Lp + 1)
    assert got["recon.align_steps"] == W // 4 - 1
    assert 0 < got["recon.lattice_used"] <= got["recon.lattice_slots"]
    tracing.disable()
    tracing.reset()
    ext.reconstruct(x, frames, label, lens, A,
                    torch.Generator().manual_seed(1))
    assert tracing.records() == [] and tracing.counters() == {}


def test_gan_lesson_keeps_its_alignment_span():
    """The auto lesson's ``autoencode``, under its ``gan.lesson[...]``
    root: the alignment span stays ``gan.viterbi_align``, and no
    reconstruction span or counter is recorded."""
    from test_torch_tracing import _gan_batch, _gan_trainer
    tr = _gan_trainer()
    tracing.enable()
    tr.run_lesson(["auto", "auto-gen"], iter([_gan_batch(0)]))
    names = [s.name for s in tracing.records()]
    assert names[-1] == "gan.lesson[auto+auto-gen]"
    assert "gan.viterbi_align" in names
    assert not [n for n in names if n.startswith("recon.")]
    assert not [k for k in tracing.counters() if k.startswith("recon.")]
