"""Port parity for the evaluation harness (``inference/eval.py``) and the
blob masks (``ops/masks.py``): ``Evaluator.run`` with every side channel
against the JAX package's on the same converted params and the same
batches, and ``make_mask`` / ``line_geometry`` against JAX's on fixture
crops and random ink.  Every ``NoiseInjection`` weight is zero, so the two
packages' noise draws drop out; the epilogue is off on both sides (the
plain path is the port's CPU path)."""

import csv
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from handwriting_line_generation_tpu.charset import IAM_CHARSET as J_CHARSET
from handwriting_line_generation_tpu.config import (
    DiscriminatorConfig as JDiscriminatorConfig,
    GeneratorConfig as JGeneratorConfig, HWRConfig as JHWRConfig,
    ModelConfig as JModelConfig, SpacerConfig as JSpacerConfig,
    StyleConfig as JStyleConfig,
)
from handwriting_line_generation_tpu.inference.eval import \
    Evaluator as JEvaluator
from handwriting_line_generation_tpu.models.hw_with_style import \
    HWWithStyle as JHWWithStyle
from handwriting_line_generation_tpu.ops import masks as JM
from handwriting_line_generation_tpu.ops.ctc import \
    mask_frames_to_blank as j_mask_frames
from handwriting_line_generation_tpu_torch.charset import IAM_CHARSET
from handwriting_line_generation_tpu_torch.config import (
    DataConfig, DiscriminatorConfig, GeneratorConfig, HWRConfig, ModelConfig,
    SpacerConfig, StyleConfig,
)
from handwriting_line_generation_tpu_torch.convert import convert_params
from handwriting_line_generation_tpu_torch.data import datasets as PD
from handwriting_line_generation_tpu_torch.inference.eval import (
    Evaluator, side_by_side,
)
from handwriting_line_generation_tpu_torch.init import init_params
from handwriting_line_generation_tpu_torch.models.hw_with_style import \
    HWWithStyle
from handwriting_line_generation_tpu_torch.ops import masks as PM
from handwriting_line_generation_tpu_torch.utils.png import read_png_gray
from test_torch_char_style import perturb
from test_torch_datasets import WORDS, _line

pytestmark = pytest.mark.compile   # JAX compiles of the whole model

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "mini_iam"
S = 32
STYLE_KW = dict(style_dim=S, dim=16, char_dim=16, window=2, char_capacity=4)
BUCKETS = dict(width_buckets=(256,), label_buckets=(16,))
# the log-prob parity bound of the recognizer: a frame whose top-two
# margin in JAX's output is below it may decode either way
MARGIN = 1e-4
CHANNELS = dict(save_images=True, save_styles=True, save_spaced=True,
                save_preds=True, save_nns=True, save_gen=True)


def model_cfgs():
    kw = dict(num_class=J_CHARSET.num_class, compute_dtype="float32")
    j = JModelConfig(style=JStyleConfig(**STYLE_KW),
                     generator=JGeneratorConfig(dim=32,
                                                fused_epilogue=False),
                     discriminator=JDiscriminatorConfig(enabled=False),
                     spacer=JSpacerConfig(dim=32),
                     hwr=JHWRConfig(kind="cnn_only", norm="group"), **kw)
    t = ModelConfig(style=StyleConfig(**STYLE_KW),
                    generator=GeneratorConfig(dim=32, fused_epilogue=False),
                    discriminator=DiscriminatorConfig(enabled=False),
                    spacer=SpacerConfig(dim=32),
                    hwr=HWRConfig(kind="cnn_only", norm="group"), **kw)
    return j, t


def model_pair(seed=0):
    """(JAX model, its params, port model) on one numpy tree: seeded init,
    the recognizer's and extractor's biases and norms made random, every
    noise weight 0."""
    jcfg, tcfg = model_cfgs()
    params = init_params(tcfg, seed)
    rng = np.random.default_rng(seed + 10)
    for k in ("hwr", "style_extractor"):
        params[k] = perturb(params[k], rng)
    for name, blk in params["generator"].items():
        if name.startswith("StyledConvBlock_"):
            for k in ("NoiseInjection_0", "NoiseInjection_1"):
                blk[k]["weight"][:] = 0.0
    model = HWWithStyle(tcfg)
    model.load_state_dict(convert_params(params))
    return (JHWWithStyle(jcfg), jax.tree_util.tree_map(jnp.asarray, params),
            model.eval())


def records(n_authors=4, per_author=2):
    """Lines 64 x 96..243 of ``n_authors`` writers, ``per_author`` each, all
    in one width bucket (one compiled shape on the JAX side)."""
    out = []
    for k in range(n_authors * per_author):
        w = 96 + 21 * k
        out.append(PD.LineRecord(
            author=f"w{k // per_author:02d}", gt=WORDS[k % len(WORDS)],
            load=lambda s=k, w=w: _line(100 + s, w), rid=f"r{k}"))
    return out


class Batches:
    """Fixed batches, assembled once, handed to both packages' harnesses
    (they only call ``batches(rng, shuffle=False)``)."""

    def __init__(self, batches):
        self.items = batches

    def batches(self, rng, shuffle=True):
        return iter(self.items)

    def __len__(self):
        return len(self.items)


def author_batches(n_authors=4, per_author=2):
    b = PD.AuthorBatcher(records(n_authors, per_author), IAM_CHARSET, 2, 2,
                         DataConfig(**BUCKETS), with_fg=False)
    return Batches(list(b.batches(np.random.default_rng(0), shuffle=False)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One JAX and one port ``Evaluator.run`` over the same batches with
    every channel, and JAX's masked log-probs of each batch."""
    jm, jp, model = model_pair()
    batches = author_batches()
    jdir = tmp_path_factory.mktemp("jax_eval")
    pdir = tmp_path_factory.mktemp("port_eval")
    want = JEvaluator(jm, jp, J_CHARSET).run(batches, out_dir=str(jdir),
                                             **CHANNELS)
    got = Evaluator(model, IAM_CHARSET, device="cpu").run(
        batches, out_dir=str(pdir), **CHANNELS)
    recog = jax.jit(lambda p, im, fr: j_mask_frames(
        jm.apply({"params": p}, im, method="recognize"), fr))
    jlogp = []
    for b in batches.items:
        frames = np.clip((b["width"] + 3) // 4, 1, b["image"].shape[2] // 4)
        jlogp.append(np.asarray(recog(jp, jnp.asarray(b["image"]),
                                      jnp.asarray(frames))))
    return dict(want=want, got=got, jdir=jdir, pdir=pdir, batches=batches,
                jlogp=jlogp)


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def _low_margin_lines(jlogp):
    """Per line (in batch order), whether some frame's top-two log-prob
    margin in JAX's output is below ``MARGIN``."""
    out = []
    for lp in jlogp:
        top2 = np.sort(lp, axis=-1)[..., -2:]
        out.extend(((top2[..., 1] - top2[..., 0]) < MARGIN).any(axis=1))
    return out


def test_evaluator_cer_wer_and_preds(runs):
    """Decoded strings equal line by line; a line may differ only where
    JAX's output has a frame within the log-prob parity bound of a tie
    (none is expected at these seeds: the test says so if one shows)."""
    want, got = runs["want"], runs["got"]
    assert set(got) == set(want) == {"CER", "WER", "autoLoss"}
    wrows = _rows(runs["jdir"] / "preds.csv")
    grows = _rows(runs["pdir"] / "preds.csv")
    assert grows[0] == wrows[0] == ["batch", "index", "author", "gt", "pred",
                                    "cer"]
    assert len(grows) == len(wrows) == 1 + 4 * len(runs["batches"])
    low = _low_margin_lines(runs["jlogp"])
    differ = [i for i, (g, w) in enumerate(zip(grows[1:], wrows[1:]))
              if g != w]
    for i in differ:
        assert low[i], (f"line {i} decodes {grows[i + 1]} against JAX's "
                        f"{wrows[i + 1]} with no frame near a tie")
        print(f"line {i}: a frame within {MARGIN} of a tie decodes "
              f"differently ({grows[i + 1][4]!r} vs {wrows[i + 1][4]!r})")
    if not differ:
        assert got["CER"] == want["CER"] and got["WER"] == want["WER"]


def test_evaluator_auto_loss(runs):
    np.testing.assert_allclose(runs["got"]["autoLoss"],
                               runs["want"]["autoLoss"], rtol=1e-4)


def test_evaluator_styles_npz(runs):
    w = np.load(runs["jdir"] / "styles.npz")
    g = np.load(runs["pdir"] / "styles.npz")
    assert list(g["authors"]) == list(w["authors"])
    assert g["styles"].shape == w["styles"].shape == (4, S)
    scale = np.abs(w["styles"]).max()
    assert np.abs(g["styles"] - w["styles"]).max() <= 1e-4 * scale


def test_evaluator_spaced_npz(runs):
    w = np.load(runs["jdir"] / "spaced.npz")
    g = np.load(runs["pdir"] / "spaced.npz")
    assert sorted(g.files) == sorted(w.files) == sorted(
        f"r{k}" for k in range(8))
    for k in w.files:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_evaluator_nns_csv(runs):
    """The same neighbours (index and author) in the same order; the
    distances as printed within 1e-4 of the styles' scale."""
    wrows = _rows(runs["jdir"] / "nns.csv")
    grows = _rows(runs["pdir"] / "nns.csv")
    assert grows[0] == wrows[0] and len(grows) == len(wrows) == 9
    for g, w in zip(grows[1:], wrows[1:]):
        assert [g[i] for i in (0, 1, 2, 3, 5, 6, 8, 9)] == \
            [w[i] for i in (0, 1, 2, 3, 5, 6, 8, 9)]
        for i in (4, 7, 10):
            assert abs(float(g[i]) - float(w[i])) <= 2e-4


@pytest.mark.parametrize("kind", ["recon", "gen"])
def test_evaluator_pngs(runs, kind):
    """``recon_*`` (original above reconstruction) and ``gen_*`` within one
    grey level of the JAX package's."""
    names = sorted(p.name for p in runs["jdir"].glob(f"{kind}_*.png"))
    assert names == sorted(p.name for p in runs["pdir"].glob(
        f"{kind}_*.png"))
    assert len(names) == 4 * len(runs["batches"])
    for n in names:
        w = read_png_gray(str(runs["jdir"] / n)).astype(int)
        g = read_png_gray(str(runs["pdir"] / n)).astype(int)
        assert g.shape == w.shape, n
        assert np.abs(g - w).max() <= 1, n


def test_side_by_side_layout():
    o = np.full((64, 40, 1), 1.0, np.float32)
    r = np.full((64, 56, 1), -1.0, np.float32)
    img = side_by_side(o, r)
    assert img.shape == (130, 56) and img.dtype == np.uint8
    assert (img[:64, :40] == 0).all() and (img[:64, 40:] == 255).all()
    assert (img[64:66] == 0).all() and (img[66:] == 255).all()


def test_evaluator_max_batches_and_no_channels(tmp_path):
    """``max_batches`` stops early; no channel writes nothing."""
    _, _, model = model_pair(seed=1)
    out = Evaluator(model, IAM_CHARSET, device="cpu").run(
        author_batches(), max_batches=1, out_dir=str(tmp_path))
    assert set(out) == {"CER", "WER", "autoLoss"}
    assert list(tmp_path.iterdir()) == []


# -- masks --------------------------------------------------------------


def _fixture_lines(n=4):
    recs = PD.iam_records(str(FIXTURE), "train", 64, 1300)[:n]
    lines = [r.load() for r in recs]
    w = max(x.shape[1] for x in lines)
    out = np.full((n, 64, w, 1), -1.0, np.float32)
    for i, x in enumerate(lines):
        out[i, :, :x.shape[1], 0] = x
    return out


def _random_ink(seed=0):
    rng = np.random.default_rng(seed)
    img = np.full((3, 64, 160, 1), -1.0, np.float32)
    for b in range(3):
        for _ in range(12):
            y, x = rng.integers(8, 56), rng.integers(0, 150)
            img[b, y - 4:y + 4, x:x + 6, 0] = rng.uniform(0.2, 1.0)
    img[2] = -1.0                             # an empty line
    return img


INPUTS = {"mini_iam": _fixture_lines, "random_ink": _random_ink}
POSTS = [None, ["thresh", "smaller", "dilate", "errode"], ["thresh"]]


@pytest.mark.parametrize("post", POSTS, ids=["paper", "square", "thresh"])
@pytest.mark.parametrize("source", list(INPUTS))
def test_make_mask_matches_jax(source, post):
    img = INPUTS[source]()
    want = np.asarray(JM.make_mask(jnp.asarray(img), post))
    got = PM.make_mask(torch.from_numpy(img), post).numpy()
    assert got.shape == img.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("source", list(INPUTS))
def test_line_geometry_matches_jax(source, with_mask):
    img = INPUTS[source]()
    jmask = JM.make_mask(jnp.asarray(img)) if with_mask else None
    pmask = PM.make_mask(torch.from_numpy(img)) if with_mask else None
    wtb, wc = JM.line_geometry(jnp.asarray(img), jmask)
    gtb, gc = PM.line_geometry(torch.from_numpy(img), pmask)
    np.testing.assert_allclose(gtb.numpy(), np.asarray(wtb), atol=1e-5)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=1e-5,
                               atol=1e-5)
