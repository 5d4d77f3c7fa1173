"""Port parity for the style-extraction slice: ``HWWithStyle.extract_style``
and ``autoencode``, ``StyleExtractor.extract_dataset`` and the style-bank
helpers, against the JAX package on the same converted params and numpy
inputs (float32)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from handwriting_line_generation_tpu.charset import IAM_CHARSET as J_CHARSET
from handwriting_line_generation_tpu.config import (
    DataConfig as JDataConfig, DiscriminatorConfig as JDiscriminatorConfig,
    GeneratorConfig as JGeneratorConfig, HWRConfig as JHWRConfig,
    ModelConfig as JModelConfig, SpacerConfig as JSpacerConfig,
    StyleConfig as JStyleConfig,
)
from handwriting_line_generation_tpu.data import datasets as JD
from handwriting_line_generation_tpu.inference import styles as JS
from handwriting_line_generation_tpu.models.hw_with_style import \
    HWWithStyle as JHWWithStyle
from handwriting_line_generation_tpu_torch.charset import IAM_CHARSET
from handwriting_line_generation_tpu_torch.config import (
    DataConfig, DiscriminatorConfig, GeneratorConfig, HWRConfig, ModelConfig,
    SpacerConfig, StyleConfig,
)
from handwriting_line_generation_tpu_torch.convert import convert_params
from handwriting_line_generation_tpu_torch.data import datasets as PD
from handwriting_line_generation_tpu_torch.inference import styles as PS
from handwriting_line_generation_tpu_torch.init import init_params
from handwriting_line_generation_tpu_torch.models.hw_with_style import (
    HWWithStyle, collapse_author_batch,
)
from test_torch_char_style import perturb
from test_torch_datasets import BUCKETS, _line, _records

pytestmark = pytest.mark.compile   # JAX compiles of the whole model

TOL = dict(rtol=1e-4, atol=1e-4)
NC, S, W, L = 80, 16, 64, 8
STYLE_KW = dict(style_dim=S, dim=8, char_dim=16, char_capacity=4)
VARIANTS = {"single": dict(), "tuple": dict(char_style_dim=3),
            "vae": dict(vae=True)}


def _cfgs(variant="single", fused=False):
    style = {**STYLE_KW, **VARIANTS[variant]}
    kw = dict(num_class=NC, compute_dtype="float32")
    j = JModelConfig(style=JStyleConfig(**style),
                     generator=JGeneratorConfig(dim=32, fused_epilogue=False),
                     discriminator=JDiscriminatorConfig(enabled=False),
                     spacer=JSpacerConfig(dim=32),
                     hwr=JHWRConfig(kind="cnn_only", norm="group"), **kw)
    t = ModelConfig(style=StyleConfig(**style),
                    generator=GeneratorConfig(dim=32, fused_epilogue=fused),
                    discriminator=DiscriminatorConfig(enabled=False),
                    spacer=SpacerConfig(dim=32),
                    hwr=HWRConfig(kind="cnn_only", norm="group"), **kw)
    return j, t


def _pair(variant="single", fused=False, seed=0):
    """(JAX model, its params, port model) on one numpy tree: seeded init,
    the recognizer's and extractor's biases and norms made random, every
    noise weight 0 so the two packages' noise draws drop out."""
    jcfg, tcfg = _cfgs(variant, fused)
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


def _batch(B=4, seed=0):
    """B lines 64 x W (ink widths in [W/2, W], pad -1 past them), labels of
    up to L characters, frame lengths ``(width + 3) // 4``."""
    rng = np.random.default_rng(seed)
    widths = rng.integers(W // 2, W + 1, B)
    image = np.full((B, 64, W, 1), -1.0, np.float32)
    for b in range(B):
        image[b, :, :widths[b], 0] = _line(seed + b, int(widths[b]))
    lens = rng.integers(1, L + 1, B).astype(np.int32)
    labels = np.zeros((B, L), np.int32)
    for b in range(B):
        labels[b, :lens[b]] = rng.integers(1, NC, lens[b])
    frames = np.clip((widths + 3) // 4, 1, W // 4).astype(np.int32)
    return image, labels, lens, frames


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_collapse_author_batch():
    img = torch.arange(4 * 2 * 3).reshape(4, 2, 3, 1).float()
    seq = torch.arange(4 * 5 * 2).reshape(4, 5, 2)
    ic, sc = collapse_author_batch(img, seq, 2)
    assert ic.shape == (2, 2, 6, 1) and sc.shape == (2, 10, 2)
    assert torch.equal(ic[1, :, :3], img[2]) and torch.equal(ic[1, :, 3:],
                                                              img[3])
    assert torch.equal(sc[0, 5:], seq[1])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_extract_style_matches_jax(variant):
    """a = 2 with frame lengths: the style of each pair (repeated per line)
    and the masked recognizer output."""
    jm, jp, model = _pair(variant)
    image, _, _, frames = _batch()
    (wstyle, wpred) = jm.apply({"params": jp}, jnp.asarray(image), 2,
                               frame_lengths=jnp.asarray(frames),
                               method="extract_style")
    with torch.no_grad():
        style, pred = model.extract_style(_t(image), 2,
                                          frame_lengths=_t(frames))
    np.testing.assert_allclose(pred.numpy(), np.asarray(wpred), **TOL)
    wstyle = wstyle if isinstance(wstyle, tuple) else (wstyle,)
    style = style if isinstance(style, tuple) else (style,)
    assert len(style) == len(wstyle)
    for s, w in zip(style, wstyle):
        assert s.shape[0] == 4
        torch.testing.assert_close(s[0], s[1])
        np.testing.assert_allclose(s.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("variant,fused", [("single", False),
                                           ("single", True),
                                           ("tuple", True), ("vae", False)])
def test_autoencode_matches_jax(variant, fused):
    """a = 2, frame lengths, Viterbi alignment; the image with the plain
    block epilogue on and off (the CPU runs the kernel's plain version)."""
    jm, jp, model = _pair(variant, fused)
    image, labels, lens, frames = _batch(seed=1)
    key = jax.random.PRNGKey(0)
    want, waux = jm.apply({"params": jp}, jnp.asarray(image),
                          jnp.asarray(labels), jnp.asarray(lens), 2,
                          frame_lengths=jnp.asarray(frames),
                          method="autoencode", rngs={"noise": key})
    with torch.no_grad():
        got, aux = model.autoencode(_t(image), _t(labels), _t(lens), 2,
                                    frame_lengths=_t(frames),
                                    generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(aux["spaced_label"].numpy(),
                                  np.asarray(waux["spaced_label"]))
    assert got.shape == (4, 64, W, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_vae_reparameterisation():
    """With a ``vae_generator`` the generator reads ``mu + exp(log_sigma)
    * eps``, eps drawn from it; aux keeps ``(mu, log_sigma)``."""
    _, _, model = _pair("vae")
    image, labels, lens, frames = _batch(seed=2)
    args = (_t(image), _t(labels), _t(lens), 2)
    with torch.no_grad():
        got, aux = model.autoencode(
            *args, frame_lengths=_t(frames),
            generator=torch.Generator().manual_seed(0),
            vae_generator=torch.Generator().manual_seed(5))
        mu, log_sigma = aux["style"]
        eps = torch.randn(mu.shape, generator=torch.Generator().manual_seed(5))
        want = model.generate_spaced(
            aux["spaced_label"], mu + torch.exp(log_sigma) * eps,
            generator=torch.Generator().manual_seed(0))
        mean_only, _ = model.autoencode(
            *args, frame_lengths=_t(frames),
            generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.allclose(got, mean_only)


def _batchers(a=2):
    kw = dict(with_fg=False)
    jb = JD.AuthorBatcher(_records(JD), J_CHARSET, 2, a,
                          JDataConfig(**BUCKETS), **kw)
    pb = PD.AuthorBatcher(_records(PD), IAM_CHARSET, 2, a,
                          DataConfig(**BUCKETS), **kw)
    return jb, pb


class _Prefetched:
    """A batcher whose batches come through ``Prefetcher``."""

    def __init__(self, batcher):
        self.batcher = batcher

    def batches(self, rng, shuffle=True):
        return PD.Prefetcher(self.batcher.batches(rng, shuffle), depth=2)


@pytest.mark.parametrize("through_emb", [False, True])
def test_extract_dataset_matches_jax(through_emb):
    """One row per author group in batcher order (behind a prefetcher):
    styles within 1e-4, authors and ";"-joined ids exact, the masked
    log-probs with ``with_pred``."""
    jm, jp, model = _pair("single")
    jb, pb = _batchers()
    want = JS.StyleExtractor(jm, jp).extract_dataset(
        jb, through_emb=through_emb, with_pred=True)
    seen = []
    got = PS.StyleExtractor(model, device="cpu").extract_dataset(
        _Prefetched(pb), through_emb=through_emb, with_pred=True,
        on_batch=lambda b: seen.append(b["rid"]))
    assert got["authors"] == want["authors"]
    assert got["ids"] == want["ids"]
    assert len(seen) == len(pb) and len(got["ids"]) == 2 * len(pb)
    assert got["styles"].shape == (2 * len(pb), S)
    np.testing.assert_allclose(got["styles"], want["styles"], **TOL)
    for g, w in zip(got["pred"], want["pred"]):
        np.testing.assert_allclose(g, w, **TOL)


def test_extract_dataset_max_batches_and_tuple_packing():
    jm, jp, model = _pair("tuple")
    jb, pb = _batchers()
    want = JS.StyleExtractor(jm, jp).extract_dataset(jb, max_batches=1)
    got = PS.StyleExtractor(model, device="cpu").extract_dataset(
        pb, max_batches=1)
    assert got["styles"].shape == (2, model.cfg.packed_style_dim())
    assert got["ids"] == want["ids"]
    np.testing.assert_allclose(got["styles"], want["styles"], **TOL)


def _bank(seed=0, n=12):
    rng = np.random.default_rng(seed)
    authors = [f"w{i % 4}" for i in range(n)]
    styles = rng.standard_normal((n, 6)).astype(np.float32)
    styles += np.array([int(a[1]) for a in authors])[:, None] * 0.8
    return {"styles": styles, "authors": authors,
            "ids": [f"r{i};r{i + 1}" for i in range(n)]}


def test_save_load_round_trip_between_packages(tmp_path):
    data = _bank()
    PS.save_styles(str(tmp_path / "sub" / "bank.npz"), data)
    for load in (PS.load_styles, JS.load_styles):
        back = load(str(tmp_path / "sub" / "bank.npz"))
        np.testing.assert_array_equal(back["styles"], data["styles"])
        assert list(map(str, back["authors"])) == data["authors"]
        assert list(map(str, back["ids"])) == data["ids"]
    JS.save_styles(str(tmp_path / "j.npz"), data)
    np.testing.assert_array_equal(
        PS.load_styles(str(tmp_path / "j.npz"))["styles"], data["styles"])


@pytest.mark.parametrize("metric", ["l1", "l2"])
def test_style_statistics_match_jax(metric):
    data = _bank(seed=3)
    got, want = PS.styles_by_author(data), JS.styles_by_author(data)
    assert list(got) == list(want)
    for a in want:
        np.testing.assert_array_equal(got[a], want[a])
    assert PS.inter_intra_distances(data, metric) == \
        pytest.approx(JS.inter_intra_distances(data, metric), rel=1e-12)
    assert PS.writer_id_retrieval(data, metric, ks=(1, 3)) == \
        JS.writer_id_retrieval(data, metric, ks=(1, 3))


def test_style_extractor_needs_cuda_or_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PS.StyleExtractor(HWWithStyle(tcfg))
