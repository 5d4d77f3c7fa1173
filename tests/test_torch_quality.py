"""Port parity for the quality harness (``inference/quality.py``): the
recognizer's trunk features (``CNNOnlyHWR(return_features=True)``), the
extraction ``tap``, ``frechet_distance`` and ``QualityEvaluator.run``
against the JAX package on the same converted params and batches, with the
noise weights zero and the epilogue off on both sides."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from handwriting_line_generation_tpu.charset import IAM_CHARSET as J_CHARSET
from handwriting_line_generation_tpu.inference import quality as JQ
from handwriting_line_generation_tpu.inference import styles as JS
from handwriting_line_generation_tpu_torch.charset import IAM_CHARSET
from handwriting_line_generation_tpu_torch.inference import quality as PQ
from handwriting_line_generation_tpu_torch.inference import styles as PS
from handwriting_line_generation_tpu_torch.utils.png import read_png_gray
from test_torch_eval import author_batches, model_pair
from test_torch_threads import one_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.compile   # JAX compiles of the whole model

TEXTS = ["the quick", "brown fox", "jumps", "over a lazy dog", "seven"]
GEN_BATCH = 2                          # 5 texts: the last chunk padded
EXACT = ("real_CER", "real_WER", "gen_CER", "gen_WER")


def test_hwr_return_features_matches_jax():
    """``(logp, skip)``: skip, the trunk sequence ``[B, T, 512]`` before
    the dilated stack, within 1e-4; the log-probs unchanged by the flag."""
    jm, jp, model = model_pair()
    image = author_batches().items[0]["image"]
    wlogp, wskip = jm.apply({"params": jp}, jnp.asarray(image), True,
                            method=lambda m, x, rf:
                            m.hwr(x, return_features=rf))
    with torch.no_grad():
        logp, skip = model.hwr(torch.from_numpy(image),
                               return_features=True)
        plain = model.hwr(torch.from_numpy(image))
    assert skip.shape == (4, image.shape[2] // 4, 512)
    assert skip.dtype == torch.float32
    np.testing.assert_allclose(skip.numpy(), np.asarray(wskip), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(logp.numpy(), np.asarray(wlogp), rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(logp, plain, rtol=0, atol=0)


def test_extractor_tap_matches_jax():
    """The quality harness's feature tap through ``StyleExtractor(tap=)``:
    one ``[B, 512]`` array per batch within 1e-4, the styles unchanged."""
    jm, jp, model = model_pair()
    batches = author_batches()
    jqe = JQ.QualityEvaluator(jm, jp, J_CHARSET)
    pqe = PQ.QualityEvaluator(model, IAM_CHARSET, device="cpu")
    want = JS.StyleExtractor(
        jm, jp, tap=lambda m, p, im, fr: jqe._feat_fn(p, im, fr)
    ).extract_dataset(batches)
    got = PS.StyleExtractor(model, tap=pqe._feat_fn,
                            device="cpu").extract_dataset(batches)
    plain = PS.StyleExtractor(model, device="cpu").extract_dataset(batches)
    assert "tap" not in plain
    assert len(got["tap"]) == len(want["tap"]) == len(batches)
    for g, w in zip(got["tap"], want["tap"]):
        assert g.shape == (4, 512)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got["styles"], plain["styles"])


@pytest.mark.parametrize("n,d", [(600, 16), (64, 32), (40, 512)])
def test_frechet_distance_matches_jax(n, d):
    """float64 numpy in both: within 1e-9 relative.  At 40 samples of 512
    features the covariances are rank-deficient (the 1e-6 ridge holds them
    off singular) and the trace of the square root comes from eigenvalues
    near zero: the two copies still agree, being the same numpy code."""
    rng = np.random.default_rng(n + d)
    a = rng.normal(size=(n, d))
    b = rng.normal(0.3, 1.2, size=(n, d))
    want = JQ.frechet_distance(a, b)
    got = PQ.frechet_distance(a, b)
    assert got == pytest.approx(want, rel=1e-9)
    assert got > 0
    assert abs(PQ.frechet_distance(a, a)) < 1e-6 * d


def test_load_texts(tmp_path):
    p = tmp_path / "t.txt"
    p.write_text("one\n\n two \nthree\n")
    assert PQ.load_texts(str(p)) == JQ.load_texts(str(p)) == \
        ["one", " two ", "three"]
    assert PQ.load_texts(str(p), 2) == ["one", " two "]


@pytest.fixture(scope="module")
def quality(tmp_path_factory):
    jm, jp, model = model_pair()
    batches = author_batches()
    jdir = tmp_path_factory.mktemp("jax_q")
    pdir = tmp_path_factory.mktemp("port_q")
    want = JQ.QualityEvaluator(jm, jp, J_CHARSET).run(
        batches, TEXTS, gen_batch=GEN_BATCH, out_dir=str(jdir), degrade=True)
    pqe = PQ.QualityEvaluator(model, IAM_CHARSET, device="cpu")
    got = pqe.run(batches, TEXTS, gen_batch=GEN_BATCH, out_dir=str(pdir),
                  degrade=True)
    return dict(want=want, got=got, jdir=jdir, pdir=pdir, qe=pqe)


def test_quality_keys_and_exact_rates(quality):
    want, got = quality["want"], quality["got"]
    assert set(got) == set(want)
    for k in ("fid_hwr", "realism_gap", "realism_gap_degraded",
              "writer_id_top1", "style_inter_mean"):
        assert k in got and np.isfinite(got[k]), k
    for k in EXACT:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-6), k
    assert got["realism_gap"] == pytest.approx(got["gen_CER"]
                                               - got["real_CER"])


def test_quality_style_metrics(quality):
    want, got = quality["want"], quality["got"]
    keys = [k for k in want if k.startswith(("writer_id_", "style_"))]
    assert len(keys) == 8
    for k in keys:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-6), k


def test_quality_degraded_readback(quality):
    """The degraded copy goes through the port's ``degrade_image``, held
    at one grey level of JAX's; where that flips a decoded character the
    CER may move by one character's share of its text (the test prints
    it), no more."""
    want, got = quality["want"], quality["got"]
    for k in ("gen_CER_degraded", "gen_WER_degraded"):
        if got[k] != want[k]:
            print(f"{k}: {got[k]} against JAX's {want[k]}")
    share = max(1.0 / len(t) for t in TEXTS) / len(TEXTS)
    assert abs(got["gen_CER_degraded"] - want["gen_CER_degraded"]) <= share
    assert abs(got["realism_gap_degraded"]
               - (got["gen_CER_degraded"] - got["real_CER"])) < 1e-12


def test_quality_fid(quality):
    """5 generated against 8 real lines of 512 features: rank-deficient
    covariances, whose near-zero eigenvalues make the result sensitive to
    rounding, so the bound is relative on the result."""
    want, got = quality["want"], quality["got"]
    assert got["fid_hwr"] == pytest.approx(want["fid_hwr"], rel=1e-3)


def test_quality_pngs_and_stages(quality):
    """The first generated lines as ``gen_<i>.png``, the padding dropped,
    within one grey level of JAX's; each stage timed."""
    names = sorted(p.name for p in quality["jdir"].glob("gen_*.png"))
    assert names == sorted(p.name for p in quality["pdir"].glob("gen_*.png"))
    assert len(names) == len(TEXTS)
    for n in names:
        w = read_png_gray(str(quality["jdir"] / n)).astype(int)
        g = read_png_gray(str(quality["pdir"] / n)).astype(int)
        assert g.shape == w.shape and np.abs(g - w).max() <= 1, n
    assert set(quality["qe"].stage_seconds) == {
        "style_sweep", "gen_readback", "degrade", "fid"}


def test_generate_and_read_refuses_empty():
    _, _, model = model_pair()
    qe = PQ.QualityEvaluator(model, IAM_CHARSET, device="cpu")
    with pytest.raises(ValueError, match="no texts"):
        qe.generate_and_read([], np.zeros((2, 32), np.float32))
    with pytest.raises(ValueError, match="empty style bank"):
        qe.generate_and_read(["ab"], np.zeros((0, 32), np.float32))


def test_umap_embed_pca_matches_jax():
    """Without ``umap`` installed both fall back to the same PCA."""
    try:
        import umap  # noqa: F401
        pytest.skip("umap is installed: the embedding is UMAP's")
    except ImportError:
        pass
    data = {"styles": np.random.default_rng(0).normal(size=(12, 8))}
    np.testing.assert_allclose(PS.umap_embed(data), JS.umap_embed(data),
                               rtol=1e-12, atol=1e-12)
