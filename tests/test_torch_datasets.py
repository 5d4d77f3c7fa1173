"""Port parity for the numpy batching (``data/datasets.py``): batch
assembly, the batchers and side caches against the JAX package's on the
same in-memory records and rng, the cv2-free foreground mask against
OpenCV's, and the prefetcher."""

import cv2
import numpy as np
import pytest

from handwriting_line_generation_tpu.charset import IAM_CHARSET as J_CHARSET
from handwriting_line_generation_tpu.config import DataConfig as JDataConfig
from handwriting_line_generation_tpu.data import datasets as J
from handwriting_line_generation_tpu_torch.charset import IAM_CHARSET
from handwriting_line_generation_tpu_torch.config import DataConfig
from handwriting_line_generation_tpu_torch.data import datasets as P

WORDS = ["the", "quick brown", "fox", "jumps over", "a lazy dog", "seven",
         "handwriting", "line", "of text here"]


def _line(seed, width):
    """A normalized ``[64, width]`` line: paper near -1 with dark strokes,
    from u8 pixels, as the loaders produce."""
    rng = np.random.default_rng(seed)
    u8 = rng.integers(225, 256, (64, width)).astype(np.uint8)
    for x in range(3, width - 6, 11):
        h = int(rng.integers(8, 30))
        u8[32 - h // 2:32 + h // 2, x:x + 4] = rng.integers(0, 70)
    return (1.0 - u8.astype(np.float32) / 128.0).astype(np.float32)


def _records(mod, n_authors=3, per_author=(3, 4, 1)):
    out, k = [], 0
    for a in range(n_authors):
        for j in range(per_author[a]):
            w = 40 + 13 * k
            out.append(mod.LineRecord(
                author=f"w{a:02d}", gt=WORDS[k % len(WORDS)],
                load=lambda s=k, w=w: _line(s, w),
                rid="" if k == 2 else f"r{k}"))
            k += 1
    return out


BUCKETS = dict(width_buckets=(64, 128, 160), label_buckets=(8, 16))


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


@pytest.mark.parametrize("with_fg", [False, True])
def test_assemble_matches_jax(with_fg):
    jr, pr = _records(J), _records(P)
    want = J._assemble(jr[:4], J_CHARSET, (64, 128), (8, 16), with_fg, 2)
    got = P._assemble(pr[:4], IAM_CHARSET, (64, 128), (8, 16), with_fg, 2)
    _assert_batches_equal([got], [want])


@pytest.mark.parametrize("shuffle", [False, True])
def test_line_batcher_matches_jax(shuffle):
    jb = J.LineBatcher(_records(J), J_CHARSET, 3, JDataConfig(**BUCKETS))
    pb = P.LineBatcher(_records(P), IAM_CHARSET, 3, DataConfig(**BUCKETS))
    assert len(pb) == len(jb)
    want = list(jb.batches(np.random.default_rng(7), shuffle))
    got = list(pb.batches(np.random.default_rng(7), shuffle))
    _assert_batches_equal(got, want)


@pytest.mark.parametrize("a,pairs,shuffle", [(2, False, False),
                                             (3, False, True),
                                             (2, True, True)])
def test_author_batcher_matches_jax(a, pairs, shuffle):
    """Leftover fill (authors of 3, 4 and 1 lines) and RIMES-style pair
    combinations; groups, batches and their order."""
    kw = dict(with_fg=False, pair_combinations=pairs)
    jb = J.AuthorBatcher(_records(J), J_CHARSET, 2, a,
                         JDataConfig(**BUCKETS), **kw)
    pb = P.AuthorBatcher(_records(P), IAM_CHARSET, 2, a,
                         DataConfig(**BUCKETS), **kw)
    assert [[r.rid for r in g] for g in pb.groups] == \
        [[r.rid for r in g] for g in jb.groups]
    assert len(pb) == len(jb)
    want = list(jb.batches(np.random.default_rng(3), shuffle))
    got = list(pb.batches(np.random.default_rng(3), shuffle))
    _assert_batches_equal(got, want)


def test_side_caches_match_jax(tmp_path):
    """``spaced_loc`` rows and ``style_loc`` banks (one author's every row
    excludes its record: the loud fallback) attach the same arrays."""
    recs = _records(P)
    spaced = {r.rid: np.arange(1 + i % 5) for i, r in enumerate(recs)
              if r.rid}
    spaced[""] = np.zeros(1)
    np.savez(tmp_path / "spaced.npz", **spaced)
    styles = np.random.default_rng(0).standard_normal((5, 4)).astype(
        np.float32)
    np.savez(tmp_path / "bank_0.npz", styles=styles,
             authors=np.array(["w00", "w00", "w01", "w01", "w02"]),
             ids=np.array(["r0;r1", "r3", "r4;r5", "r6", "r7"]))
    kw = dict(spaced_loc=str(tmp_path / "spaced.npz"),
              style_loc=str(tmp_path / "bank_"), **BUCKETS)
    jb = J.AuthorBatcher(_records(J), J_CHARSET, 2, 2, JDataConfig(**kw),
                         with_fg=False)
    pb = P.AuthorBatcher(recs, IAM_CHARSET, 2, 2, DataConfig(**kw),
                         with_fg=False)
    with pytest.warns(RuntimeWarning):
        want = list(jb.batches(np.random.default_rng(1), True))
    with pytest.warns(RuntimeWarning):
        got = list(pb.batches(np.random.default_rng(1), True))
    assert "style" in got[0] and "spaced_label" in got[0]
    _assert_batches_equal(got, want)
    ident = P.LineBatcher(recs, IAM_CHARSET, 2,
                          DataConfig(identity_spaced=True, **BUCKETS))
    b = next(ident.batches(np.random.default_rng(0), False))
    np.testing.assert_array_equal(b["spaced_label"], b["label"])


def _fg_images():
    rng = np.random.default_rng(11)
    yield "line", _line(0, 150)
    yield "short line", _line(1, 9)
    yield "all paper", np.full((64, 80), 1.0 - 255 / 128, np.float32)
    yield "padding", np.full((64, 30), -1.0, np.float32)
    yield "all ink", np.full((64, 50), 1.0, np.float32)
    yield "two levels", np.where(rng.random((20, 33)) < 0.3, 0.9,
                                 -0.8).astype(np.float32)
    yield "uniform noise", rng.uniform(-1, 1, (64, 120)).astype(np.float32)
    yield "ink at the border", np.pad(np.full((64, 6), 1.0, np.float32),
                                      ((0, 0), (0, 40)),
                                      constant_values=-0.9)


@pytest.mark.parametrize("name,img", list(_fg_images()))
def test_fg_mask_equals_cv2(name, img):
    want = J.fg_mask_of(img)
    got = P.fg_mask_of(img)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want, err_msg=name)


def test_otsu_and_ellipse_equal_cv2():
    rng = np.random.default_rng(5)
    for _ in range(20):
        u8 = rng.integers(0, 256, (int(rng.integers(1, 40)),
                                   int(rng.integers(1, 90)))).astype(np.uint8)
        u8[rng.random(u8.shape) < 0.5] = rng.integers(0, 256)
        t, _ = cv2.threshold(u8, 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)
        assert P._otsu_threshold(u8) == int(t)
    for size in (3, 5, 9, 11):
        np.testing.assert_array_equal(
            P._ellipse(size),
            cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (size, size)))


def test_prefetcher_surfaces_worker_exception():
    def items():
        yield {"i": 0}
        yield {"i": 1}
        raise ValueError("bad record")

    it = P.Prefetcher(items(), depth=1)
    assert next(it) == {"i": 0} and next(it) == {"i": 1}
    with pytest.raises(ValueError, match="bad record"):
        next(it)
    with pytest.raises(ValueError, match="bad record"):
        next(it)


def test_prefetcher_keeps_order_and_ends():
    pb = P.AuthorBatcher(_records(P), IAM_CHARSET, 1, 2,
                         DataConfig(**BUCKETS), with_fg=False)
    direct = [b["rid"] for b in pb.batches(np.random.default_rng(0), False)]
    fetched = P.Prefetcher(pb.batches(np.random.default_rng(0), False), 2)
    assert [b["rid"] for b in fetched] == direct
    fetched._thread.join(timeout=5)
    assert not fetched._thread.is_alive()


def test_forever_cycles_epochs():
    pb = P.LineBatcher(_records(P), IAM_CHARSET, 4, DataConfig(**BUCKETS))
    jb = J.LineBatcher(_records(J), J_CHARSET, 4, JDataConfig(**BUCKETS))
    got, want = P.forever(pb, seed=2), J.forever(jb, seed=2)
    for _ in range(5):                 # past the end of the first epoch
        assert next(got)["rid"] == next(want)["rid"]
