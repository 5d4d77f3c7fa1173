"""Port parity for the record sources without OpenCV: the PNG reader
against ``cv2.imread(path, 0)``, the IAM/RIMES parsers and the page
decode + resize against the JAX package's, the numpy image ops against the
OpenCV calls they replace, and the synthetic corpus and renders against
the JAX package's (with OpenCV's stroke drawer put in the port's place,
and with the port's own)."""

import pathlib
import struct
import zlib

import cv2
import numpy as np
import pytest

from handwriting_line_generation_tpu.charset import IAM_CHARSET as J_CHARSET
from handwriting_line_generation_tpu.data import datasets as JD
from handwriting_line_generation_tpu.data import iam as JI
from handwriting_line_generation_tpu.data import rimes as JR
from handwriting_line_generation_tpu.data import synthetic as JS
from handwriting_line_generation_tpu_torch.charset import IAM_CHARSET
from handwriting_line_generation_tpu_torch.data import datasets as PD
from handwriting_line_generation_tpu_torch.data import iam as PI
from handwriting_line_generation_tpu_torch.data import imageops as ops
from handwriting_line_generation_tpu_torch.data import rimes as PR
from handwriting_line_generation_tpu_torch.data import synthetic as PS
from handwriting_line_generation_tpu_torch.utils import png
from handwriting_line_generation_tpu_torch.utils.png import read_png_gray
from test_torch_threads import one_thread  # noqa: F401 (autouse)

FIXTURE = pathlib.Path(__file__).resolve().parent / "fixtures" / "mini_iam"
FORMS = sorted((FIXTURE / "forms").glob("*.png"))
XMLS = sorted((FIXTURE / "xmls").glob("*.xml"))

# stroke drawer against OpenCV's, per image: the drawer follows OpenCV's
# drawing code from its description (bit-equal to this OpenCV in these
# tests), so it is held by the mean and ink-mass bounds the port promises
STROKE_MEAN_ABS = 4.0
STROKE_INK_RTOL = 0.10


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _chunk(tag, data):
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


_CH = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _pack(arr, depth, ctype):
    """Samples ``[H, W, ch]`` -> packed row bytes, big-endian, MSB first."""
    H = arr.shape[0]
    a = arr.reshape(H, -1).astype(np.int64)
    if depth == 16:
        return a.astype(">u2").view(np.uint8).reshape(H, -1)
    if depth == 8:
        return a.astype(np.uint8)
    bits = ((a[:, :, None] >> np.arange(depth - 1, -1, -1)) & 1)
    return np.packbits(bits.astype(np.uint8).reshape(H, -1), axis=1)


def _filter(rows, types, bpp):
    """Apply PNG filter ``types[r]`` to each row (the encoder's side)."""
    x = rows.astype(np.int64)
    out = np.zeros_like(x)
    H, n = x.shape
    for r in range(H):
        prior = x[r - 1] if r else np.zeros(n, np.int64)
        for i in range(n):
            a = x[r, i - bpp] if i >= bpp else 0
            b, c = prior[i], (prior[i - bpp] if i >= bpp else 0)
            ft = types[r]
            if ft == 4:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            else:
                pred = (0, a, b, (a + b) >> 1)[ft]
            out[r, i] = (x[r, i] - pred) & 0xFF
    return out.astype(np.uint8)


def _png(arr, depth, ctype, palette=None, interlace=0):
    rows = _pack(arr, depth, ctype)
    H, W = arr.shape[:2]
    types = np.arange(H) % 5                  # every filter type, in turn
    bpp = max(1, depth * _CH[ctype] // 8)
    raw = np.concatenate([types[:, None].astype(np.uint8),
                          _filter(rows, types, bpp)], axis=1)
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", W, H, depth, ctype, 0, 0, interlace))
    if palette is not None:
        data += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return data + _chunk(b"IDAT", zlib.compress(raw.tobytes())) + \
        _chunk(b"IEND", b"")


@pytest.mark.parametrize("path", FORMS, ids=lambda p: p.stem)
def test_read_png_matches_cv2_on_fixture_forms(path):
    got = read_png_gray(str(path))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, cv2.imread(str(path), 0))


def _filtered_rows(path):
    """A PNG's filter bytes and its filtered rows ``[H, n, bpp]``."""
    data = pathlib.Path(path).read_bytes()
    pos, idat = 8, []
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        if tag == b"IHDR":
            W, H, depth, ctype = struct.unpack(">IIBB", data[pos + 8:pos + 18])
        elif tag == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    bpp = max(1, depth * _CH[ctype] // 8)
    flat = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    flat = flat.reshape(H, -1)
    return flat[:, 0], flat[:, 1:].reshape(H, -1, bpp)


@pytest.mark.parametrize("path", FORMS, ids=lambda p: p.stem)
def test_fixture_forms_take_the_row_pass(path):
    """The fixture's pages filter every row with Sub, so they take the
    row-vectorized pass, which agrees with the wavefront on them."""
    filters, raw = _filtered_rows(path)
    assert filters.max() <= 2, np.bincount(filters)
    np.testing.assert_array_equal(png._unfilter_rows(raw, filters),
                                  png._unfilter_wavefront(raw, filters))


@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_read_png_matches_cv2_on_imwrite(tmp_path, level):
    """A page-like image through libpng's adaptive filters."""
    rng = np.random.default_rng(level)
    img = np.full((90, 130), 255, np.uint8)
    for _ in range(40):
        y, x = rng.integers(0, 80), rng.integers(0, 120)
        img[y:y + 6, x:x + 9] = rng.integers(0, 200)
    img = cv2.GaussianBlur(img, (5, 5), 1.2)
    img[::7] = rng.integers(0, 256, img[::7].shape)
    path = str(tmp_path / "w.png")
    cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
    assert _filtered_rows(path)[0].max() > 2      # the wavefront pass
    np.testing.assert_array_equal(read_png_gray(path), cv2.imread(path, 0))


@pytest.mark.parametrize("ctype,depth", [
    (0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1),
    (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)])
def test_read_png_matches_cv2_on_every_format(tmp_path, ctype, depth):
    """Hand-built PNGs whose rows cycle through the five filter types."""
    rng = np.random.default_rng(ctype * 100 + depth)
    H, W = 10, 13
    arr = rng.integers(0, 1 << depth, (H, W, _CH[ctype]))
    palette = None
    if ctype == 3:
        palette = rng.integers(0, 256, (1 << depth, 3))
    if ctype in (2, 6):                       # grey pixels in colour files
        arr[0, :, 1] = arr[0, :, 2] = arr[0, :, 0]
    path = tmp_path / "h.png"
    path.write_bytes(_png(arr, depth, ctype, palette))
    np.testing.assert_array_equal(read_png_gray(str(path)),
                                  cv2.imread(str(path), 0))


def test_read_png_refuses_interlaced(tmp_path):
    """Adam7 (method 1) decodes (``tests/test_torch_leftovers.py``); an
    interlace method PNG does not define is refused."""
    path = tmp_path / "i.png"
    path.write_bytes(_png(np.zeros((4, 4, 1), np.int64), 8, 0, interlace=2))
    with pytest.raises(ValueError, match="interlace method 2"):
        read_png_gray(str(path))


# ---------------------------------------------------------------------------
# IAM / RIMES
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", XMLS, ids=lambda p: p.stem)
def test_iam_parsing_matches_jax(path):
    for j_parse, p_parse in ((JI.parse_form_xml, PI.parse_form_xml),
                             (JI.parse_form_words, PI.parse_form_words)):
        (j_lines, j_w), (p_lines, p_w) = j_parse(str(path)), p_parse(
            str(path))
        assert p_w == j_w and len(p_lines) > 0
        assert [(l.bounds, l.text) for l in p_lines] == \
            [(l.bounds, l.text) for l in j_lines]


RIMES_XML = """<?xml version="1.0" encoding="utf-8"?>
<Lines>
  <SinglePage FileName="images/p001.png">
    <Paragraph>
      <Line Top="10" Bottom="52" Left="5" Right="300" Value="Madame &amp; Monsieur"/>
      <Line Top="70" Bottom="101" Left="8" Right="250" Value="je vous écris"/>
    </Paragraph>
  </SinglePage>
  <SinglePage FileName="p002.png">
    <Paragraph>
      <Line Top="20" Bottom="60" Left="0" Right="199" Value="à bientôt"/>
    </Paragraph>
  </SinglePage>
</Lines>
"""


def test_rimes_parsing_matches_jax(tmp_path):
    path = tmp_path / "lines.xml"
    path.write_text(RIMES_XML, encoding="utf-8")
    want, got = JR.parse_rimes_lines_xml(str(path)), \
        PR.parse_rimes_lines_xml(str(path))
    assert list(got) == list(want) == ["p001.png", "p002.png"]
    for k in want:
        assert [(l.bounds, l.text) for l in got[k]] == \
            [(l.bounds, l.text) for l in want[k]]


def test_iam_line_loads_match_jax():
    """Page decode + crop + cubic resize of every fixture line (the widths
    cap one of them), within one grey level of the JAX loader's."""
    for max_width in (1300, 200):
        j_recs = JD.iam_records(str(FIXTURE), "train", 64, max_width)
        p_recs = PD.iam_records(str(FIXTURE), "train", 64, max_width)
        assert [(r.author, r.gt, r.rid) for r in p_recs] == \
            [(r.author, r.gt, r.rid) for r in j_recs]
        for jr, pr in zip(j_recs, p_recs):
            want, got = jr.load(), pr.load()
            assert got.shape == want.shape and got.dtype == np.float32
            assert np.abs(got - want).max() <= 1.0 / 128 + 1e-6


# ---------------------------------------------------------------------------
# image ops against OpenCV
# ---------------------------------------------------------------------------

def _page(seed, h, w):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w)).astype(np.uint8)
    return cv2.GaussianBlur(img, (5, 5), 2) if seed % 2 else img


def test_resize_cubic_matches_cv2():
    """Within one grey level; the share of +-1 pixels is printed."""
    rng = np.random.default_rng(0)
    off = total = 0
    for t in range(24):
        h, w = int(rng.integers(20, 120)), int(rng.integers(20, 400))
        img = _page(t, h, w)
        pct = 64 / h if t % 3 == 0 else float(rng.uniform(0.3, 3.0))
        want = cv2.resize(img, (0, 0), fx=pct, fy=pct,
                          interpolation=cv2.INTER_CUBIC)
        got = ops.resize_cubic_u8(img, pct)
        assert got.shape == want.shape
        d = np.abs(got.astype(int) - want)
        assert d.max() <= 1
        off += int((d > 0).sum())
        total += d.size
    print(f"resize_cubic_u8: {off / total:.5%} of pixels off by 1")


def test_resize_linear_matches_cv2():
    rng = np.random.default_rng(1)
    for _ in range(20):
        gh, gw = int(rng.integers(2, 10)), int(rng.integers(2, 40))
        grid = rng.normal(0, 1.5, (gh, gw)).astype(np.float32)
        W, H = int(rng.integers(30, 500)), int(rng.integers(30, 100))
        want = cv2.resize(grid, (W, H))
        got = ops.resize_linear_f32(grid, (W, H))
        assert got.dtype == np.float32 and got.shape == want.shape
        # relative to the grid's scale: float32 sums in another order
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_remap_matches_cv2():
    rng = np.random.default_rng(2)
    for _ in range(12):
        H, W = 64, int(rng.integers(50, 400))
        img = rng.integers(0, 256, (H, W)).astype(np.uint8)
        ys, xs = np.meshgrid(np.arange(H, dtype=np.float32),
                             np.arange(W, dtype=np.float32), indexing="ij")
        mx = xs + rng.normal(0, 3, (H, W)).astype(np.float32)
        my = ys + rng.normal(0, 3, (H, W)).astype(np.float32)
        want = cv2.remap(img, mx, my, cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_CONSTANT, borderValue=255)
        got = ops.remap_linear_u8(img, mx, my, border=255)
        assert np.abs(got.astype(int) - want).max() <= 1


def test_gaussian_blur_matches_cv2():
    rng = np.random.default_rng(3)
    for _ in range(12):
        H, W = 64, int(rng.integers(50, 400))
        f = rng.uniform(0, 255, (H, W)).astype(np.float32)
        sigma = float(rng.uniform(0.06, 0.9))
        want = cv2.GaussianBlur(f, (0, 0), sigma)
        got = ops.gaussian_blur_f32(f, sigma)
        assert np.abs(got - want).max() <= 1e-3


def _stroke_gap(got, want):
    """Mean |diff| and the ink mass (sum of 255 - px) ratio."""
    mad = float(np.abs(got.astype(int) - want).mean())
    ink_want = float((255 - want.astype(np.int64)).sum())
    return mad, float((255 - got.astype(np.int64)).sum()) / ink_want


@pytest.mark.parametrize("thickness", [1, 2, 3])
def test_strokes_match_cv2(thickness):
    """Lines and 7-point polylines, some leaving the image, within the
    stroke bounds per image; the worst values are printed."""
    rng = np.random.default_rng(10 + thickness)
    worst = (0.0, 0.0)
    for t in range(40):
        a = np.full((40, 60), 255, np.uint8)
        b = a.copy()
        value = int(rng.integers(0, 120))
        lo, hi = (0, 40) if t % 2 else (-5, 65)
        if t % 4 < 2:
            p0, p1 = (tuple(int(v) for v in rng.integers(lo, hi, 2))
                      for _ in range(2))
            cv2.line(a, p0, p1, value, thickness, lineType=cv2.LINE_AA)
            ops.draw_line_aa(b, p0, p1, value, thickness)
        else:
            pts = rng.integers(lo, hi, (7, 2)).astype(np.int32)
            cv2.polylines(a, [pts], False, value, thickness,
                          lineType=cv2.LINE_AA)
            ops.draw_polyline_aa(b, pts, value, thickness)
        if (a == 255).all():
            continue
        mad, ink = _stroke_gap(b, a)
        assert mad <= STROKE_MEAN_ABS and abs(ink - 1) <= STROKE_INK_RTOL, \
            (t, mad, ink)
        worst = max(worst[0], mad), max(worst[1], abs(ink - 1))
    print(f"strokes, thickness {thickness}: mean |diff| <= {worst[0]:.4f}, "
          f"|ink ratio - 1| <= {worst[1]:.5f}")


# ---------------------------------------------------------------------------
# the synthetic corpus
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("version,split", [(2, "train"), (2, "valid"),
                                           (3, "train"), (3, "valid")])
def test_synthetic_records_match_jax(version, split):
    want = JD.synthetic_records(split, 64, J_CHARSET, n_authors=30,
                                lines_per_author=7, version=version)
    got = PD.synthetic_records(split, 64, IAM_CHARSET, n_authors=30,
                               lines_per_author=7, version=version)
    assert [(r.author, r.gt, r.rid) for r in got] == \
        [(r.author, r.gt, r.rid) for r in want]
    j_corpus = JS.SyntheticCorpus(30, 7, J_CHARSET, seed=1, version=version)
    p_corpus = PS.SyntheticCorpus(30, 7, IAM_CHARSET, seed=1,
                                  version=version)
    assert p_corpus.records == j_corpus.records


def _u8(img):
    return np.rint((1.0 - img) * 128.0).astype(np.int64)


def _renders(version, n=8):
    """(JAX, port) u8 renders of the first ``n`` lines of a corpus."""
    j = JS.SyntheticCorpus(4, 4, J_CHARSET, 64, seed=5, version=version)
    p = PS.SyntheticCorpus(4, 4, IAM_CHARSET, 64, seed=5, version=version)
    return [(_u8(j.get(i)[0]), _u8(p.get(i)[0])) for i in range(n)]


@pytest.mark.parametrize("version", [2, 3])
def test_renders_with_cv2_strokes_match_jax(monkeypatch, version):
    """The layout, the draw order, the warp, the blur and the noise: with
    OpenCV's stroke drawer in the port's place, within one grey level."""
    def line(img, p0, p1, value, thickness):
        return cv2.line(img, p0, p1, value, thickness, lineType=cv2.LINE_AA)

    def polyline(img, pts, value, thickness):
        return cv2.polylines(img, [pts], False, value, thickness,
                             lineType=cv2.LINE_AA)
    monkeypatch.setattr(PS, "_draw_line", line)
    monkeypatch.setattr(PS, "_draw_polyline", polyline)
    for want, got in _renders(version):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1


@pytest.mark.parametrize("version", [2, 3])
def test_renders_match_jax(version):
    """The port's own stroke drawer: within the stroke bounds per line."""
    gaps = []
    for want, got in _renders(version):
        assert got.shape == want.shape
        gaps.append(_stroke_gap(got.astype(np.uint8), want.astype(np.uint8)))
        assert gaps[-1][0] <= STROKE_MEAN_ABS
        assert abs(gaps[-1][1] - 1) <= STROKE_INK_RTOL
    print(f"v{version} renders: mean |diff| <= "
          f"{max(g[0] for g in gaps):.4f}, ink ratio "
          f"{min(g[1] for g in gaps):.5f}..{max(g[1] for g in gaps):.5f}")
