"""The plotting and dataset-dump CLIs of the port, on numpy alone: the RGB
PNG writer and reader, the colour tables against OpenCV's and
matplotlib's, ``play_styles --heatmap`` and ``inspect_dataset`` against
the repository's root scripts (which use OpenCV) pixel for pixel, the
style map's and the training curves' geometry against the axis transform,
the ``graph`` and ``umap_styles`` CLIs, and the two scripts copied from
the root ``scripts/``.  OpenCV and matplotlib are read in
the tests only."""

import contextlib
import io
import json
import pathlib
import runpy
import sys

import cv2
import matplotlib
import numpy as np
import pytest
import threadpoolctl
import torch

from handwriting_line_generation_tpu.inference.styles import \
    umap_embed as j_umap_embed
from handwriting_line_generation_tpu.utils.train_log import \
    TrainLog as JTrainLog
from handwriting_line_generation_tpu_torch import (
    graph, inspect_dataset, play_styles, umap_styles,
)
from handwriting_line_generation_tpu_torch.config import load_config
from handwriting_line_generation_tpu_torch.inference.styles import (
    STYLE_DOT_RADIUS, plot_style_map, save_styles, umap_embed,
)
from handwriting_line_generation_tpu_torch.scripts import (
    compile_text_corpus, summarize_quality,
)
from handwriting_line_generation_tpu_torch.utils.colormap import (
    TAB10, TAB20, VIRIDIS, apply_colormap,
)
from handwriting_line_generation_tpu_torch.utils.png import (
    read_png_gray, read_png_rgb, write_png_gray, write_png_rgb,
)
from handwriting_line_generation_tpu_torch.utils.raster_plot import (
    GREY, Canvas, area_resize, data_limits, nice_ticks,
)
from handwriting_line_generation_tpu_torch.utils.train_log import TrainLog

REPO = pathlib.Path(__file__).resolve().parents[1]
MINI_IAM = REPO / "tests" / "fixtures" / "mini_iam"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's side on one torch thread and one BLAS thread (several
    test processes share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


def _root_script(name, argv):
    """The repository's root script ``name`` run as ``__main__`` with
    ``argv``; returns its stdout."""
    out = io.StringIO()
    old = sys.argv
    sys.argv = [name] + [str(a) for a in argv]
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(str(REPO / name), run_name="__main__")
    finally:
        sys.argv = old
    return out.getvalue()


def _cli(module, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert module.main([str(a) for a in argv]) == 0
    return out.getvalue()


def _cv2_rgb(path):
    return cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1]


# -- PNG and colour tables ----------------------------------------------------


def test_rgb_png_round_trip(tmp_path):
    """``write_png_rgb`` decodes in OpenCV to the same pixels; the port's
    RGB and grey readers agree with ``cv2.imread`` on it and on a grey
    PNG."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (17, 23, 3)).astype(np.uint8)
    path = str(tmp_path / "rgb.png")
    write_png_rgb(path, img)
    np.testing.assert_array_equal(_cv2_rgb(path), img)
    np.testing.assert_array_equal(read_png_rgb(path), img)
    np.testing.assert_array_equal(read_png_gray(path),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    grey = str(tmp_path / "grey.png")
    write_png_gray(grey, img[..., 0])
    np.testing.assert_array_equal(read_png_rgb(grey),
                                  np.repeat(img[..., :1], 3, axis=2))
    with pytest.raises(ValueError, match=r"\[H, W, 3\]"):
        write_png_rgb(path, img[..., 0])


def test_viridis_equals_opencv():
    """``apply_colormap`` equals ``cv2.applyColorMap(.., VIRIDIS)`` (BGR)
    at all 256 values."""
    ramp = np.arange(256, dtype=np.uint8).reshape(16, 16)
    want = cv2.applyColorMap(ramp, cv2.COLORMAP_VIRIDIS)[..., ::-1]
    np.testing.assert_array_equal(apply_colormap(ramp), want)
    assert VIRIDIS.shape == (256, 3)


@pytest.mark.parametrize("name,table", [("tab10", TAB10), ("tab20", TAB20)])
def test_tab_tables_equal_matplotlib(name, table):
    colors = np.asarray(matplotlib.colormaps[name].colors)
    np.testing.assert_array_equal(table, np.rint(colors * 255).astype(int))


# -- the heatmap --------------------------------------------------------------


def _bank(n_authors, per, dim=6, seed=0, spread=0.3):
    """A style bank: ``per`` styles an author around its own centre."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(n_authors, dim)) * 3
    styles = (np.repeat(centres, per, axis=0)
              + spread * rng.normal(size=(n_authors * per, dim)))
    authors = [f"w{a:02d}" for a in range(n_authors) for _ in range(per)]
    order = rng.permutation(len(authors))          # authors interleaved
    return {"styles": styles[order].astype(np.float32),
            "authors": [authors[i] for i in order],
            "ids": [f"s{i}" for i in range(len(authors))]}


@pytest.mark.parametrize("metric,cap", [("l2", 512), ("l1", 512),
                                        ("l2", 9)])
def test_heatmap_equals_the_root_script(tmp_path, metric, cap):
    """``play_styles --heatmap`` decodes pixel for pixel equal to the root
    script's ``cv2.imwrite`` of ``applyColorMap`` on the same bank, and its
    JSON statistics are the root script's."""
    bank = str(tmp_path / "bank.npz")
    save_styles(bank, _bank(5, 4))
    flags = [bank, "--metric", metric, "--max-styles", cap]
    want = _root_script("play_styles.py",
                        flags + ["--heatmap", tmp_path / "root.png"])
    got = _cli(play_styles, flags + ["--heatmap", tmp_path / "port.png",
                                     "--device", "cpu"])
    assert got.replace("port.png", "P") == want.replace("root.png", "P")
    np.testing.assert_array_equal(read_png_rgb(str(tmp_path / "port.png")),
                                  _cv2_rgb(tmp_path / "root.png"))
    assert read_png_gray(str(tmp_path / "port.png")).shape == \
        (min(cap, 20),) * 2


# -- the canvas and the style map --------------------------------------------


def test_ticks_and_limits():
    """matplotlib's default 5% margin, and ticks at 1/2/2.5/5 steps."""
    assert data_limits([0, 100]) == (-5.0, 105.0)
    assert data_limits([3, 3]) == (2.45, 3.55)
    assert nice_ticks(-0.3, 10.7) == [0, 2, 4, 6, 8, 10]
    assert nice_ticks(0.01, 0.0734) == [0.01, 0.02, 0.03, 0.04, 0.05,
                                        0.06, 0.07]


def _dot_centres(img, px, py, color, radius=4):
    """The centroid of the pixels of exactly ``color`` within ``radius`` of
    each ``(px, py)``."""
    out = []
    for x, y in zip(px, py):
        ys, xs = np.nonzero((img[y - radius:y + radius + 1,
                                 x - radius:x + radius + 1] == color).all(-1))
        out.append((xs.mean() + x - radius, ys.mean() + y - radius)
                   if len(xs) else (np.nan, np.nan))
    return np.array(out)


@pytest.mark.parametrize("n_authors", [24, 6])
def test_style_map_geometry(tmp_path, n_authors):
    """960 x 960; the embedding (PCA here: no ``umap``) the JAX
    package's within 1e-6; each isolated dot centred within 1 px of the
    axis transform in ``TAB20[sorted author index % 20]``; a legend of
    the authors only at <= 20 of them."""
    data = _bank(n_authors, 1, seed=n_authors)
    path = str(tmp_path / "map.png")
    got = plot_style_map(data, path)
    img = read_png_rgb(path)
    assert img.shape == (960, 960, 3)
    emb = got["embedding"]
    np.testing.assert_allclose(emb, j_umap_embed(data), rtol=0, atol=1e-6)
    np.testing.assert_allclose(emb, umap_embed(data), rtol=0, atol=0)
    uniq = sorted(set(data["authors"]))
    assert list(got["author_index"]) == [uniq.index(a)
                                         for a in data["authors"]]
    c = Canvas(960, 960, data_limits(emb[:, 0]), data_limits(emb[:, 1]))
    px, py = c.transform(emb[:, 0], emb[:, 1])
    legend = None
    if n_authors <= 20:
        legend = Canvas(960, 960, c.xlim, c.ylim).legend(
            [(a, TAB20[i], "dot") for i, a in enumerate(uniq)],
            avoid=(px, py))
    checked = 0
    for j in range(len(px)):
        d = np.hypot(px - px[j], py - py[j])
        d[j] = np.inf
        if d.min() < 4 * STYLE_DOT_RADIUS or (
                legend and legend[0] - 8 <= px[j] <= legend[2] + 8
                and legend[1] - 8 <= py[j] <= legend[3] + 8):
            continue
        color = TAB20[got["author_index"][j] % 20]
        centre = _dot_centres(img, [px[j]], [py[j]], color)[0]
        assert np.abs(centre - (px[j], py[j])).max() <= 1.0, (j, centre)
        checked += 1
    assert checked >= len(px) // 2
    border = (img == GREY).all(-1)
    assert border.any() == (legend is not None)
    if legend is not None:
        c0, r0, c1, r1 = legend
        assert border[r0, c0:c1 + 1].all() and border[r0:r1 + 1, c1].all()
        box = img[r0:r1 + 1, c0:c1 + 1]
        for i in range(len(uniq)):
            assert (box == TAB20[i]).all(-1).any(), uniq[i]


def test_style_map_thumbnails_and_author_mean(tmp_path):
    """Each ``<id>.png`` pasted at its point, area-averaged to a quarter,
    drawn over the dots; ``author_mean`` plots one point an author, the
    mean of its styles."""
    data = _bank(3, 2, seed=4, spread=0.02)
    thumbs = tmp_path / "thumbs"
    thumbs.mkdir()
    rng = np.random.default_rng(1)
    imgs = {}
    for sid in data["ids"][:2]:
        imgs[sid] = rng.integers(0, 256, (40, 120)).astype(np.uint8)
        write_png_gray(str(thumbs / f"{sid}.png"), imgs[sid])
    path = str(tmp_path / "map.png")
    got = plot_style_map(data, path, thumbnail_dir=str(thumbs))
    img = read_png_rgb(path)
    emb = got["embedding"]
    c = Canvas(960, 960, data_limits(emb[:, 0]), data_limits(emb[:, 1]))
    px, py = c.transform(emb[:, 0], emb[:, 1])
    j = 1                                       # the last one drawn
    t = area_resize(imgs[data["ids"][j]], 0.25)
    assert t.shape == (10, 30)
    r0, c0 = py[j] - 5, px[j] - 15
    np.testing.assert_array_equal(img[r0:r0 + 10, c0:c0 + 30],
                                  np.repeat(t[..., None], 3, axis=2))
    means = plot_style_map(data, str(tmp_path / "mean.png"),
                           author_mean=True)
    assert means["embedding"].shape == (3, 2)
    by = {}
    for s, a in zip(data["styles"], data["authors"]):
        by.setdefault(a, []).append(s)
    want = umap_embed({"styles": np.stack([np.mean(v, 0)
                                           for v in by.values()])})
    np.testing.assert_array_equal(means["embedding"], want)


# -- the training curves ------------------------------------------------------


def _log_entries():
    out = []
    for i in range(10, 201, 10):
        out.append({"iteration": i, "loss": 4.0 - i / 100,
                    "CER": 0.2 + i / 1000, "sec_per_iter": 1.5})
        if i % 50 == 0:
            out.append({"iteration": i, "val_CER": 0.5 + i / 400,
                        "name": "not a number"})
    return out


def test_train_log_plot_geometry(tmp_path):
    """Every key but ``iteration`` (sorted; non-numeric values left out),
    each in the ``tab10`` colour of its sorted index, every sample drawn
    within 1 px of the axis transform in that colour; 1000 x 600."""
    log = TrainLog()
    log.entries = _log_entries()
    path = str(tmp_path / "curves.png")
    curves = log.plot(path)
    assert list(curves) == ["CER", "loss", "sec_per_iter", "val_CER"]
    img = read_png_rgb(path)
    assert img.shape == (600, 1000, 3)
    xs = [x for v in curves.values() for x in v[0]]
    ys = [y for v in curves.values() for y in v[1]]
    c = Canvas(1000, 600, data_limits(xs), data_limits(ys))
    white = np.full(3, 255.0)
    # the legend takes the corner with the fewest samples: none here
    c0, r0, c1, r1 = Canvas(1000, 600, c.xlim, c.ylim).legend(
        [(k, v[2], "line") for k, v in curves.items()],
        avoid=c.transform(xs, ys))
    px, py = c.transform(xs, ys)
    assert not ((px >= c0) & (px <= c1) & (py >= r0) & (py <= r1)).any()
    assert (img[r0, c0:c1 + 1] == GREY).all()
    for i, (k, (kx, ky, color)) in enumerate(curves.items()):
        np.testing.assert_array_equal(color, TAB10[i])
        assert len(kx) == (4 if k == "val_CER" else 20)
        px, py = c.transform(kx, ky)
        ink = color - white
        for x, y in zip(px, py):
            # some pixel within 1 px is the line's colour blended over the
            # white background at a coverage of at least a half
            near = img[y - 1:y + 2, x - 1:x + 2].reshape(-1, 3) - white
            cover = near @ ink / (ink @ ink)
            off = np.linalg.norm(near - cover[:, None] * ink, axis=1)
            assert ((cover >= 0.5) & (off <= 3.0)).any(), (k, x, y)


def test_single_samples_and_the_legend_corner(tmp_path):
    """A key with one sample is drawn as a dot at its point (matplotlib
    would draw nothing); data in the upper right sends the legend to the
    upper left."""
    log = TrainLog()
    log.entries = [{"iteration": i, "loss": float(i)} for i in range(1, 30)]
    log.entries.append({"iteration": 15, "val_CER": 5.0})
    path = str(tmp_path / "c.png")
    curves = log.plot(path)
    img = read_png_rgb(path)
    xs = [x for v in curves.values() for x in v[0]]
    ys = [y for v in curves.values() for y in v[1]]
    c = Canvas(1000, 600, data_limits(xs), data_limits(ys))
    (px,), (py,) = c.transform([15], [5.0])
    assert (img[py, px] == curves["val_CER"][2]).all()
    box = c.legend([(k, v[2], "line") for k, v in curves.items()],
                   avoid=c.transform(xs, ys))
    assert box[0] == c.x0 + 6 and box[1] == c.y0 + 6
    assert (img[box[1], box[0]:box[2] + 1] == GREY).all()


def test_graph_cli_and_csv(tmp_path):
    """``graph`` with ``--csv`` on a trainer's JSON log: the PNG at its
    size and the CSV the JAX ``TrainLog.export_csv`` writes."""
    log_path = tmp_path / "train_log.json"
    log_path.write_text(json.dumps(_log_entries()))
    out = _cli(graph, [log_path, "-o", tmp_path / "c.png", "--csv",
                       tmp_path / "c.csv", "-k", "loss", "val_CER"])
    assert "wrote" in out
    assert read_png_gray(str(tmp_path / "c.png")).shape == (600, 1000)
    JTrainLog.load(str(log_path)).export_csv(str(tmp_path / "j.csv"))
    assert (tmp_path / "c.csv").read_text() == \
        (tmp_path / "j.csv").read_text()


def test_umap_styles_cli(tmp_path):
    bank = str(tmp_path / "bank.npz")
    save_styles(bank, _bank(4, 3))
    _cli(umap_styles, [bank, "-o", tmp_path / "m.png", "--author-mean"])
    assert read_png_rgb(str(tmp_path / "m.png")).shape == (960, 960, 3)


# -- the dataset dump ---------------------------------------------------------


def _dump_config(tmp_path):
    cfg = load_config(str(REPO / "configs" / "iam_gan_paper.json"))
    cfg.data.data_dir = str(MINI_IAM)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg.to_dict()))
    return path


def test_inspect_dataset_equals_the_root_script(tmp_path):
    """On the mini-IAM fixture: ``_line.png`` (the overlay), ``_mask.png``,
    ``_fg.png``, ``gt.txt`` and the width line equal to the root script's
    (OpenCV); ``--augment`` writes one ``_aug.png`` a line, the same files
    again for the same batch seeds."""
    cfg = _dump_config(tmp_path)
    want = _root_script("inspect_dataset.py", ["-c", cfg, "-o",
                                               tmp_path / "root"])
    got = _cli(inspect_dataset, ["-c", cfg, "-o", tmp_path / "port",
                                 "--device", "cpu"])
    root, port = tmp_path / "root", tmp_path / "port"
    width_line = lambda s: s.strip().splitlines()[-1].split("|")[1]
    assert width_line(got) == width_line(want)
    assert (port / "gt.txt").read_text() == (root / "gt.txt").read_text()
    names = sorted(p.name for p in root.glob("*.png"))
    assert names == sorted(p.name for p in port.glob("*.png"))
    assert {n.rsplit("_", 1)[1] for n in names} == {"line.png", "mask.png",
                                                    "fg.png"}
    for n in names:
        a = cv2.imread(str(root / n), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(str(port / n), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(b, a, err_msg=n)
    lines = len((root / "gt.txt").read_text().splitlines())
    for rep in ("a", "b"):
        _cli(inspect_dataset, ["-c", cfg, "-o", tmp_path / rep,
                               "--augment", "--device", "cpu"])
    augs = sorted((tmp_path / "a").glob("*_aug.png"))
    assert len(augs) == lines
    for f in augs:
        assert f.read_bytes() == (tmp_path / "b" / f.name).read_bytes()
        assert read_png_gray(str(f)).shape == read_png_gray(
            str(port / f.name.replace("_aug", "_line"))).shape


# -- the copied scripts -------------------------------------------------------


def test_compile_text_corpus_equals_the_root_script(tmp_path):
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    (src / "a.txt").write_text("Hello, world!\n  ÿ odd é line  \n\n")
    (src / "sub" / "b.json").write_text(json.dumps(
        {"text": "An article.\nWith two lines {braces}"}))
    (src / "c.json").write_text(json.dumps(["not", "a dict"]))
    for charset in ("iam", None):
        flags = [src, "--fraction", "1.0"] + (
            ["--charset", charset] if charset else [])
        _root_script("scripts/compile_text_corpus.py",
                     flags + ["-o", tmp_path / "root.txt"])
        with contextlib.redirect_stdout(io.StringIO()):
            compile_text_corpus.main([str(a) for a in flags]
                                     + ["-o", str(tmp_path / "port.txt")])
        assert (tmp_path / "port.txt").read_text() == \
            (tmp_path / "root.txt").read_text()


def test_summarize_quality_equals_the_root_script(tmp_path, capsys):
    d = REPO / "docs" / "results" / "r5"
    runpy.run_path(str(REPO / "scripts" / "summarize_quality.py"))["main"](
        str(d))
    want = capsys.readouterr().out
    summarize_quality.main(str(d))
    assert capsys.readouterr().out == want and want.startswith("|")
    summarize_quality.main(str(tmp_path))
    assert "no quality JSONs" in capsys.readouterr().out
