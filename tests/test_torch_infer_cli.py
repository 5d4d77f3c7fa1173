"""The port's inference CLIs on the CPU (``--device cpu``): ``get_styles``,
``generate`` (every mode), ``evaluate`` (each checkpoint layout, the side
channels, ``--quality``), ``eval_writer_id``, ``play_styles`` and
``parse_mturk``, over a tiny run directory written by the port's own
``save_checkpoint`` from a seeded ``HWWithStyle``; the checkpoint loader;
and the size-taking cubic resize against OpenCV's."""

import json
import pathlib

import cv2
import numpy as np
import pytest
import torch

from handwriting_line_generation_tpu.analysis import mturk as JMT
from handwriting_line_generation_tpu.inference import styles as JS
from handwriting_line_generation_tpu_torch import (
    eval_writer_id, evaluate, generate, get_styles, parse_mturk, play_styles,
)
from handwriting_line_generation_tpu_torch.config import (
    Config, DataConfig, DiscriminatorConfig, GeneratorConfig, HWRConfig,
    ModelConfig, SpacerConfig, StyleConfig, load_config,
)
from handwriting_line_generation_tpu_torch.data.datasets import (
    get_charset, make_batcher,
)
from handwriting_line_generation_tpu_torch.data.imageops import \
    resize_cubic_to_u8
from handwriting_line_generation_tpu_torch.inference.eval import Evaluator
from handwriting_line_generation_tpu_torch.inference.generate import (
    GenerationSession, to_uint8,
)
from handwriting_line_generation_tpu_torch.inference.load import load_model
from handwriting_line_generation_tpu_torch.inference.quality import \
    QualityEvaluator
from handwriting_line_generation_tpu_torch.inference.styles import (
    StyleExtractor, load_styles, styles_by_author,
)
from handwriting_line_generation_tpu_torch.init import init_model
from handwriting_line_generation_tpu_torch.utils.checkpoint import \
    save_checkpoint
from handwriting_line_generation_tpu_torch.utils.png import (
    read_png_gray, write_png_gray,
)

STEP = 7
COUNT = 3
TEXT = "hello"
CLIS = {"get_styles": get_styles, "generate": generate,
        "evaluate": evaluate, "eval_writer_id": eval_writer_id,
        "play_styles": play_styles, "parse_mturk": parse_mturk}


def _tiny_config():
    cfg = Config(name="tiny")
    cfg.data = DataConfig(dataset="synthetic", batch_size=2, a_batch_size=2,
                          width_buckets=(128,), label_buckets=(12,),
                          augmentation=None, fg_masks=False,
                          synthetic_authors=3, synthetic_lines=4)
    cfg.model = ModelConfig(
        hwr=HWRConfig(kind="cnn_only", norm="group"),
        style=StyleConfig(style_dim=32, dim=16, char_dim=16, window=2,
                          char_capacity=4),
        generator=GeneratorConfig(dim=32),
        discriminator=DiscriminatorConfig(dim=16),
        spacer=SpacerConfig(dim=32))
    return cfg


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A config file and a run directory holding ``checkpoint-latest``
    (a trainer-shaped dict), ``model_best`` (``{"model": ...}``, other
    weights) and ``checkpoint-latest-swa`` (bare parameters, other again)."""
    root = tmp_path_factory.mktemp("infer")
    cfg_path = root / "cfg.json"
    cfg_path.write_text(json.dumps(_tiny_config().to_dict()))
    run_dir = root / "run"
    models = {}
    for seed, name in enumerate(["checkpoint-latest", "model_best",
                                 "checkpoint-latest-swa"]):
        models[name] = init_model(_tiny_config().model, seed)
    meta = {"iteration": STEP}
    save_checkpoint(str(run_dir), "checkpoint-latest",
                    {"model": models["checkpoint-latest"].state_dict(),
                     "step": STEP, "opt_main": None}, meta)
    save_checkpoint(str(run_dir), "model_best",
                    {"model": models["model_best"].state_dict()}, meta)
    save_checkpoint(str(run_dir), "checkpoint-latest-swa",
                    dict(models["checkpoint-latest-swa"].named_parameters()),
                    meta)
    return dict(root=root, cfg=str(cfg_path), dir=str(run_dir),
                models=models)


def _cfg(run):
    return load_config(run["cfg"])


def _same_weights(a, b):
    return all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))


def _json_out(capsys):
    out = capsys.readouterr().out
    return json.loads(out[out.index("{"):])


# -- the checkpoint loader ------------------------------------------------


@pytest.mark.parametrize("name", ["checkpoint-latest", "model_best",
                                  "checkpoint-latest-swa"])
def test_load_model_layouts(run, name):
    """Each layout's weights; ``-swa``'s parameters over the base's
    buffers; the step from the checkpoint or its sidecar."""
    model, step = load_model(_cfg(run), run["dir"], name, device="cpu")
    assert step == STEP and not model.training
    want = run["models"][name]
    for k, v in model.named_parameters():
        torch.testing.assert_close(v, dict(want.named_parameters())[k],
                                   rtol=0, atol=0)
    base = run["models"][name.replace("-swa", "")]
    for k, v in model.named_buffers():
        torch.testing.assert_close(v, dict(base.named_buffers())[k],
                                   rtol=0, atol=0)


def test_load_model_names_what_it_found(run):
    with pytest.raises(FileNotFoundError) as e:
        load_model(_cfg(run), run["dir"], "checkpoint-iteration5",
                   device="cpu")
    msg = str(e.value)
    assert "checkpoint-iteration5" in msg and "model_best" in msg \
        and "checkpoint-latest-swa" in msg
    with pytest.raises(FileNotFoundError, match="model_best-swa"):
        load_model(_cfg(run), run["dir"], "model_best-swa", device="cpu")


# -- evaluate --------------------------------------------------------------


@pytest.mark.parametrize("name", ["checkpoint-latest", "model_best",
                                  "checkpoint-latest-swa"])
def test_evaluate_json_equals_evaluator(run, name, capsys, tmp_path):
    """The printed metrics are ``Evaluator.run``'s on the same weights and
    split; every channel written."""
    argv = ["-c", run["cfg"], "-k", run["dir"], "--ckpt-name", name,
            "-o", str(tmp_path), "--device", "cpu", "--save-images",
            "--save-styles", "--save-spaced", "--save-preds", "--save-nns",
            "--save-gen"]
    assert evaluate.main(argv) == 0
    got = _json_out(capsys)
    cfg = _cfg(run)
    model, _ = load_model(cfg, run["dir"], name, device="cpu")
    want = Evaluator(model, get_charset(cfg.data), device="cpu").run(
        make_batcher(cfg.data, "valid"))
    assert got == pytest.approx(want, rel=1e-12)
    for f in ("styles.npz", "spaced.npz", "preds.csv", "nns.csv",
              "recon_0_0.png", "gen_0_0.png"):
        assert (tmp_path / f).exists(), f


def test_evaluate_quality_json(run, capsys, tmp_path):
    """``--quality`` over the split's transcriptions (no corpus in the
    config): the harness's metrics, and the first lines as PNGs."""
    argv = ["-c", run["cfg"], "-k", run["dir"], "--quality", "--n-gen", "3",
            "-o", str(tmp_path), "--device", "cpu"]
    assert evaluate.main(argv) == 0
    got = _json_out(capsys)
    cfg = _cfg(run)
    model, _ = load_model(cfg, run["dir"], device="cpu")
    batcher = make_batcher(cfg.data, "valid")
    texts = []
    for b in batcher.batches(np.random.default_rng(0), shuffle=False):
        texts.extend(b["gt"])
    want = QualityEvaluator(model, get_charset(cfg.data), device="cpu").run(
        batcher, texts[:3])
    assert got == pytest.approx(want, rel=1e-9)
    assert len(list(tmp_path.glob("gen_*.png"))) == 3


def test_evaluate_texts_file(run, capsys, tmp_path):
    texts = tmp_path / "texts.txt"
    texts.write_text("ab cd\nefg\nhij\n")
    argv = ["-c", run["cfg"], "-k", run["dir"], "--quality", "--texts",
            str(texts), "--n-gen", "2", "--device", "cpu"]
    assert evaluate.main(argv) == 0
    assert np.isfinite(_json_out(capsys)["gen_CER"])


# -- get_styles ------------------------------------------------------------


def test_get_styles_equals_extract_dataset(run, tmp_path):
    argv = ["-c", run["cfg"], "-k", run["dir"], "-o", str(tmp_path),
            "--device", "cpu"]
    assert get_styles.main(argv) == 0
    cfg = _cfg(run)
    model, _ = load_model(cfg, run["dir"], device="cpu")
    ex = StyleExtractor(model, device="cpu")
    for split in ("train", "valid"):
        got = load_styles(str(tmp_path / f"{split}_styles_{STEP}.npz"))
        want = ex.extract_dataset(make_batcher(cfg.data, split))
        np.testing.assert_array_equal(got["styles"], want["styles"])
        assert got["authors"] == want["authors"]
        assert got["ids"] == want["ids"]


def test_get_styles_through_emb_and_test_split(run, tmp_path):
    argv = ["-c", run["cfg"], "-k", run["dir"], "-o", str(tmp_path), "-T",
            "-S", "-n", "1", "--device", "cpu"]
    assert get_styles.main(argv) == 0
    got = load_styles(str(tmp_path / f"test_styles_{STEP}.npz"))
    assert got["styles"].shape == (2, 32)
    assert not (tmp_path / f"train_styles_{STEP}.npz").exists()


# -- generate --------------------------------------------------------------


@pytest.fixture(scope="module")
def bank(run):
    out = run["root"] / "bank"
    assert get_styles.main(["-c", run["cfg"], "-k", run["dir"], "-o",
                            str(out), "--device", "cpu"]) == 0
    path = str(out / f"train_styles_{STEP}.npz")
    return path, load_styles(path)


def _from_to_images(root):
    """Two handwriting-like PNGs of other heights than the model's."""
    paths = []
    for i, (h, w) in enumerate([(80, 300), (50, 170)]):
        rng = np.random.default_rng(i)
        img = rng.integers(225, 256, (h, w)).astype(np.uint8)
        for x in range(4, w - 8, 13):
            img[h // 3:2 * h // 3, x:x + 4] = rng.integers(0, 60)
        p = root / f"line{i}.png"
        write_png_gray(str(p), img)
        paths.append(str(p))
    return paths


def _expected(mode, session, data, cfg, paths):
    """The images of each mode, restated from the session's calls."""
    bank = data["styles"]
    texts = [TEXT] * COUNT
    rng = np.random.default_rng(0)
    if mode == "render":
        return session.random_interpolated(texts, bank, seed=0)
    if mode == "interp":
        a, b = bank[rng.integers(0, len(bank), 2)]
        return session.interpolate(TEXT, a, b, steps=COUNT, seed=0)
    if mode == "stretch":
        style = bank[rng.integers(0, len(bank))]
        return np.concatenate(session.stretch_sweep(TEXT, style, seed=0))
    if mode == "math":
        a, b, c = bank[rng.integers(0, len(bank), 3)]
        return session.style_math(TEXT, a, b, c, seed=0)
    if mode == "author":
        by = styles_by_author(data)
        return session.author_samples(texts, by, sorted(by)[0], seed=0)
    if mode == "vae":
        z = rng.standard_normal((COUNT, cfg.model.style.style_dim))
        return session.render(texts, z.astype(np.float32), seed=0)
    if mode == "from-to":
        ex = StyleExtractor(session.model, device="cpu")
        styles = []
        for p in paths:
            img = read_png_gray(p)
            w = max(4, round(img.shape[1] * 64 / img.shape[0]) // 4 * 4)
            img = resize_cubic_to_u8(img, (w, 64))
            x = (1.0 - img.astype(np.float32) / 128.0)[None, :, :, None]
            s, _ = ex.extract(torch.from_numpy(x),
                              torch.tensor([max(1, w // 4)]), 1)
            styles.append(s[0].numpy())
        return session.interpolate(TEXT, *styles, steps=COUNT, seed=0)
    return np.stack(session.mturk_batch(texts, bank, seed=0))


@pytest.mark.parametrize("mode", generate.MODES)
def test_generate_mode_writes_session_output(run, bank, mode, tmp_path):
    """``{mode}_{i:03d}.png`` per image, read back equal to ``to_uint8`` of
    the session's output (from-to: the styles of two PNGs resized by
    ``resize_cubic_to_u8``, which is held against OpenCV below)."""
    path, data = bank
    paths = _from_to_images(tmp_path)
    argv = ["-c", run["cfg"], "-k", run["dir"], "-m", mode, "-n", str(COUNT),
            "-t", TEXT, "-o", str(tmp_path / "out"), "--device", "cpu"]
    if mode == "from-to":
        argv += ["--from-image", paths[0], "--to-image", paths[1]]
    elif mode != "vae":
        argv += ["-s", path]
    assert generate.main(argv) == 0
    cfg = _cfg(run)
    model, _ = load_model(cfg, run["dir"], device="cpu")
    session = GenerationSession(model, get_charset(cfg.data), device="cpu")
    want = _expected(mode, session, data, cfg, paths)
    files = sorted((tmp_path / "out").glob(f"{mode}_*.png"))
    assert [f.name for f in files] == [f"{mode}_{i:03d}.png"
                                       for i in range(len(want))]
    assert len(files) == (5 if mode == "stretch" else
                          1 if mode == "math" else COUNT)
    for f, w in zip(files, want):
        np.testing.assert_array_equal(read_png_gray(str(f)), to_uint8(w))


def test_generate_needs_styles(run, tmp_path):
    with pytest.raises(SystemExit):
        generate.main(["-c", run["cfg"], "-k", run["dir"], "-m", "render",
                       "--device", "cpu"])


# -- the style-bank and study CLIs ----------------------------------------


@pytest.mark.parametrize("metric", ["l1", "l2"])
def test_eval_writer_id_and_play_styles(bank, metric, capsys):
    path, _ = bank
    data = JS.load_styles(path)
    assert eval_writer_id.main([path, "--metric", metric,
                                "--device", "cpu"]) == 0
    got = _json_out(capsys)
    assert got == pytest.approx({"n": len(data["authors"]),
                                 **JS.writer_id_retrieval(data, metric),
                                 **JS.inter_intra_distances(data)})
    assert play_styles.main([path, "--metric", metric,
                             "--device", "cpu"]) == 0
    got = _json_out(capsys)
    assert got == pytest.approx({"n": len(data["authors"]),
                                 **JS.inter_intra_distances(data, metric)})


def test_play_styles_heatmap_not_ported(bank, tmp_path):
    with pytest.raises(NotImplementedError, match="applyColorMap"):
        play_styles.main([bank[0], "--heatmap", str(tmp_path / "h.png"),
                          "--device", "cpu"])


def test_parse_mturk_matches_jax(tmp_path, capsys):
    rows = [("w1", "real", "1", "1"), ("w1", "gen", "1", "1"),
            ("w1", "gold", "0", "1"), ("w2", "gen", "0", "true"),
            ("w2", "gold", "1", "0"), ("w3", "real", "0", "1")]
    p = tmp_path / "study.csv"
    p.write_text("worker,gt,answered_real,transcription_ok\n"
                 + "\n".join(",".join(r) for r in rows) + "\n")
    assert parse_mturk.main([str(p), "--workers", "--device", "cpu"]) == 0
    got = _json_out(capsys)
    want = JMT.score_study([{"worker": w, "gt": g,
                             "answered_real": a in ("1", "true"),
                             "transcription_ok": t in ("1", "true")}
                            for w, g, a, t in rows])
    assert got == json.loads(json.dumps(want))


# -- devices ---------------------------------------------------------------


def _argv(name, run, bank_path, csv_path):
    if name in ("eval_writer_id", "play_styles"):
        return [bank_path]
    if name == "parse_mturk":
        return [csv_path]
    argv = ["-c", run["cfg"], "-k", run["dir"]]
    return argv + (["-s", bank_path] if name == "generate" else [])


@pytest.mark.parametrize("name", list(CLIS))
def test_cli_needs_cuda_or_explicit_cpu(run, bank, name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    csv_path = tmp_path / "s.csv"
    csv_path.write_text("worker,gt,answered_real,transcription_ok\n")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CLIS[name].main(_argv(name, run, bank[0], str(csv_path)))


# -- the cubic resize to a size ---------------------------------------------


@pytest.mark.parametrize("shape,size", [((80, 300), (240, 64)),
                                        ((50, 170), (216, 64)),
                                        ((64, 448), (448, 64)),
                                        ((120, 31), (16, 64)),
                                        ((64, 100), (300, 64))])
def test_resize_cubic_to_matches_opencv(shape, size):
    """Within one grey level of ``cv2.resize(..., INTER_CUBIC)`` to a size
    (each axis at its own scale, shrinking and enlarging)."""
    img = np.random.default_rng(shape[1]).integers(0, 256, shape).astype(
        np.uint8)
    got = resize_cubic_to_u8(img, size)
    want = cv2.resize(img, size, interpolation=cv2.INTER_CUBIC)
    assert got.shape == want.shape == (size[1], size[0])
    assert np.abs(got.astype(int) - want).max() <= 1
