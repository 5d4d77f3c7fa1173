"""Port parity for the whole generation slice: ``GenerationSession.render``
(spacer -> insert_spaces -> generator) against the JAX session, on the same
numpy params; plus the port's package boundary (no JAX imports, explicit
devices)."""

import json
import pathlib
import subprocess
import sys

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
from handwriting_line_generation_tpu.inference.generate import (
    GenerationSession as JGenerationSession,
    cast_params_bf16 as j_cast_params_bf16,
)
from handwriting_line_generation_tpu.models.hw_with_style import \
    HWWithStyle as JHWWithStyle
from handwriting_line_generation_tpu_torch import bench
from handwriting_line_generation_tpu_torch.charset import IAM_CHARSET
from handwriting_line_generation_tpu_torch.config import (
    DiscriminatorConfig, GeneratorConfig, HWRConfig, ModelConfig,
    SpacerConfig, StyleConfig,
)
from handwriting_line_generation_tpu_torch.convert import convert_params
from handwriting_line_generation_tpu_torch.inference.generate import (
    GenerationSession, cast_params_bf16, to_uint8,
)
from handwriting_line_generation_tpu_torch.init import init_params
from handwriting_line_generation_tpu_torch.models.hw_with_style import (
    HWWithStyle, pack_style, space_style, unpack_style,
)
from test_torch_threads import one_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.compile   # JAX session compiles dominate

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = "handwriting_line_generation_tpu_torch"
S, DIM, SPACED = 32, 64, 16
TEXTS = ["hello world", "The quick"]


def _cfgs(dtype="float32", fused=True, csd=0, std=None):
    kw = dict(num_class=J_CHARSET.num_class, compute_dtype=dtype)
    if std is not None:
        kw.update(count_std=std, dup_std=std)
    j = JModelConfig(style=JStyleConfig(style_dim=S, char_style_dim=csd),
                     generator=JGeneratorConfig(dim=DIM,
                                                fused_epilogue=fused),
                     discriminator=JDiscriminatorConfig(enabled=False),
                     spacer=JSpacerConfig(dim=32),
                     hwr=JHWRConfig(kind="none"), **kw)
    t = ModelConfig(style=StyleConfig(style_dim=S, char_style_dim=csd),
                    generator=GeneratorConfig(dim=DIM, fused_epilogue=fused),
                    discriminator=DiscriminatorConfig(enabled=False),
                    spacer=SpacerConfig(dim=32), hwr=HWRConfig(kind="none"),
                    **kw)
    return j, t


def _shared_params(tcfg, seed):
    """Seeded numpy params with every NoiseInjection weight zeroed, so the
    noise drops out exactly and the two packages' draws need not agree."""
    params = init_params(tcfg, seed)
    for name, blk in params["generator"].items():
        if name.startswith("StyledConvBlock_"):
            for k in ("NoiseInjection_0", "NoiseInjection_1"):
                blk[k]["weight"][:] = 0.0
    return params


def _pair(dtype, fused, seed=1):
    jcfg, tcfg = _cfgs(dtype, fused)
    params = _shared_params(tcfg, seed)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    model = HWWithStyle(tcfg)
    model.load_state_dict(convert_params(params))
    if dtype == "bfloat16":
        jparams = j_cast_params_bf16(jparams)
        cast_params_bf16(model)
    return (JGenerationSession(JHWWithStyle(jcfg), jparams, J_CHARSET),
            GenerationSession(model, IAM_CHARSET, device="cpu"))


@pytest.mark.parametrize("fused", [False, True])
def test_render_matches_jax_f32(fused):
    """The whole slice in float32: within 1e-4."""
    jsess, sess = _pair("float32", fused)
    styles = np.random.default_rng(0).normal(size=(2, S)).astype(np.float32)
    want = jsess.render(TEXTS, styles, spaced_len=SPACED)
    got = sess.render(TEXTS, styles, spaced_len=SPACED)
    assert got.shape == want.shape == (2, 64, 4 * SPACED, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_render_matches_jax_bf16():
    """Whole-network bfloat16 rounds at other points in the two frameworks
    (XLA may keep excess precision between ops): mean abs diff <= 0.02 in
    the tanh range, the bound the JAX package quotes for bf16 vs f32."""
    jsess, sess = _pair("bfloat16", True)
    styles = np.random.default_rng(0).normal(size=(2, S)).astype(np.float32)
    want = jsess.render(TEXTS, styles, spaced_len=SPACED)
    got = sess.render(TEXTS, styles, spaced_len=SPACED)
    assert np.isfinite(got).all()
    assert np.abs(got - want).mean() <= 0.02


def test_char_style_generate_matches_jax():
    """``char_style_dim > 0``: packed bank rows unpack to tuples, the
    spacer reads the global part and ``space_style`` places char styles
    per position; ``generate`` end to end in f32 within 1e-4."""
    jcfg, tcfg = _cfgs("float32", True, csd=3, std=0.0)
    params = _shared_params(tcfg, seed=2)
    model = HWWithStyle(tcfg)
    model.load_state_dict(convert_params(params))
    rng = np.random.default_rng(3)
    labels = np.stack([IAM_CHARSET.encode("hello"),
                       IAM_CHARSET.encode("abcde")]).astype(np.int32)
    lens = np.array([5, 4], np.int32)
    styles = rng.normal(size=(2, tcfg.packed_style_dim())).astype(np.float32)
    key = jax.random.PRNGKey(0)
    want, waux = JHWWithStyle(jcfg).apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, params)},
        jnp.asarray(labels), jnp.asarray(lens), jnp.asarray(styles), key,
        spaced_len=SPACED, method="generate", rngs={"noise": key})
    with torch.no_grad():
        got, aux = model.generate(
            torch.from_numpy(labels), torch.from_numpy(lens),
            torch.from_numpy(styles), spaced_len=SPACED,
            generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(aux["spaced"].numpy(),
                                  np.asarray(waux["spaced"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    # the port's session renders packed char-style rows too
    sess = GenerationSession(model, IAM_CHARSET, device="cpu")
    assert sess.render(TEXTS, styles, spaced_len=SPACED).shape == \
        (2, 64, 4 * SPACED, 1)


def test_space_style_and_pack_roundtrip():
    spaced = torch.tensor([[0, 2, 0, 3, 0], [1, 1, 0, 4, 0]])
    g = torch.randn(2, 4)
    spacing = torch.randn(2, 3)
    char = torch.randn(2, 5, 3)
    out = space_style(spaced, (g, spacing, char))
    assert torch.equal(out[0, 0], spacing[0])
    assert torch.equal(out[0, 1], char[0, 2])
    assert torch.equal(out[1, 3], char[1, 4])
    g2, s2, c2 = unpack_style(pack_style((g, spacing, char)), 4, 3, 5)
    assert torch.equal(g2, g) and torch.equal(s2, spacing) \
        and torch.equal(c2, char)


def test_cast_params_bf16_is_whole_network():
    _, tcfg = _cfgs()
    model = cast_params_bf16(HWWithStyle(tcfg))
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    assert set(dtypes.values()) == {torch.bfloat16}
    assert "spacer.mean" in dtypes and "spacer.norms.0.weight" in dtypes


def test_session_modes_on_cpu():
    _, sess = _pair("float32", True)
    rng = np.random.default_rng(4)
    a, b, c = rng.normal(size=(3, S)).astype(np.float32)
    assert sess.interpolate("hi", a, b, steps=3).shape == (3, 64, 64, 1)
    bank = rng.normal(size=(5, S)).astype(np.float32)
    assert sess.random_interpolated(["ab", "cd"], bank).shape[0] == 2
    sweep = sess.stretch_sweep("hi", a, factors=(0.9, 1.1))
    assert len(sweep) == 2 and sweep[0].shape == (1, 64, 64, 1)
    assert sess.style_math("hi", a, b, c).shape == (1, 64, 64, 1)
    assert sess.author_samples(["x", "y"], {"w": bank}, "w").shape[0] == 2
    lines = sess.mturk_batch(["ab", "cd"], bank)
    assert len(lines) == 2
    u8 = to_uint8(lines[0][None])
    assert u8.dtype == np.uint8 and u8.shape == (1, 64, 64)


def test_entry_points_need_cuda_or_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GenerationSession(HWWithStyle(tcfg), IAM_CHARSET)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.build(2)


# modules of the recognition, style, autoencoder, record-source and
# evaluation slices that the walk below must reach
HWR_MODULES = ("ops.ctc", "ops.augment", "models.hwr", "training.hwr_trainer",
               "training.train_state", "utils.error_rates",
               "utils._editdistance", "utils.train_log", "ops.align",
               "models.char_style", "models.layers", "inference.styles",
               "data.datasets", "trace_style", "models.autoencoder",
               "training.auto_trainer", "training.loop", "utils.checkpoint",
               "trace_auto", "data.imageops", "data.synthetic", "data.iam",
               "data.rimes", "utils.png", "train", "inference.eval",
               "inference.quality", "inference.load", "ops.masks",
               "analysis.mturk", "get_styles", "generate", "evaluate",
               "eval_writer_id", "play_styles", "parse_mturk",
               "parallel.mesh", "ops.rows", "graft_entry", "umap_styles",
               "graph", "inspect_dataset", "utils.colormap",
               "utils.raster_plot", "scripts.compile_text_corpus",
               "scripts.summarize_quality")


def test_port_imports_no_jax():
    """Importing every module of the port, its bench and chip_smoke.py
    leaves jax, flax, cv2, PIL, matplotlib and the JAX package out of
    sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"import {PKG} as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        f"missing = [m for m in {HWR_MODULES!r}\n"
        f"           if '{PKG}.' + m not in sys.modules]\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'cv2', 'PIL', 'matplotlib',\n"
        "        'handwriting_line_generation_tpu')]\n"
        "print(bad, missing)\n"
        "sys.exit(1 if bad or missing else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_plot_and_dump_clis_import_no_jax(tmp_path):
    """``umap_styles --thumbnails``, ``graph --csv``, ``play_styles
    --heatmap`` and ``inspect_dataset --augment`` run in a fresh process
    (on the CPU, the mini-IAM fixture): jax, flax, cv2, PIL, matplotlib
    and the JAX package stay out of sys.modules."""
    from handwriting_line_generation_tpu_torch.config import load_config
    cfg = load_config(str(REPO / "configs" / "iam_gan_paper.json"))
    cfg.data.data_dir = str(REPO / "tests" / "fixtures" / "mini_iam")
    (tmp_path / "cfg.json").write_text(json.dumps(cfg.to_dict()))
    (tmp_path / "log.json").write_text(json.dumps(
        [{"iteration": i, "loss": 1.0 / i} for i in range(1, 6)]))
    (tmp_path / "thumbs").mkdir()
    code = (
        "import sys\n"
        "import numpy as np\n"
        f"from {PKG} import graph, inspect_dataset, play_styles, "
        "umap_styles\n"
        f"from {PKG}.inference.styles import save_styles\n"
        f"from {PKG}.utils.png import write_png_gray\n"
        f"t = {str(tmp_path)!r}\n"
        "rng = np.random.default_rng(0)\n"
        "save_styles(t + '/bank.npz', {'styles': rng.normal(size=(6, 4)),\n"
        "    'authors': list('aabbcc'), 'ids': list('uvwxyz')})\n"
        "write_png_gray(t + '/thumbs/u.png', np.zeros((8, 16), np.uint8))\n"
        "calls = [\n"
        "    (umap_styles, [t + '/bank.npz', '-o', t + '/m.png',\n"
        "                   '--thumbnails', t + '/thumbs']),\n"
        "    (graph, [t + '/log.json', '-o', t + '/c.png', '--csv',\n"
        "             t + '/c.csv']),\n"
        "    (play_styles, [t + '/bank.npz', '--heatmap', t + '/h.png',\n"
        "                   '--device', 'cpu']),\n"
        "    (inspect_dataset, ['-c', t + '/cfg.json', '-n', '1', '-o',\n"
        "                       t + '/dump', '--augment', '--device', "
        "'cpu'])]\n"
        "rcs = [m.main(a) for m, a in calls]\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'cv2', 'PIL', 'matplotlib',\n"
        "        'handwriting_line_generation_tpu')]\n"
        "print(rcs, bad)\n"
        "sys.exit(1 if bad or any(rcs) else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    for name in ("m.png", "c.png", "c.csv", "h.png", "dump/gt.txt"):
        assert (tmp_path / name).exists(), name


def test_port_sources_name_no_jax():
    """No source of the port names jax, flax or the JAX package, even in
    an import inside a function."""
    for path in (REPO / PKG).rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                mod = words[1].split(".")[0]
                assert mod not in ("jax", "jaxlib", "flax", "cv2", "PIL",
                                   "handwriting_line_generation_tpu"), \
                    f"{path}: {line}"
