"""The JAX package's ``.msgpack`` checkpoints in the port: the pure-Python
decoder against ``flax.serialization.msgpack_restore`` on every layout the
JAX package writes (a GAN ``checkpoint-*``, ``model_best``, ``-swa``, an
HWR state, an autoencoder state, a chunked leaf, every msgpack type flax
emits), bit for bit; the routing of each layout to the port's state; the
GAN's ``pretrained_hwr`` and ``encoder_weights``; the inference CLIs on a
JAX run directory; and the committed fixture ``tests/fixtures/jax_ckpt``
rendered as the JAX package rendered it."""

import json
import pathlib
import subprocess
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import threadpoolctl
import torch
from flax import serialization

from handwriting_line_generation_tpu.config import load_config as j_load
from handwriting_line_generation_tpu.training.auto_trainer import AutoState
from handwriting_line_generation_tpu.training.hwr_trainer import HWRState
from handwriting_line_generation_tpu.training.train_state import \
    create_gan_state
from handwriting_line_generation_tpu.utils.checkpoint import (
    CheckpointManager as JCheckpointManager, save_checkpoint as j_save,
)
from handwriting_line_generation_tpu_torch import (
    evaluate, generate, get_styles,
)
from handwriting_line_generation_tpu_torch.config import (
    HWRConfig, apply_overrides, load_config,
)
from handwriting_line_generation_tpu_torch.convert import (
    convert_autoencoder_params, convert_checkpoint, convert_hwr_params,
    convert_params,
)
from handwriting_line_generation_tpu_torch.inference.load import load_model
from handwriting_line_generation_tpu_torch.init import (
    init_autoencoder, init_autoencoder_params, init_hwr_params, init_params,
    init_spectral,
)
from handwriting_line_generation_tpu_torch.models.hwr import build_hwr
from handwriting_line_generation_tpu_torch.training.gan_trainer import \
    GanTrainer
from handwriting_line_generation_tpu_torch.utils import msgpack
from handwriting_line_generation_tpu_torch.utils.checkpoint import (
    load_raw_checkpoint, save_checkpoint,
)
from test_torch_infer_cli import _tiny_config

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "jax_ckpt"
STEP = 7


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's side on one torch thread and one BLAS thread: the
    recurrences and small GEMMs here slow down a hundredfold when several
    test processes oversubscribe the cores with thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


def _fixture_config(jax_side=False):
    fx = json.loads((FIXTURE / "fixture.json").read_text())
    load = j_load if jax_side else load_config
    cfg = load(str(REPO / fx["config"]))
    if jax_side:
        from handwriting_line_generation_tpu.config import apply_overrides \
            as j_apply
        j_apply(cfg, fx["overrides"])
    else:
        apply_overrides(cfg, fx["overrides"])
    cfg.model.num_class = 80
    return cfg


def _flax_read(path):
    return serialization.msgpack_restore(pathlib.Path(path).read_bytes())


def _assert_same_tree(got, want, where="/"):
    """Same structure, types and values; arrays bit for bit (bfloat16 as
    its bits)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), where
        for k in want:
            _assert_same_tree(got[k], want[k], f"{where}{k}/")
    elif isinstance(want, np.ndarray) and want.dtype.name == "bfloat16":
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
        assert tuple(got.shape) == want.shape, where
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16), err_msg=where)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, where
        assert got.shape == want.shape, where
        assert got.tobytes() == want.tobytes(), where
    else:
        assert type(got) is type(want) and got == want, where


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """Each layout the JAX package writes, by its own ``save_checkpoint``
    and ``CheckpointManager``: the GAN's (the fixture's narrow model, a
    real ``GanTrainState``), an HWR state (SGD: no moments, to keep the
    512-wide recognizer's file small), an autoencoder state (Adam
    moments); and, by ``flax.serialization.to_bytes``, a tree with one
    chunked leaf and every other leaf type flax writes."""
    root = tmp_path_factory.mktemp("jax_layouts")
    params = _flax_read(FIXTURE / "model_best.msgpack")
    jcfg = _fixture_config(jax_side=True)
    state = create_gan_state(jcfg, params, jax.random.PRNGKey(3))[0]
    state = state.replace(step=jnp.asarray(STEP, jnp.int32))
    swa = jax.tree_util.tree_map(lambda a: a + 1.0, params["params"])
    gan = root / "gan"
    mgr = JCheckpointManager(str(gan), save_step=STEP, save_step_minor=STEP)
    mgr.maybe_save(STEP, state, {"name": "fixture"}, monitor_value=0.5,
                   extra_trees={"swa": swa}, best_tree=params)

    hwr = init_hwr_params(HWRConfig(kind="cnn_only", norm="group"), 80)
    j_save(str(root), "hwr", HWRState(
        step=jnp.asarray(5, jnp.int32), params=hwr,
        opt_state=optax.sgd(1e-3).init(hwr), rng=jax.random.PRNGKey(0)),
        meta={"iteration": 5})
    ae = init_autoencoder_params("2tight", 80)
    j_save(str(root), "auto", AutoState(
        step=jnp.asarray(5, jnp.int32), params=ae,
        opt_state=optax.adam(1e-3).init(ae), rng=jax.random.PRNGKey(1)))

    big = np.arange(3000, dtype=np.float32).reshape(10, 300)
    misc = {"big": big, "bf16": jnp.arange(6, dtype=jnp.bfloat16) / 3,
            "i8": np.int8(-3), "u64": np.uint64(2 ** 63 + 5),
            "f16": np.float16(1.5), "b": np.bool_(True),
            "scalars": [0, -1, 127, 128, -33, 2 ** 16, -2 ** 31, 2 ** 40,
                        1.25, True, False, None, "t" * 40, b"raw" * 100,
                        1 + 2j],
            "empty": {}, "text": "a" * 70000, "nested": ((1, 2), [3])}
    chunk = serialization.MAX_CHUNK_SIZE
    serialization.MAX_CHUNK_SIZE = 4096       # 'big' goes in 3 chunks
    try:
        # flax's own writer on a Python tree (the JAX save_checkpoint
        # makes every leaf an array, strings too, which flax cannot read)
        (root / "misc.msgpack").write_bytes(serialization.to_bytes(misc))
    finally:
        serialization.MAX_CHUNK_SIZE = chunk
    return dict(root=root, gan=gan, params=params, swa=swa, hwr=hwr, ae=ae,
                big=big)


LAYOUT_FILES = ["gan/checkpoint-iteration7", "gan/checkpoint-latest",
                "gan/checkpoint-latest-swa", "gan/model_best",
                "gan/model_best-swa", "hwr", "auto", "misc"]


@pytest.mark.parametrize("name", LAYOUT_FILES)
def test_decoder_equals_flax(layouts, name):
    path = layouts["root"] / (name + ".msgpack")
    got = msgpack.read(str(path))
    _assert_same_tree(got, _flax_read(path))


def test_decoder_reads_chunks_and_views_the_file(layouts):
    raw = load_raw_checkpoint(str(layouts["root"]), "misc")
    np.testing.assert_array_equal(raw["big"], layouts["big"])
    assert raw["scalars"]["14"] == 1 + 2j
    buf = (layouts["root"] / "hwr.msgpack").read_bytes()
    tree = msgpack.restore(buf)
    leaf = tree["params"]["params"]["_ConvTrunk_0"]["Conv_6"]["kernel"]
    # a view on the file's bytes, not a copy
    assert not leaf.flags.owndata and leaf.base is not None
    assert np.shares_memory(leaf, np.frombuffer(buf, np.uint8))


def test_decoder_refuses_garbage():
    with pytest.raises(ValueError, match="unknown type byte"):
        msgpack.unpackb(b"\xc1")
    with pytest.raises(ValueError, match="after the object"):
        msgpack.unpackb(b"\x01\x02")


def _model_params(model):
    return {k: v.detach() for k, v in model.named_parameters()}


@pytest.mark.parametrize("name", ["checkpoint-iteration7",
                                  "checkpoint-latest", "model_best",
                                  "checkpoint-latest-swa",
                                  "model_best-swa"])
def test_load_model_reads_each_gan_layout(layouts, name):
    """Parameters equal to the flax tree's (the ``-swa`` ones over the
    base checkpoint's ``u``'s), the step from the state or the sidecar;
    no Adam moment is read."""
    model, step = load_model(_fixture_config(), str(layouts["gan"]), name,
                             device="cpu")
    assert step == STEP
    tree = layouts["swa"] if name.endswith("-swa") else \
        layouts["params"]["params"]
    want = convert_params(tree)
    got = _model_params(model)
    assert set(got) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    u = convert_params(layouts["params"]["params"],
                       layouts["params"]["spectral"])
    for k, v in model.named_buffers():
        torch.testing.assert_close(v, u[k], rtol=0, atol=0)


def test_convert_checkpoint_routes_by_layout(layouts):
    full = load_raw_checkpoint(str(layouts["gan"]), "checkpoint-latest")
    assert {"opt_main", "saved_recog", "style_bank"} <= set(full)
    best = load_raw_checkpoint(str(layouts["gan"]), "model_best")
    a, b = convert_checkpoint(full), convert_checkpoint(best)
    assert set(a) == set(b) and any(k.endswith(".u") for k in a)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_load_model_refuses_both_files(layouts, tmp_path):
    d = tmp_path / "both"
    d.mkdir()
    src = layouts["gan"] / "model_best.msgpack"
    (d / "model_best.msgpack").write_bytes(src.read_bytes())
    model, _ = load_model(_fixture_config(), str(d), "model_best",
                          device="cpu")
    save_checkpoint(str(d), "model_best", {"model": model.state_dict()})
    with pytest.raises(ValueError, match="model_best.pt.*model_best.msgpack"):
        load_model(_fixture_config(), str(d), "model_best", device="cpu")
    with pytest.raises(FileNotFoundError, match="model_best"):
        load_model(_fixture_config(), str(d), "checkpoint-latest",
                   device="cpu")


def test_pretrained_hwr_and_encoder_from_jax_states(layouts, tmp_path):
    """``load_pretrained_hwr`` from a standalone HWR state (extension
    optional) and from a composite checkpoint's ``hwr`` subtree;
    ``load_encoder_weights`` from an autoencoder state; a recognizer of
    another kind is refused by its submodules."""
    root = layouts["root"]
    model = types.SimpleNamespace(hwr=build_hwr("cnn_only", 80, "group"))
    want = convert_hwr_params(layouts["hwr"])
    for path in (root / "hwr", root / "hwr.msgpack"):
        GanTrainer.load_pretrained_hwr(model, str(path))
        for k, v in model.hwr.state_dict().items():
            torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    j_save(str(tmp_path), "composite",
           {"params": {"hwr": layouts["hwr"]["params"], "generator": {}}})
    model.hwr = build_hwr("cnn_only", 80, "group")
    GanTrainer.load_pretrained_hwr(model, str(tmp_path / "composite"))
    torch.testing.assert_close(model.hwr.out.weight, want["out.weight"],
                               rtol=0, atol=0)
    model.hwr = build_hwr("small_crnn", 80, "group")
    with pytest.raises(ValueError, match="submodule mismatch"):
        GanTrainer.load_pretrained_hwr(model, str(root / "hwr"))

    holder = types.SimpleNamespace(
        encoder=init_autoencoder("2tight", 0, seed=5).encoder)
    GanTrainer.load_encoder_weights(holder, str(root / "auto"))
    enc = {k[len("encoder."):]: v for k, v in convert_autoencoder_params(
        layouts["ae"]).items() if k.startswith("encoder.")}
    for k, v in holder.encoder.state_dict().items():
        torch.testing.assert_close(v, enc[k], rtol=0, atol=0)


def test_reader_imports_neither_msgpack_nor_jax():
    """A fresh process loads the fixture through ``load_model``: the
    ``msgpack`` package, JAX and flax stay out of ``sys.modules``."""
    code = (
        "import json, sys\n"
        "from handwriting_line_generation_tpu_torch.config import (\n"
        "    apply_overrides, load_config)\n"
        "from handwriting_line_generation_tpu_torch.inference.load import \\\n"
        "    load_model\n"
        f"fx = json.load(open({str(FIXTURE / 'fixture.json')!r}))\n"
        "cfg = apply_overrides(load_config(fx['config']), fx['overrides'])\n"
        f"load_model(cfg, {str(FIXTURE)!r}, 'model_best', device='cpu')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('msgpack', 'jax', 'jaxlib', 'flax')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("fused", [False, True])
def test_committed_fixture_renders_as_jax(fused):
    """``tests/fixtures/jax_ckpt`` (written by ``make_fixture.py`` through
    the JAX package): its ``model_best`` through ``load_model`` renders the
    stored spaced text, styles and noise within 1e-4 of the JAX image,
    through the sequential path and the epilogue's plain version."""
    cfg = _fixture_config()
    cfg.model.generator.fused_epilogue = fused
    model, step = load_model(cfg, str(FIXTURE), "model_best", device="cpu")
    assert step == STEP
    z = np.load(FIXTURE / "render.npz")
    noise = [torch.from_numpy(z[f"noise{i}"]) for i in range(10)]
    with torch.no_grad():
        img = model.generate_spaced(torch.from_numpy(z["spaced"]).long(),
                                    torch.from_numpy(z["style"]),
                                    noise=noise)
    np.testing.assert_allclose(img.numpy(), z["image"], rtol=0, atol=1e-4)


def test_fixture_is_small():
    assert sum(p.stat().st_size for p in FIXTURE.iterdir()) <= 2 * 2 ** 20


def test_inference_clis_on_a_jax_run_directory(tmp_path, capsys):
    """A JAX run directory (``checkpoint-latest``: a ``GanTrainState``,
    ``model_best``: its params, both by the JAX ``CheckpointManager``) of
    a narrow model with a recognizer and a style extractor: the port's
    ``get_styles``, ``generate`` and ``evaluate --ckpt-name model_best``
    run on it unchanged."""
    cfg = _tiny_config()
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg.to_dict()))
    params = {"params": init_params(cfg.model, seed=0),
              "spectral": init_spectral(cfg.model, seed=0)}
    state = create_gan_state(j_load(str(cfg_path)), params,
                             jax.random.PRNGKey(0))[0].replace(
        step=jnp.asarray(STEP, jnp.int32))
    run = tmp_path / "run"
    JCheckpointManager(str(run), save_step=0, save_step_minor=STEP).maybe_save(
        STEP, state, {"name": "tiny"}, monitor_value=1.0, best_tree=params)
    assert sorted(p.name for p in run.iterdir()) == [
        "checkpoint-latest.json", "checkpoint-latest.msgpack",
        "model_best.json", "model_best.msgpack"]
    common = ["-c", str(cfg_path), "-k", str(run), "--device", "cpu"]
    assert get_styles.main(common + ["-o", str(tmp_path)]) == 0
    bank = tmp_path / f"train_styles_{STEP}.npz"
    assert bank.exists()
    out = tmp_path / "gen"
    assert generate.main(common + ["-s", str(bank), "-m", "render", "-n",
                                   "2", "-o", str(out)]) == 0
    assert len(list(out.glob("*.png"))) == 2
    capsys.readouterr()
    assert evaluate.main(common + ["--ckpt-name", "model_best"]) == 0
    text = capsys.readouterr().out
    got = json.loads(text[text.index("{"):])
    assert np.isfinite(got["CER"])
