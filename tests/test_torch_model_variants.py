"""Port parity for the model variants off the paper path: ``CRNN`` and
``SmallCRNN`` (their trees, forward, a training step, a GAN lesson with a
CRNN recognizer), ``FusedUpsample(only_vertical=True)`` and ``phase=``,
the phase-decomposed vertical upsample, and the generator's ``small`` and
``phase_upsample`` forms, against the JAX package on the same numpy
weights, inputs and noise (float32 unless named)."""

import functools
import itertools
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import threadpoolctl
import torch
from flax import linen as nn

import handwriting_line_generation_tpu.models.generator as JG
from handwriting_line_generation_tpu.config import load_config as j_load
from handwriting_line_generation_tpu.models import hwr as JH
from handwriting_line_generation_tpu.models.layers import (
    AdaIN as JAdaIN, FusedUpsample as JFusedUpsample,
    NoiseInjection as JNoiseInjection,
)
from handwriting_line_generation_tpu.ops.augment import \
    dequantize_image as j_dequantize
from handwriting_line_generation_tpu.ops.ctc import (
    ctc_loss_fast as j_ctc_fast, mask_frames_to_blank as j_mask,
)
from handwriting_line_generation_tpu_torch import trace_gan
from handwriting_line_generation_tpu_torch.config import (
    HWRConfig, apply_overrides, load_config,
)
from handwriting_line_generation_tpu_torch.convert import (
    convert_hwr_params, convert_params,
)
from handwriting_line_generation_tpu_torch.init import (
    init_hwr_params, init_params, init_spectral,
)
from handwriting_line_generation_tpu_torch.models import hwr as PH
from handwriting_line_generation_tpu_torch.models.generator import \
    SpacedGenerator
from handwriting_line_generation_tpu_torch.models.layers import (
    FusedUpsample, phase_upsample_conv,
)
from handwriting_line_generation_tpu_torch.training.gan_trainer import \
    GanTrainer
from handwriting_line_generation_tpu_torch.training.hwr_trainer import \
    HWRTrainer
from test_torch_char_style import perturb
from test_torch_hwr_trainer import _batch

pytestmark = pytest.mark.compile


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

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=0.0, atol=1e-4)        # float32 forward, max abs
NC, HIDDEN = 11, 32


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _random_params(module, rng, *args, **kw):
    """Random weights in the flax tree of ``module.init(*args)``, its
    shapes from ``eval_shape`` (no compile): kernels N(0, 1/fan_in),
    biases N(0, 0.1^2), norm scales 1 + N(0, 0.2^2), other leaves
    N(0, 0.1^2)."""
    def leaf(path, a):
        name = getattr(path[-1], "key", "")
        x = rng.standard_normal(a.shape)
        if name == "kernel":
            x = x / np.sqrt(max(1, int(np.prod(a.shape[:-1]))))
        elif name == "scale":
            x = 1.0 + 0.2 * x
        else:
            x = 0.1 * x
        return x.astype(np.float32)
    shapes = jax.eval_shape(module.init, *args, **kw)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_hwr(kind, **kw):
    cls = {"crnn": JH.CRNN, "small_crnn": JH.SmallCRNN}[kind]
    return cls(num_class=NC, hidden=HIDDEN, **kw)


def _port_hwr(kind, **kw):
    cls = {"crnn": PH.CRNN, "small_crnn": PH.SmallCRNN}[kind]
    return cls(NC, hidden=HIDDEN, **kw)


def _hwr_pair(kind, H, W, seed=0, **kw):
    """(JAX module, its perturbed params, port module, input image)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, H, W, 1)).astype(np.float32)
    jm = _jax_hwr(kind, **kw)
    params = _random_params(jm, rng, jax.random.PRNGKey(seed), x)
    pm = _port_hwr(kind, **kw)
    pm.load_state_dict(convert_hwr_params(params))
    return jm, params, pm, x


# The recurrence runs T = W/4 steps of a 4 x 32-gate LSTM twice (CRNN)
# over a float32 trunk: the two frameworks' matmuls and sums part at ~1e-6
# a step, and the log-probs at this T (16) stay within 1e-4.
@pytest.mark.parametrize("kind,H,W,kw", [
    ("crnn", 64, 64, {}), ("crnn", 32, 48, dict(small=True, pad="less")),
    ("small_crnn", 24, 64, {}), ("small_crnn", 24, 8, dict(norm="none"))],
    ids=["crnn", "crnn-small-pad", "small_crnn", "small_crnn-narrow-nonorm"])
def test_crnn_forward_matches_jax(kind, H, W, kw):
    jm, params, pm, x = _hwr_pair(kind, H, W, **kw)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_crnn_bfloat16_matches_jax():
    """bf16 trunk, float32 LSTMs and head on both sides: the trunk's bf16
    roundings differ where the two frameworks sum in other orders, so the
    log-probs are held to 5e-2 of their largest magnitude."""
    jm, params, _, x = _hwr_pair("crnn", 64, 64)
    jm = _jax_hwr("crnn", dtype=jnp.bfloat16)
    pm = _port_hwr("crnn", dtype=torch.bfloat16)
    pm.load_state_dict(convert_hwr_params(params))
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0.0,
                               atol=5e-2 * np.abs(want).max())


def test_small_crnn_dropout_is_off_unless_asked():
    """No generator: deterministic, as the JAX HWR trainer runs it (the
    forward test holds that against JAX); with one, dropout is on, and a
    seeded generator repeats the masks."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 24, 32, 1)).astype(
        np.float32))
    pm = _port_hwr("small_crnn")
    with torch.no_grad():
        base, again = pm(x), pm(x)
        a = pm(x, generator=torch.Generator().manual_seed(3))
        b = pm(x, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(base, again, rtol=0, atol=0)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a - base).abs().max() > 1e-3


@pytest.mark.parametrize("kind", ["crnn", "small_crnn"])
def test_init_tree_has_flax_layout(kind):
    """The port's seeded tree: flax's key paths and shapes (``eval_shape``
    of the JAX module at the default width 512), and it converts."""
    tree = init_hwr_params(HWRConfig(kind=kind, norm="group"), NC)
    H = 64 if kind == "crnn" else 24
    jm = JH.build_hwr(kind, NC, "group")
    want = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, H, 32, 1)))
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)
    assert shapes(tree) == shapes(want)
    model = PH.build_hwr(kind, NC, "group")
    model.load_state_dict(convert_hwr_params(tree))


def test_crnn_training_step_matches_jax():
    """``configs/iam_hwr.json`` with ``model.hwr.kind=crnn`` (LSTMs 512
    wide), augmentation off: the first step's loss and log-probs, and its
    gradients within 1e-3 of each tensor's largest entry (the recurrence
    and the trunk sum in other orders)."""
    path = str(REPO / "configs/iam_hwr.json")
    jcfg, tcfg = j_load(path), load_config(path)
    for c in (jcfg, tcfg):
        c.data.augmentation = None
        c.model.hwr.kind = "crnn"
    tree = perturb(init_hwr_params(tcfg.model.hwr, 80, seed=0),
                   np.random.default_rng(1))
    from handwriting_line_generation_tpu.training.hwr_trainer import \
        HWRTrainer as JHWRTrainer
    jt = JHWRTrainer(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    pt = HWRTrainer(tcfg, device="cpu")
    pt.init_state(seed=0, params=tree)
    assert isinstance(pt.model, PH.CRNN)
    batch = _batch()
    jbatch = [jnp.asarray(a) for a in batch]
    want_loss, g_want = jax.jit(jax.value_and_grad(
        lambda p, *b: _jax_loss(jt, p, *b)))(params, *jbatch)
    g_want = convert_hwr_params(_np(g_want))
    loss, _ = pt.train_step(*batch)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    for name, p in pt.model.named_parameters():
        want = g_want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0.0,
                                   atol=1e-3 * np.abs(want).max(),
                                   err_msg=name)


def _jax_loss(jt, params, image, label, label_lengths, width):
    """The JAX train step's loss, augmentation off."""
    logp = jt.model.apply(params, j_dequantize(image, width))
    frames = jnp.clip(jnp.ceil(width / 4.0).astype(jnp.int32), 1,
                      logp.shape[1])
    return j_ctc_fast(j_mask(logp, frames), label, label_lengths)


def test_reference_hwr_string_without_cnnonly_builds_a_crnn():
    cfg = HWRConfig.from_flags("CRNN group", 80)
    assert (cfg.kind, cfg.norm) == ("crnn", "group")
    assert isinstance(PH.build_hwr(cfg.kind, 80, cfg.norm), PH.CRNN)


def test_gan_lessons_with_a_frozen_crnn_recognizer():
    """The paper GAN (narrowed) with ``model.hwr.kind=crnn`` (the forward
    tests hold the recognizer against JAX): a no-step gen lesson and an
    auto lesson run, genRecog and reconRecog through the CRNN (CTC at the
    generated lines' frames and at T = W/4), the frozen recognizer
    unchanged."""
    cfg = load_config(str(REPO / "configs/iam_gan_paper.json"))
    apply_overrides(cfg, [
        "model.hwr.kind=crnn", "model.generator.dim=32",
        "model.style.style_dim=16", "model.style.dim=8",
        "model.style.char_dim=8", "model.style.char_capacity=4",
        "model.discriminator.dim=8", "model.spacer.dim=32",
        "model.pretrained_hwr=", "data.text_data=",
        "trainer.encoder_weights=", "model.max_gen_length=24",
        "trainer.text_data_max_len=4"])
    cfg.model.num_class = 80
    params = init_params(cfg.model, seed=0)
    params["hwr"] = perturb(params["hwr"], np.random.default_rng(2))
    tr = GanTrainer(cfg, device="cpu")
    tr.init_state(seed=0, params=params, spectral=init_spectral(cfg.model))
    assert isinstance(tr.model.hwr, PH.CRNN)
    hwr0 = {k: v.clone() for k, v in tr.model.hwr.state_dict().items()}
    b = trace_gan.batch("cpu")
    n = torch.clamp(b["label_lengths"], max=8)
    b = dict(b, image=b["image"][..., :64], label=b["label"][:, :8],
             label_lengths=n, width=torch.clamp(b["width"], max=64))
    gen = tr.run_lesson(["no-step", "gen"], itertools.repeat(b))
    auto = tr.run_lesson(["auto", "auto-gen"], itertools.repeat(b))
    assert np.isfinite(float(gen["genRecogLoss"]))
    assert np.isfinite(float(auto["autoLoss"]))
    for k, v in tr.model.hwr.state_dict().items():
        torch.testing.assert_close(v, hwr0[k], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# FusedUpsample variants and the phase-decomposed vertical upsample
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("only_vertical,phase", [
    (True, False), (True, True), (False, True)])
def test_fused_upsample_variants_match_jax(only_vertical, phase):
    """Vertical-only (stride (2, 1), flax W padding (1, 2): H doubles, W
    kept), and JAX's phase form against the port's one transposed conv,
    on a non-zero bias."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 7, 6)).astype(np.float32)
    jm = JFusedUpsample(4, only_vertical=only_vertical, phase=phase)
    params = _random_params(jm, rng, jax.random.PRNGKey(0), x)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    pm = FusedUpsample(6, 4, only_vertical=only_vertical)
    k = params["params"]["kernel"]
    with torch.no_grad():
        pm.weight.copy_(torch.from_numpy(
            k.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1].copy()))
        pm.bias.copy_(torch.from_numpy(params["params"]["bias"]))
        got = pm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert want.shape == (2, 10, 7 if only_vertical else 14, 4)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               **TOL)


def test_phase_upsample_conv_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 7, 6)).astype(np.float32)
    jm = JG._PhaseUpConv(4)
    params = _random_params(jm, rng, jax.random.PRNGKey(0), x)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    conv = torch.nn.Conv2d(6, 4, 3)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(
            params["params"]["kernel"].transpose(3, 2, 0, 1).copy()))
        conv.bias.copy_(torch.from_numpy(params["params"]["bias"]))
        got = phase_upsample_conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                                  conv, torch.float32)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               **TOL)


# ---------------------------------------------------------------------------
# The generator's small and phase_upsample forms
# ---------------------------------------------------------------------------

class StyledConvBlock(JG.StyledConvBlock):
    """The JAX block with its non-upsampling branch's two convs named
    ``Conv_0`` and ``Conv_1``: as written it names both ``Conv_0`` and flax
    refuses it (``NameInUseError``), so the JAX package cannot build
    ``GeneratorConfig.small``.  The other branches are the JAX package's
    own (the class keeps its name, so flax's auto-names are unchanged)."""

    @nn.compact
    def __call__(self, x, style, noise=None):
        if self.initial or self.upsample:
            return super().__call__(x, style, noise)
        f, dt = self.features, self.dtype
        x = nn.Conv(f, (3, 3), padding="SAME", dtype=dt, name="Conv_0")(x)
        if self.fused_epilogue:
            x = self._epilogue(x, style, noise[0], False, "AdaIN_0",
                               "NoiseInjection_0")
        else:
            x = JNoiseInjection(name="NoiseInjection_0")(x, None,
                                                         noise=noise[0])
            x = JAdaIN(f, dtype=dt, name="AdaIN_0")(nn.leaky_relu(x, 0.2),
                                                    style)
        x = nn.Conv(f, (3, 3), padding="SAME", dtype=dt, name="Conv_1")(x)
        x = JNoiseInjection(name="NoiseInjection_1")(x, None, noise=noise[1])
        return JAdaIN(f, dtype=dt, name="AdaIN_1")(
            nn.leaky_relu(x, 0.2), style,
            normalize=not self.defer_final_adain)


def test_jax_package_cannot_build_the_small_generator():
    m = JG.SpacedGenerator(num_class=5, style_dim=4, dim=32, small=True)
    oh = jnp.zeros((1, 3, 5))
    with pytest.raises(Exception, match="Conv_0"):
        jax.eval_shape(m.init, {"params": jax.random.PRNGKey(0),
                                "noise": jax.random.PRNGKey(1)},
                       oh, jnp.zeros((1, 4)))


@functools.lru_cache(maxsize=None)
def _jax_generator(small, phase):
    """(params, one-hot, style, noise, the JAX image): the JAX package's
    generator, sequential float32 (its fused path agrees with it to 1e-5,
    ``tests/test_models.py``), on random biases."""
    B, T, S, C = 2, 6, 8, 10
    rng = np.random.default_rng(int(small) * 2 + int(phase))
    oh = np.eye(C, dtype=np.float32)[rng.integers(0, C, (B, T))]
    style = rng.standard_normal((B, S)).astype(np.float32)
    hw = [(4, T), (8, T), (16, T), (32, 2 * T),
          (32, 2 * T) if small else (64, 4 * T)]
    noise = [rng.standard_normal((B, h, w, 1)).astype(np.float32)
             for h, w in hw for _ in range(2)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JG, "StyledConvBlock", StyledConvBlock)
        jm = JG.SpacedGenerator(num_class=C, style_dim=S, dim=32,
                                small=small, phase_upsample=phase)
        params = _random_params(
            jm, rng, {"params": jax.random.PRNGKey(0),
                      "noise": jax.random.PRNGKey(1)}, oh, style, noise=noise)
        want = np.asarray(jax.jit(jm.apply)(params, oh, style, noise=noise))
    return params, oh, style, noise, want


@pytest.mark.parametrize("small,phase,fused", [
    (True, False, False), (True, False, True), (False, True, False),
    (False, True, True)])
def test_generator_variants_match_jax(small, phase, fused):
    """``small`` (32 rows, 2T columns; the last block a plain 3x3 conv
    with no blur, its epilogue call unblurred) and ``phase_upsample``,
    through the sequential path and the block epilogue's plain version,
    on random biases and the same noise planes."""
    params, oh, style, noise, want = _jax_generator(small, phase)
    B, T, C = oh.shape
    pm = SpacedGenerator(C, style.shape[1], dim=32, small=small,
                         phase_upsample=phase, fused_epilogue=fused)
    sd = convert_params({"generator": params["params"]})
    pm.load_state_dict({k[len("generator."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = pm(torch.from_numpy(oh), torch.from_numpy(style),
                 noise=[torch.from_numpy(n) for n in noise]).numpy()
    assert got.shape == ((B, 32, 2 * T, 1) if small else (B, 64, 4 * T, 1))
    np.testing.assert_allclose(got, want, **TOL)
