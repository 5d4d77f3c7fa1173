"""Port parity: flax param layouts -> torch layouts (``convert.py``), and
the seeded init's tree against flax's own."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from handwriting_line_generation_tpu.config import (
    DiscriminatorConfig as JDiscriminatorConfig,
    GeneratorConfig as JGeneratorConfig, HWRConfig as JHWRConfig,
    ModelConfig as JModelConfig, SpacerConfig as JSpacerConfig,
    StyleConfig as JStyleConfig,
)
from handwriting_line_generation_tpu.models.hw_with_style import \
    HWWithStyle as JHWWithStyle
from handwriting_line_generation_tpu.models.layers import \
    FusedUpsample as JFusedUpsample
from handwriting_line_generation_tpu_torch import convert
from handwriting_line_generation_tpu_torch.config import (
    DiscriminatorConfig, GeneratorConfig, HWRConfig, ModelConfig,
    SpacerConfig, StyleConfig,
)
from handwriting_line_generation_tpu_torch.init import init_params
from handwriting_line_generation_tpu_torch.models.hw_with_style import \
    HWWithStyle
from handwriting_line_generation_tpu_torch.models.layers import \
    FusedUpsample

RNG = np.random.default_rng(0)


def _init(module, x):
    return module.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]


def _t(a):
    return torch.from_numpy(np.array(a))


def test_dense_layout():
    x = RNG.normal(size=(3, 7)).astype(np.float32)
    m = nn.Dense(5)
    p = _init(m, x)
    want = np.asarray(m.apply({"params": p}, x))
    got = F.linear(_t(x), _t(convert._dense(np.asarray(p["kernel"]))),
                   _t(p["bias"]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_conv1d_layout():
    x = RNG.normal(size=(2, 9, 6)).astype(np.float32)          # [B, L, C]
    m = nn.Conv(4, (3,), padding="SAME")
    p = _init(m, x)
    want = np.asarray(m.apply({"params": p}, x))
    got = F.conv1d(_t(x).transpose(1, 2),
                   _t(convert._conv(np.asarray(p["kernel"]))),
                   _t(p["bias"]), padding=1).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_conv2d_layout():
    x = RNG.normal(size=(2, 5, 7, 6)).astype(np.float32)       # NHWC
    m = nn.Conv(4, (3, 3), padding="SAME")
    p = _init(m, x)
    want = np.asarray(m.apply({"params": p}, x))
    got = F.conv2d(_t(x).permute(0, 3, 1, 2),
                   _t(convert._conv(np.asarray(p["kernel"]))),
                   _t(p["bias"]), padding=1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_initial_conv_transpose_is_unflipped_correlation():
    """flax's stride-1 ConvTranspose((4, 3), padding ((3, 3), (1, 1))) does
    not flip its kernel: conv2d of the padded input with the OIHW kernel
    matches it, the flipped kernel does not — equivalently, torch's
    conv_transpose2d matches only with the flipped kernel."""
    x = RNG.normal(size=(2, 1, 8, 6)).astype(np.float32)       # [B,1,T,C]
    m = nn.ConvTranspose(5, (4, 3), padding=((3, 3), (1, 1)))
    p = _init(m, x)
    want = np.asarray(m.apply({"params": p}, x))
    assert want.shape == (2, 4, 8, 5)
    k = convert._conv(np.asarray(p["kernel"]))                 # OIHW
    xt = F.pad(_t(x).permute(0, 3, 1, 2), (1, 1, 3, 3))
    got = F.conv2d(xt, _t(k), _t(p["bias"])).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    flipped = F.conv2d(xt, _t(k[:, :, ::-1, ::-1]), _t(p["bias"]))
    assert not np.allclose(flipped.permute(0, 2, 3, 1).numpy(), want,
                           atol=1e-3)
    kt = k.transpose(1, 0, 2, 3)[:, :, ::-1, ::-1]             # [in,out,..]
    ct = F.conv_transpose2d(_t(x).permute(0, 3, 1, 2), _t(kt),
                            _t(p["bias"]), padding=(0, 1))
    np.testing.assert_allclose(ct.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_fused_upsample_flip():
    """lax.conv_transpose(stride 2, padding 2) vs torch conv_transpose2d
    with the spatially flipped [in, out, 3, 3] weight."""
    x = RNG.normal(size=(2, 4, 6, 8)).astype(np.float32)
    m = JFusedUpsample(5)
    p = _init(m, x)
    want = np.asarray(m.apply({"params": p}, x))
    assert want.shape == (2, 8, 12, 5)
    layer = FusedUpsample(8, 5)
    layer.load_state_dict({
        "weight": _t(convert._flipped_transpose(np.asarray(p["kernel"]))),
        "bias": _t(p["bias"])})
    with torch.no_grad():
        got = layer(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _cfgs(csd=0, hwr="cnn_only", vae=False, window=2):
    kw = dict(num_class=20, compute_dtype="float32")
    style = dict(style_dim=24, char_style_dim=csd, dim=8, char_dim=16,
                 char_capacity=4, vae=vae, window=window)
    j = JModelConfig(style=JStyleConfig(**style),
                     generator=JGeneratorConfig(dim=32),
                     discriminator=JDiscriminatorConfig(enabled=False),
                     spacer=JSpacerConfig(dim=32),
                     hwr=JHWRConfig(kind=hwr), **kw)
    t = ModelConfig(style=StyleConfig(**style),
                    generator=GeneratorConfig(dim=32),
                    discriminator=DiscriminatorConfig(enabled=False),
                    spacer=SpacerConfig(dim=32), hwr=HWRConfig(kind=hwr),
                    **kw)
    return j, t


@pytest.mark.parametrize("csd,vae,window", [(0, False, 2), (3, False, 2),
                                            (0, True, 3)])
def test_init_tree_matches_flax_and_loads(csd, vae, window):
    """The port's numpy init has flax's exact tree and shapes — generator,
    spacer, recognizer and style extractor, as ``init_all`` builds them —
    and converts into a strict load of the torch model."""
    jcfg, tcfg = _cfgs(csd, vae=vae, window=window)
    model = JHWWithStyle(jcfg)
    B, L = 2, 5
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(
        lambda: model.init({"params": k, "noise": k},
                           jnp.zeros((B, 64, 96, 1)),
                           jnp.ones((B, L), jnp.int32), jnp.full((B,), L),
                           1, 16, method="init_all"))["params"]
    want = jax.tree_util.tree_map(lambda a: a.shape, shapes)
    params = init_params(tcfg, seed=0)
    assert set(params) == {"generator", "spacer", "hwr", "style_extractor"}
    assert jax.tree_util.tree_map(lambda a: a.shape, params) == want
    HWWithStyle(tcfg).load_state_dict(convert.convert_params(params))


def test_convert_skips_unported_and_rejects_unknown():
    """Only the discriminator's subtree is skipped: the recognizer's and
    the extractor's are converted, and an unknown key in any of them
    raises."""
    _, tcfg = _cfgs()
    params = init_params(tcfg, seed=0)
    sd = convert.convert_params({**params, "discriminator": {}})
    assert set(sd) == set(HWWithStyle(tcfg).state_dict())
    assert any(k.startswith("hwr.") for k in sd)
    assert any(k.startswith("style_extractor.bank.") for k in sd)
    with pytest.raises(KeyError):
        convert.convert_params({**params, "mystery": {}})
    with pytest.raises(KeyError):
        convert.convert_params({**params, "hwr": {"x": np.zeros(1)}})
    for sub in ("spacer", "style_extractor"):
        bad = {**params, sub: {**params[sub], "extra": np.zeros(1)}}
        with pytest.raises(KeyError):
            convert.convert_params(bad)
    bank = params["style_extractor"]["VmapCharExtractor_0"]
    bad = {**params, "style_extractor": {
        **params["style_extractor"],
        "VmapCharExtractor_0": {**bank, "Dense_2": bank["Dense_1"]}}}
    with pytest.raises(KeyError):
        convert.convert_params(bad)


def test_generation_only_model_has_no_recognizer():
    """``hwr.kind`` "none" builds no recognizer and no ``hwr`` subtree."""
    _, tcfg = _cfgs(hwr="none")
    params = init_params(tcfg, seed=0)
    assert "hwr" not in params
    model = HWWithStyle(tcfg)
    assert model.hwr is None
    model.load_state_dict(convert.convert_params(params))


def test_bf16_leaves_convert_exactly():
    a = jnp.asarray(RNG.normal(size=(3, 4)), jnp.bfloat16)
    t = convert._tensor(np.asarray(a))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(a.astype(jnp.float32)))
