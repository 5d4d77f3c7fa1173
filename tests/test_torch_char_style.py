"""Port parity for the style encoder (``models/char_style.py``) and
``ConvBlock``: the flax modules and the port on the same converted params
and numpy inputs, float32."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from handwriting_line_generation_tpu.models import layers as JL
from handwriting_line_generation_tpu.models.char_style import (
    CharStyleEncoder as JCharStyleEncoder, StyleTrunk as JStyleTrunk,
)
from handwriting_line_generation_tpu_torch import convert
from handwriting_line_generation_tpu_torch.models import layers as PL
from handwriting_line_generation_tpu_torch.models.char_style import (
    CharStyleEncoder, StyleTrunk,
)

TOL = dict(rtol=1e-4, atol=1e-4)
NC, DIM, CHAR_DIM, STYLE, K = 12, 8, 16, 10, 4


def perturb(tree, rng):
    """flax's zero biases and unit norm scales, made random so that the
    converter's mapping of each leaf shows."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = perturb(v, rng)
        elif k == "bias":
            out[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k == "scale":
            out[k] = (1 + 0.2 * rng.standard_normal(v.shape)).astype(
                np.float32)
        else:
            out[k] = np.array(v)
    return out


def _flax_params(module, *inputs, seed=0):
    p = module.init(jax.random.PRNGKey(seed), *map(jnp.asarray, inputs))
    return perturb(jax.device_get(p["params"]), np.random.default_rng(seed))


def _nhwc(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("norm", ["group", "batch", "instance", "none"])
@pytest.mark.parametrize("stride,padding,pad_type", [
    ((1, 1), (2, 2, 2, 2), "replicate"), ((2, 2), (1, 1, 1, 1), "replicate"),
    ((2, 1), (0, 0, 1, 1), "zero"), ((1, 1), (1, 2, 2, 1), "reflect")])
def test_conv_block_matches_flax(norm, stride, padding, pad_type):
    x = np.random.default_rng(1).standard_normal((2, 9, 11, 4)).astype(
        np.float32)
    jm = JL.ConvBlock(8, (4, 4), stride, padding, norm, "lrelu", pad_type)
    p = _flax_params(jm, x)
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    m = PL.ConvBlock(4, 8, (4, 4), stride, padding, norm, "lrelu", pad_type)
    sd = {"conv.weight": torch.from_numpy(
        convert._conv(p["Conv_0"]["kernel"])),
        "conv.bias": torch.from_numpy(p["Conv_0"]["bias"])}
    if "GroupNorm_0" in p:
        sd["norm.weight"] = torch.from_numpy(p["GroupNorm_0"]["scale"])
        sd["norm.bias"] = torch.from_numpy(p["GroupNorm_0"]["bias"])
    m.load_state_dict(sd)
    with torch.no_grad():
        got = m(_nhwc(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _load_encoder(model, p):
    sd = convert.convert_params({"style_extractor": p})
    model.load_state_dict({k[len("style_extractor."):]: v
                           for k, v in sd.items()})
    return model


@pytest.mark.parametrize("W", [64, 96])
def test_style_trunk_matches_flax_and_length(W):
    """``T = W/4 - 2``: the two (4, 4) stride-(2, 1) blocks each drop a
    column."""
    x = np.random.default_rng(2).uniform(-1, 1, (2, 64, W, 1)).astype(
        np.float32)
    jm = JStyleTrunk(dim=DIM)
    p = _flax_params(jm, x)
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    assert want.shape == (2, W // 4 - 2, 4 * DIM)
    m = _load_encoder(CharStyleEncoder(NC, STYLE, dim=DIM,
                                       char_dim=CHAR_DIM),
                      {**_flax_params(JCharStyleEncoder(
                          NC, STYLE, dim=DIM, char_dim=CHAR_DIM,
                          capacity=K), x, _recog(2, W // 4)),
                       "StyleTrunk_0": p}).trunk
    assert isinstance(m, StyleTrunk)
    with torch.no_grad():
        got = m(_nhwc(x)).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _recog(B, Tr, seed=3):
    """Log-probs whose argmax is a set class pattern: class 3 on 6 frames
    of sample 0 (more than K = 4, so the top-K truncation runs), blanks
    and a spread of other classes elsewhere."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, Tr, NC)).astype(np.float32)
    cls = rng.integers(0, NC, (B, Tr))
    cls[0, 1:7] = 3
    cls[0, 7:9] = 0
    logits[np.arange(B)[:, None], np.arange(Tr)[None], cls] += 4.0
    return np.array(jax.nn.log_softmax(jnp.asarray(logits), -1))


CASES = {
    "single": dict(),
    "tuple": dict(char_style_dim=5, average_found_char_style=0.5),
    "vae": dict(vae=True),
    "window3": dict(window=3),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("Tr", [16, 12])
def test_char_style_encoder_matches_flax(case, Tr):
    """Single style, tuple (``char_style_dim > 0``), VAE and the
    large-window extractor; ``recog`` longer than the trunk's 14 frames
    (truncated, the main path) and shorter (edge-padded); one recog frame
    masked to -1e30 (floored at -30)."""
    kw = dict(num_class=NC, style_dim=STYLE, dim=DIM, char_dim=CHAR_DIM,
              capacity=K, **CASES[case])
    x = np.random.default_rng(4).uniform(-1, 1, (2, 64, 64, 1)).astype(
        np.float32)
    recog = _recog(2, Tr)
    recog[1, -1, 1:] = -1e30
    recog[1, -1, 0] = 0.0
    jm = JCharStyleEncoder(**kw)
    p = _flax_params(jm, x, recog)
    want = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(recog))
    m = _load_encoder(CharStyleEncoder(**kw), p)
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(recog))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_converted_bank_layout():
    """The vmapped extractor's leaves carry the class axis first: a conv
    kernel ``[N, k, in, out]`` becomes ``[N, out, in, k]`` and each class's
    slice is that class's own conv."""
    kw = dict(num_class=NC, style_dim=STYLE, dim=DIM, char_dim=CHAR_DIM,
              capacity=K)
    x = np.zeros((1, 64, 64, 1), np.float32)
    p = _flax_params(JCharStyleEncoder(**kw), x, _recog(1, 16))
    bank = p["VmapCharExtractor_0"]
    assert bank["Conv_0"]["kernel"].shape == (NC - 1, 3, 4 * DIM, CHAR_DIM)
    m = _load_encoder(CharStyleEncoder(**kw), p)
    w = m.bank.conv0.weight.detach().numpy()
    assert w.shape == (NC - 1, CHAR_DIM, 4 * DIM, 3)
    for n in (0, 5, NC - 2):
        np.testing.assert_array_equal(
            w[n], convert._conv(bank["Conv_0"]["kernel"][n]))
    np.testing.assert_array_equal(m.bank.dense1.weight.detach().numpy(),
                                  bank["Dense_1"]["kernel"])
    np.testing.assert_array_equal(m.bank.norm0.weight.detach().numpy(),
                                  bank["GroupNorm_0"]["scale"])
