"""Port parity: every layer of ``models/layers.py`` against its flax
counterpart, on the same numpy inputs and params (float32)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from handwriting_line_generation_tpu.models import layers as J
from handwriting_line_generation_tpu_torch import convert
from handwriting_line_generation_tpu_torch.models import layers as P

TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def test_group_count():
    for c in range(1, 257):
        assert P.group_count(c) == J.group_count(c), c


def test_group_norm_eps_and_one_pass_variance():
    """flax GroupNorm: eps 1e-6 and E[x^2] - E[x]^2.  Channels with a
    variance near 1e-6 tell eps 1e-6 from torch's default 1e-5 (at zero
    mean, where the one-pass form is well conditioned)."""
    rng = _rng()
    x = (1e-3 * rng.normal(size=(2, 11, 16))).astype(np.float32)
    x[:, :, 8:] = rng.normal(size=(2, 11, 8))
    scale = rng.normal(size=16).astype(np.float32)
    bias = rng.normal(size=16).astype(np.float32)
    gn = J.gn(16)
    want = np.asarray(gn.apply({"params": {"scale": scale, "bias": bias}},
                               x))
    layer = P.GroupNorm(16)
    layer.load_state_dict({"weight": torch.from_numpy(scale),
                           "bias": torch.from_numpy(bias)})
    got = layer(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4)
    torch_default = torch.nn.functional.group_norm(
        torch.from_numpy(x).transpose(1, 2), 4, torch.from_numpy(scale),
        torch.from_numpy(bias)).transpose(1, 2).numpy()
    assert np.abs(torch_default - want).max() > 1e-2


def test_instance_stats_and_norm():
    x = _rng().normal(loc=0.5, size=(2, 5, 7, 3)).astype(np.float32)
    m, r = J._instance_stats(jnp.asarray(x))
    tm, tr = P.instance_stats(_nchw(x))
    np.testing.assert_allclose(_nhwc(tm), np.asarray(m), **TOL)
    np.testing.assert_allclose(_nhwc(tr), np.asarray(r), **TOL)
    np.testing.assert_allclose(_nhwc(P.instance_norm(_nchw(x))),
                               np.asarray(J._instance_norm(jnp.asarray(x))),
                               **TOL)


def test_pixel_norm():
    x = _rng().normal(size=(3, 24)).astype(np.float32)
    want = np.asarray(J.PixelNorm().apply({}, x))
    np.testing.assert_allclose(P.pixel_norm(torch.from_numpy(x)).numpy(),
                               want, **TOL)


def _equal_conv(rng, cin, f):
    layer = P.EqualConv(cin, f)
    k = rng.normal(size=(1, 1, cin, f)).astype(np.float32)
    b = rng.normal(size=f).astype(np.float32)
    layer.load_state_dict({"weight": torch.from_numpy(convert._conv(k)),
                           "bias": torch.from_numpy(b)})
    return layer, {"params": {"kernel": k, "bias": b}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_equal_conv_affine_fold(dtype):
    """The 1x1 fold: x in float32 against a kernel rounded to x's dtype."""
    rng = _rng(1)
    B, H, W, C = 2, 4, 6, 5
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    s = rng.normal(size=(B, C)).astype(np.float32)
    t = rng.normal(size=(B, C)).astype(np.float32)
    layer, p = _equal_conv(rng, C, 1)
    want = np.asarray(J.EqualConv(1, kernel=(1, 1)).apply(
        p, jnp.asarray(x, dtype), in_scale=s, in_shift=t))
    xt = _nchw(x).to(getattr(torch, dtype))
    got = _nhwc(layer(xt, torch.from_numpy(s), torch.from_numpy(t)))
    np.testing.assert_allclose(got, want, **TOL)
    plain = _nhwc(layer(_nchw(x)))
    np.testing.assert_allclose(plain, np.asarray(J.EqualConv(
        1, kernel=(1, 1)).apply(p, x)), **TOL)


@pytest.mark.parametrize("normalize", [True, False])
def test_adain(normalize):
    rng = _rng(2)
    B, H, W, C, S = 2, 4, 6, 8, 12
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    style = rng.normal(size=(B, S)).astype(np.float32)
    k = rng.normal(size=(S, 2 * C)).astype(np.float32)
    b = rng.normal(size=2 * C).astype(np.float32)
    want = J.AdaIN(C).apply({"params": {"Dense_0": {"kernel": k, "bias": b}}},
                            x, style, normalize=normalize)
    layer = P.AdaIN(C, S)
    layer.load_state_dict({"linear.weight": torch.from_numpy(k.T.copy()),
                           "linear.bias": torch.from_numpy(b)})
    got = layer(_nchw(x), torch.from_numpy(style), normalize=normalize)
    if normalize:
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)
    else:
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       **TOL)


def test_adain_bias_init():
    layer = P.AdaIN(4, 3)
    np.testing.assert_array_equal(layer.linear.bias.detach().numpy(),
                                  [1, 1, 1, 1, 0, 0, 0, 0])


def test_noise_injection_sqrt2():
    rng = _rng(3)
    x = rng.normal(size=(2, 3, 5, 4)).astype(np.float32)
    n = rng.normal(size=(2, 3, 5, 1)).astype(np.float32)
    w = rng.normal(size=(1, 1, 1, 4)).astype(np.float32)
    want = J.NoiseInjection().apply({"params": {"weight": w}}, x, None,
                                    noise=n)
    layer = P.NoiseInjection(4)
    layer.load_state_dict({"weight": torch.from_numpy(w.reshape(-1))})
    got = layer(_nchw(x), torch.from_numpy(n[..., 0]))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


def test_blur3x3():
    x = _rng(4).normal(size=(2, 5, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(_nhwc(P.blur3x3(_nchw(x))),
                               np.asarray(J.blur3x3(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("scale", [(2, 1), (2, 2)])
def test_upsample_nearest(scale):
    x = _rng(5).normal(size=(2, 3, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        _nhwc(P.upsample_nearest(_nchw(x), scale)),
        np.asarray(J.upsample_nearest(jnp.asarray(x), scale)))


def test_dense_in_compute_dtype():
    rng = _rng(6)
    x = rng.normal(size=(3, 7)).astype(np.float32)
    k = rng.normal(size=(7, 5)).astype(np.float32)
    b = rng.normal(size=5).astype(np.float32)
    lin = torch.nn.Linear(7, 5)
    lin.load_state_dict({"weight": torch.from_numpy(k.T.copy()),
                         "bias": torch.from_numpy(b)})
    from flax import linen as nn
    want = nn.Dense(5, dtype=jnp.bfloat16).apply(
        {"params": {"kernel": k, "bias": b}}, x)
    got = P.dense(torch.from_numpy(x), lin, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2e-2, atol=5e-2)
