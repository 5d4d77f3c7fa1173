"""Port parity for the HWR step's augmentation: each function of
``ops/augment.py`` against the JAX package's, with the JAX draws recomputed
from its keys and injected into the port."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from handwriting_line_generation_tpu.data.datasets import \
    quantize_image_u8 as j_quantize
from handwriting_line_generation_tpu.ops import augment as J
from handwriting_line_generation_tpu_torch.ops import augment as P
from test_torch_threads import one_thread  # noqa: F401 (autouse)

B, H, W = 2, 64, 96
# Sampling coordinates computed in another order can land one ulp either
# side of an integer, which moves floor() by one; bilinear weights are
# continuous there, so the output moves by a few ulps of the pixel values.
SAMPLE_TOL = dict(rtol=0.0, atol=1e-4)


def _image(seed=0):
    """A line-like normalized image: background near -1, ink strokes."""
    rng = np.random.default_rng(seed)
    u8 = np.full((B, H, W, 1), 250, np.uint8)
    for b in range(B):
        for _ in range(12):
            y, x = rng.integers(8, H - 8), rng.integers(4, W - 10)
            u8[b, y - 4:y + 4, x:x + 6, 0] = rng.integers(0, 90)
    u8 = (u8.astype(np.int32) + rng.integers(-5, 6, u8.shape)).clip(0, 255)
    return (1.0 - u8.astype(np.float32) / 128.0)


def test_dequantize_and_quantize_match_jax():
    img = _image()
    u8 = j_quantize(img)
    np.testing.assert_array_equal(P.quantize_image_u8(img), u8)
    width = np.array([70, 96], np.int32)
    want = np.asarray(J.dequantize_image(jnp.asarray(u8), jnp.asarray(width)))
    got = P.dequantize_image(torch.from_numpy(u8), torch.from_numpy(width))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[0, :, 70:] == -1.0).all()
    f = torch.from_numpy(img)
    assert P.dequantize_image(f, torch.from_numpy(width)) is f


def test_otsu_threshold_matches_jax():
    u8 = np.array(J._to_u8_scale(jnp.asarray(_image(1))))
    want = np.asarray(jax.vmap(J.otsu_threshold)(jnp.asarray(u8)))
    got = P.otsu_threshold(torch.from_numpy(u8)).numpy()
    np.testing.assert_array_equal(got, want)


def test_tensmeyer_brightness_matches_jax():
    img = _image(2)
    key = jax.random.PRNGKey(3)
    want = np.asarray(J.tensmeyer_brightness(jnp.asarray(img), key))
    shifts = []
    for k in jax.random.split(key, B):        # JAX's per-sample draws
        k1, k2 = jax.random.split(k)
        shifts.append([float(jax.random.normal(k1)),
                       float(jax.random.normal(k2))])
    got = P.tensmeyer_brightness(torch.from_numpy(img),
                                 shifts=torch.tensor(shifts))
    np.testing.assert_allclose(got.numpy(), want, rtol=0.0, atol=1e-5)


def test_resize_bilinear_matches_jax_image_resize():
    """``jax.image.resize(..., "bilinear")`` upsampling equals torch's
    half-pixel bilinear with clamped edges, the edges included."""
    x = np.random.default_rng(4).standard_normal((B, 7, 10, 2)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (B, H, W, 2),
                                       method="bilinear"))
    got = P.resize_bilinear(torch.from_numpy(x), (H, W)).numpy()
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-5)
    np.testing.assert_allclose(got[:, 0, 0], x[:, 0, 0], atol=1e-6)
    np.testing.assert_allclose(got[:, -1, -1], x[:, -1, -1], atol=1e-6)


def test_grid_warp_matches_jax():
    img = _image(5)
    key = jax.random.PRNGKey(6)
    want = np.asarray(J.grid_warp(jnp.asarray(img), key))
    offsets = np.array(jax.random.normal(key, (B, H // 12 + 2,
                                                 W // 12 + 2, 2)))
    got = P.grid_warp(torch.from_numpy(img),
                      offsets=torch.from_numpy(offsets))
    np.testing.assert_allclose(got.numpy(), want, **SAMPLE_TOL)


@pytest.mark.parametrize("skew,stretch", [((0.3, -0.5), (1.2, 0.7)),
                                          ((0.0, 0.0), (1.0, 1.0))])
def test_affine_slant_stretch_matches_jax(skew, stretch):
    img = _image(7)
    sk = np.array(skew, np.float32)
    st = np.array(stretch, np.float32)
    want = np.asarray(J.affine_slant_stretch(jnp.asarray(img),
                                             jnp.asarray(sk),
                                             jnp.asarray(st)))
    got = P.affine_slant_stretch(torch.from_numpy(img), torch.from_numpy(sk),
                                 torch.from_numpy(st))
    np.testing.assert_allclose(got.numpy(), want, **SAMPLE_TOL)


@pytest.mark.parametrize("kind", ["warp", "affine", None])
def test_apply_augmentation_kinds(kind):
    img = torch.from_numpy(_image(8))
    g = torch.Generator().manual_seed(0)
    out, mask, scale = P.apply_augmentation(kind, img, None, g)
    assert out.shape == img.shape and torch.isfinite(out).all()
    assert mask is None
    if kind == "affine":
        assert 0.6 <= float(scale) <= 1.4
    else:
        assert float(scale) == 1.0
    if kind is None:
        assert out is img
    # "normalization" (ported since; held against JAX in
    # tests/test_torch_leftovers.py) takes no draws and keeps the mask
    out, mask, scale = P.apply_augmentation("normalization", img, None, g)
    assert out.shape == img.shape and torch.isfinite(out).all()
    assert mask is None and float(scale) == 1.0


def test_apply_augmentation_true_is_warp():
    # reference configs write "augmentation": true for brightness + warp
    img = torch.from_numpy(_image(8))
    got = P.apply_augmentation(True, img, None,
                               torch.Generator().manual_seed(3))[0]
    want = P.apply_augmentation("warp", img, None,
                                torch.Generator().manual_seed(3))[0]
    assert torch.equal(got, want)
