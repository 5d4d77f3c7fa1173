"""Port parity for the perceptual autoencoder: the port's modules against
the JAX package's on the same numpy inputs and the same converted weights
(float32), the transposed-conv helper, the seeded init's tree against
flax's, the converter, and the port's dropout."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as nn

from handwriting_line_generation_tpu.models import autoencoder as J
from handwriting_line_generation_tpu.models.layers import \
    avg_pool as j_avg_pool
from handwriting_line_generation_tpu_torch.convert import (
    _flipped_transpose, convert_autoencoder_params,
)
from handwriting_line_generation_tpu_torch.init import (
    init_autoencoder, init_autoencoder_params,
)
from handwriting_line_generation_tpu_torch.models import autoencoder as P
from handwriting_line_generation_tpu_torch.models.layers import (
    avg_pool, channel_dropout, conv_transpose,
)
from handwriting_line_generation_tpu_torch.utils.checkpoint import \
    extract_subtree

NC = 12
B, W = 2, 64
TOL = dict(rtol=0.0, atol=1e-4)


def _image(h=64, w=W, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, h, w, 1)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _jparams(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _tree(kind, seed):
    """Seeded init params of ``kind`` with every bias drawn from N(0, 0.1)
    and every GroupNorm scale from 1 + N(0, 0.1), so that a dropped bias or
    norms taken in the wrong order show in the outputs."""
    rng = np.random.default_rng(100 + seed)

    def fill(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            if k in ("bias", "scale") and not isinstance(v, dict):
                noise = 0.1 * rng.standard_normal(v.shape)
                v = (noise + (k == "scale")).astype(v.dtype)
            out[k] = fill(v)
        return out
    return fill(init_autoencoder_params(kind, NC, seed=seed))


def _port(kind, tree):
    """The port's ``Autoencoder`` holding ``tree``'s weights."""
    with torch.device("meta"):
        model = P.Autoencoder(kind, NC)
    model.load_state_dict(convert_autoencoder_params(tree), assign=True)
    return model


# the decoders' transposed convs: (kernel, stride, flax padding) -> the
# torch padding k - 1 - p
CONVT_CASES = [((6, 3), 1, ((5, 5), (1, 1)), (1, 8)),
               ((3, 3), 1, ((2, 2), (1, 1)), (6, 8)),
               ((4, 4), 2, ((2, 2), (2, 2)), (8, 8)),
               ((3, 3), 1, ((1, 1), (1, 1)), (8, 8))]


@pytest.mark.parametrize("kernel,stride,padding,hw", CONVT_CASES)
def test_conv_transpose_matches_flax(kernel, stride, padding, hw):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2,) + hw + (5,)).astype(np.float32)
    m = nn.ConvTranspose(7, kernel, strides=(stride, stride),
                         padding=padding)
    p = {"kernel": rng.standard_normal(kernel + (5, 7)).astype(np.float32),
         "bias": rng.standard_normal(7).astype(np.float32)}
    want = np.asarray(jax.jit(m.apply)({"params": _jparams(p)},
                                       jnp.asarray(x)))
    layer = torch.nn.ConvTranspose2d(5, 7, kernel, stride)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(
            _flipped_transpose(p["kernel"]).copy()))
        layer.bias.copy_(torch.from_numpy(p["bias"]))
        got = conv_transpose(_nchw(x), layer, torch.float32, padding)
    if stride == 2:                            # exactly twice as high, wide
        assert got.shape[2:] == (2 * hw[0], 2 * hw[1])
    np.testing.assert_allclose(_nhwc(got), want, **TOL)


def test_conv_transpose_rejects_uneven_padding():
    layer = torch.nn.ConvTranspose2d(2, 2, (3, 3))
    with pytest.raises(ValueError, match="padding"):
        conv_transpose(torch.zeros(1, 2, 4, 4), layer, torch.float32,
                       ((1, 2), (1, 1)))


def test_avg_pool_matches_flax():
    x = _image(16, 24)
    want = np.asarray(j_avg_pool(jnp.asarray(x), (2, 2)))
    np.testing.assert_allclose(_nhwc(avg_pool(_nchw(x), (2, 2))), want,
                               **TOL)


@pytest.mark.parametrize("kind", P.AE_KINDS)
def test_init_tree_matches_flax(kind):
    h = 32 if kind == "32" else 64
    m = J.Autoencoder(kind=kind, hwr_classes=NC)
    shapes = jax.eval_shape(lambda: m.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, h, 32, 1))))
    mine = init_autoencoder_params(kind, NC, seed=0)
    shape_of = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)
    assert shape_of(mine) == shape_of(shapes)


def _enc_dec_hwr(tree):
    p = tree["params"]
    return ({"params": p["encoder"]}, {"params": p["decoder"]},
            {"params": p["hwr"]})


def test_encoder2_decoder_ehwr_match_jax():
    tree = _tree("2tight", seed=1)
    pe, pd, ph = map(_jparams, _enc_dec_hwr(tree))
    model = _port("2tight", tree)
    x = _image()
    bott_j, mid_j = jax.jit(J.Encoder2(out_dim=32).apply)(pe,
                                                          jnp.asarray(x))
    with torch.no_grad():
        bott, mid = model.encoder(_nchw(x))
        recon = model.decoder(bott)
        logp = model.hwr(bott)
    assert bott.shape == (B, 32, 1, W // 8) and mid.shape == (B, 64, 16,
                                                              W // 4)
    np.testing.assert_allclose(_nhwc(bott), np.asarray(bott_j), **TOL)
    np.testing.assert_allclose(_nhwc(mid), np.asarray(mid_j), **TOL)
    # the decoder and the head on the JAX bottleneck: each module alone
    recon_j = jax.jit(J.DecoderNoSkip(input_dim=32).apply)(pd, bott_j)
    logp_j = jax.jit(J.EHWR(num_class=NC).apply)(ph, bott_j)
    with torch.no_grad():
        recon1 = model.decoder(_nchw(np.asarray(bott_j)))
        logp1 = model.hwr(_nchw(np.asarray(bott_j)))
    np.testing.assert_allclose(_nhwc(recon1), np.asarray(recon_j), **TOL)
    np.testing.assert_allclose(logp1.numpy(), np.asarray(logp_j), **TOL)
    np.testing.assert_allclose(_nhwc(recon), np.asarray(recon_j), **TOL)
    np.testing.assert_allclose(logp.numpy(), np.asarray(logp_j), **TOL)


@pytest.mark.parametrize("kind", P.AE_KINDS)
def test_autoencoder_family_matches_jax(kind):
    h, w = (32, 32) if kind == "32" else (64, 32)
    tree = _tree(kind, seed=2)
    x = _image(h, w, seed=2)
    recon_j, logp_j = jax.jit(J.Autoencoder(kind=kind, hwr_classes=NC).apply)(
        _jparams(tree), jnp.asarray(x))
    with torch.no_grad():
        recon, logp = _port(kind, tree)(torch.from_numpy(x))
    t = w // 4 if kind == "32" else w // 8
    assert tuple(recon.shape) == x.shape and tuple(logp.shape) == (B, t, NC)
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j), **TOL)
    np.testing.assert_allclose(logp.numpy(), np.asarray(logp_j), **TOL)


@pytest.mark.parametrize("kind", ["2tight", "2", "skip", "space", "other"])
def test_build_encoder_matches_jax(kind):
    ae_kind = "2tight" if kind == "other" else kind
    tree = _tree(ae_kind, seed=3)
    x = _image(w=32, seed=3)
    bott_j, mid_j = jax.jit(J.build_encoder(kind).apply)(
        {"params": _jparams(tree["params"]["encoder"])}, jnp.asarray(x))
    enc = P.build_encoder(kind)
    enc.load_state_dict(extract_subtree(_port(ae_kind, tree).state_dict(),
                                        "encoder"))
    with torch.no_grad():
        bott, mid = enc(_nchw(x))
    np.testing.assert_allclose(_nhwc(bott), np.asarray(bott_j), **TOL)
    np.testing.assert_allclose(_nhwc(mid), np.asarray(mid_j), **TOL)


def test_convert_rejects_wrong_key_sets():
    tree = init_autoencoder_params("2tight", NC, seed=0)["params"]
    convert_autoencoder_params(tree)               # the right set passes
    bad = dict(tree, discriminator={})
    with pytest.raises(KeyError, match="discriminator"):
        convert_autoencoder_params(bad)
    enc = dict(tree["encoder"], Dense_0=tree["encoder"]["Conv_0"])
    with pytest.raises(KeyError, match="Dense_0"):
        convert_autoencoder_params(dict(tree, encoder=enc))
    conv0 = dict(tree["encoder"]["Conv_0"], scale=np.ones(32, np.float32))
    with pytest.raises(KeyError, match="Conv_0"):
        convert_autoencoder_params(
            dict(tree, encoder=dict(tree["encoder"], Conv_0=conv0)))
    no_bias = {"kernel": tree["decoder"]["ConvTranspose_0"]["kernel"]}
    with pytest.raises(KeyError, match="ConvTranspose_0"):
        convert_autoencoder_params(
            dict(tree, decoder=dict(tree["decoder"],
                                    ConvTranspose_0=no_bias)))
    # another kind's tree converts, but does not load
    other = convert_autoencoder_params(init_autoencoder_params("2", NC))
    with pytest.raises(RuntimeError):
        P.Autoencoder("2tight", NC).load_state_dict(other)


def test_extract_subtree_needs_the_prefix():
    sd = P.Autoencoder("2tight", NC).state_dict()
    enc = extract_subtree(sd, "encoder.")
    assert set(enc) == set(P.Encoder2(32).state_dict())
    with pytest.raises(KeyError):
        extract_subtree(sd, "generator")


@pytest.mark.parametrize("per_channel", [True, False])
def test_dropout_masks(per_channel):
    x = torch.ones(64, 16, 4, 8)
    rate = 0.25
    gen = lambda: torch.Generator().manual_seed(5)
    y = channel_dropout(x, rate, gen(), per_channel)
    kept = y != 0
    # kept entries scaled by 1 / (1 - rate), the rest zero
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / (1 - rate)))
    if per_channel:            # one draw per (sample, channel)
        assert torch.equal(kept, kept[:, :, :1, :1].expand_as(kept))
    else:
        assert not torch.equal(kept, kept[:, :, :1, :1].expand_as(kept))
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.05
    assert torch.equal(channel_dropout(x, rate, gen(), per_channel), y)
    assert channel_dropout(x, rate, None, per_channel) is x
    assert channel_dropout(x, 0.0, gen(), per_channel) is x


def test_autoencoder_dropout_follows_the_generator():
    model = init_autoencoder("2tight", NC, seed=0)
    x = torch.from_numpy(_image(w=32))
    with torch.no_grad():
        det = model(x)
        a = model(x, torch.Generator().manual_seed(1))
        b = model(x, torch.Generator().manual_seed(1))
        c = model(x, torch.Generator().manual_seed(2))
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert not torch.equal(a[0], det[0]) and not torch.equal(a[1], det[1])
    assert not torch.equal(a[1], c[1])
