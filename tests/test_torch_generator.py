"""Port parity: ``SpacedGenerator`` (sequential and fused epilogue),
``CountCNN`` and the spacing ops against the JAX package, on numpy params
from the port's seeded init and numpy-made inputs and noise."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from handwriting_line_generation_tpu.models.count_cnn import \
    CountCNN as JCountCNN
from handwriting_line_generation_tpu.models.generator import \
    SpacedGenerator as JSpacedGenerator
from handwriting_line_generation_tpu.ops import spacing as JS
from handwriting_line_generation_tpu_torch.config import (
    GeneratorConfig, ModelConfig, SpacerConfig, StyleConfig,
)
from handwriting_line_generation_tpu_torch.convert import convert_params
from handwriting_line_generation_tpu_torch.init import init_params
from handwriting_line_generation_tpu_torch.models.count_cnn import CountCNN
from handwriting_line_generation_tpu_torch.models.generator import \
    SpacedGenerator
from handwriting_line_generation_tpu_torch.ops import spacing as PS

pytestmark = pytest.mark.compile   # JAX generator compiles dominate

B, T, S, NC, DIM = 2, 16, 24, 20, 32


def _cfg(fused=False, csd=0):
    return ModelConfig(num_class=NC,
                       style=StyleConfig(style_dim=S, char_style_dim=csd),
                       generator=GeneratorConfig(dim=DIM,
                                                 fused_epilogue=fused),
                       spacer=SpacerConfig(dim=32))


def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix)}


_CONV_BIASES = ("Conv_0", "Conv_1", "ConvTranspose_0", "FusedUpsample_0")


def _with_conv_biases(gp, seed):
    """A copy of generator params whose styled blocks' conv and
    FusedUpsample biases are non-zero (the seeded init makes them 0, so a
    bias dropped or added twice would not show)."""
    rng = np.random.default_rng(seed)
    out = dict(gp)
    for blk, sub in gp.items():
        if not blk.startswith("StyledConvBlock_"):
            continue
        out[blk] = dict(sub)
        for name in _CONV_BIASES:
            if name in sub:
                layer = dict(sub[name])
                layer["bias"] = rng.normal(
                    scale=0.5, size=np.shape(layer["bias"])).astype(np.float32)
                out[blk][name] = layer
    return out


def _generator_inputs(rng):
    oh = np.eye(NC, dtype=np.float32)[rng.integers(0, NC, (B, T))]
    style = rng.normal(size=(B, S)).astype(np.float32)
    hs, ws = [4, 8, 16, 32, 64], [T, T, T, 2 * T, 4 * T]
    noise = [rng.normal(size=(B, h, w, 1)).astype(np.float32)
             for h, w in zip(hs, ws) for _ in range(2)]
    return oh, style, noise


def _torch_generator(gp, fused):
    gen = SpacedGenerator(num_class=NC, style_dim=S, dim=DIM,
                          fused_epilogue=fused)
    gen.load_state_dict(_sub(convert_params({"generator": gp}),
                             "generator."))
    return gen


@pytest.mark.parametrize("fused,biased", [
    pytest.param(False, False, id="False"),
    pytest.param(True, False, id="True"),
    pytest.param(False, True, id="False-bias"),
    pytest.param(True, True, id="True-bias")])
def test_spaced_generator_matches_jax_f32(fused, biased):
    """Injected noise, f32: rtol = atol = 1e-4 (as the JAX package's own
    fused-vs-sequential test); the fused case runs the JAX kernel in
    interpret mode and the port's plain epilogue.  The ``-bias`` cases set
    every conv and FusedUpsample bias of the styled blocks non-zero in the
    numpy params before both packages run."""
    rng = np.random.default_rng(0)
    params = init_params(_cfg(), seed=3)
    gp = params["generator"]
    if biased:
        gp = _with_conv_biases(gp, seed=7)
    oh, style, noise = _generator_inputs(rng)
    jgen = JSpacedGenerator(num_class=NC, style_dim=S, dim=DIM,
                            fused_epilogue=fused)
    want = np.asarray(jgen.apply({"params": gp}, jnp.asarray(oh),
                                 jnp.asarray(style),
                                 noise=[jnp.asarray(n) for n in noise]))
    gen = _torch_generator(gp, fused)
    with torch.no_grad():
        got = gen(torch.from_numpy(oh), torch.from_numpy(style),
                  noise=[torch.from_numpy(n) for n in noise]).numpy()
    assert got.shape == (B, 64, 4 * T, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_fused_block_moves_conv_bias_into_epilogue(monkeypatch):
    """With non-zero conv biases, the fused generator hands each of its 9
    epilogue calls its conv's bias and runs that conv without it: its
    output matches the sequential path (which adds the bias in the conv)
    within 1e-4 in f32, so no bias is dropped or added twice."""
    from handwriting_line_generation_tpu_torch.models import generator
    gp = _with_conv_biases(init_params(_cfg(), seed=3)["generator"], seed=8)
    oh, style, noise = _generator_inputs(np.random.default_rng(1))
    args = (torch.from_numpy(oh), torch.from_numpy(style))
    kw = dict(noise=[torch.from_numpy(n) for n in noise])
    biases = []
    real = generator.block_epilogue

    def spy(*a, bias=None, **k):
        biases.append(bias)
        return real(*a, bias=bias, **k)
    monkeypatch.setattr(generator, "block_epilogue", spy)
    fused, seq = _torch_generator(gp, True), _torch_generator(gp, False)
    with torch.no_grad():
        got = fused(*args, **kw).numpy()
        want = seq(*args, **kw).numpy()
    assert len(biases) == 9
    convs = [blk.conv1 for blk in fused.blocks] + \
        [blk.conv2 for blk in fused.blocks[:4]]
    assert all(b is not None and b.abs().max() > 0 for b in biases)
    assert sorted(b.tolist() for b in biases) == \
        sorted(c.bias.tolist() for c in convs)
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_generator_without_noise_or_generator_raises():
    gen = SpacedGenerator(num_class=NC, style_dim=S, dim=DIM)
    with pytest.raises(ValueError, match="Generator"):
        gen(torch.zeros(B, T, NC), torch.zeros(B, S))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_count_cnn_matches_jax(dtype):
    """f32 1e-5; bf16 convs and norms (final 1x1 and scale stay f32):
    atol 5e-2 on counts of order 1."""
    rng = np.random.default_rng(1)
    params = init_params(_cfg(), seed=4)
    L = 7
    oh = np.eye(NC, dtype=np.float32)[rng.integers(0, NC, (B, L))]
    style = rng.normal(size=(B, S)).astype(np.float32)
    jdt = None if dtype == "float32" else jnp.bfloat16
    want = np.asarray(JCountCNN(hidden=32, dtype=jdt).apply(
        {"params": params["spacer"]}, jnp.asarray(oh), jnp.asarray(style)))
    net = CountCNN(NC + S, hidden=32, dtype=getattr(torch, dtype))
    net.load_state_dict(_sub(convert_params(params), "spacer."))
    with torch.no_grad():
        got = net(torch.from_numpy(oh), torch.from_numpy(style))
    assert got.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def _spacing_inputs(seed=2, L=6):
    rng = np.random.default_rng(seed)
    labels = rng.integers(1, NC, (B, L)).astype(np.int32)
    lens = np.array([L, L - 2], np.int32)
    labels[1, L - 2:] = 0
    counts = np.stack([rng.uniform(-0.5, 3.5, (B, L)),
                       rng.uniform(-0.5, 2.5, (B, L))], -1).astype(np.float32)
    return labels, lens, counts


@pytest.mark.parametrize("dup", [True, False])
def test_insert_spaces_injected_normals(dup):
    """The port takes the JAX draws as ``normals``: identical maps."""
    labels, lens, counts = _spacing_inputs()
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    n1 = np.array(jax.random.normal(k1, labels.shape))
    n2 = np.array(jax.random.normal(k2, labels.shape))
    want, wtot = JS.insert_spaces(jnp.asarray(labels), jnp.asarray(lens),
                                  jnp.asarray(counts), key, max_len=24,
                                  count_std=0.4, dup_std=0.3,
                                  count_duplicates=dup)
    got, tot = PS.insert_spaces(
        torch.from_numpy(labels), torch.from_numpy(lens),
        torch.from_numpy(counts), max_len=24, count_std=0.4, dup_std=0.3,
        count_duplicates=dup,
        normals=(torch.from_numpy(n1), torch.from_numpy(n2)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tot.numpy(), np.asarray(wtot))


def test_insert_spaces_zero_std_needs_no_randomness():
    labels, lens, counts = _spacing_inputs(seed=3)
    want, _ = JS.insert_spaces(jnp.asarray(labels), jnp.asarray(lens),
                               jnp.asarray(counts), jax.random.PRNGKey(0),
                               max_len=32, count_std=0.0, dup_std=0.0)
    got, _ = PS.insert_spaces(torch.from_numpy(labels),
                              torch.from_numpy(lens),
                              torch.from_numpy(counts), max_len=32,
                              count_std=0.0, dup_std=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="Generator"):
        PS.insert_spaces(torch.from_numpy(labels), torch.from_numpy(lens),
                         torch.from_numpy(counts), max_len=32)


def test_round_half_to_even_matches_jax():
    """Counts exactly on .5 round the same way in both packages."""
    x = np.array([-1.5, -0.5, 0.5, 1.5, 2.5, 3.5, 2.4999, 2.5001],
                 np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(x))))
    labels = np.array([[3, 4, 5, 6]], np.int32)
    counts = np.array([[[0.5, 1.5], [1.5, 0.5], [2.5, 2.5], [0.5, 1.0]]],
                      np.float32)
    want, _ = JS.insert_spaces(jnp.asarray(labels), jnp.asarray([4]),
                               jnp.asarray(counts), jax.random.PRNGKey(0),
                               max_len=16, count_std=0.0, dup_std=0.0)
    got, _ = PS.insert_spaces(torch.from_numpy(labels), torch.tensor([4]),
                              torch.from_numpy(counts), max_len=16,
                              count_std=0.0, dup_std=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_counts_from_spaced_matches_jax():
    rng = np.random.default_rng(5)
    spaced = rng.integers(0, 4, (3, 20)).astype(np.int32)
    spaced[rng.random((3, 20)) < 0.4] = 0
    gt, n = JS.counts_from_spaced(jnp.asarray(spaced), 8)
    pgt, pn = PS.counts_from_spaced(torch.from_numpy(spaced).long(), 8)
    np.testing.assert_array_equal(pgt.numpy(), np.asarray(gt))
    np.testing.assert_array_equal(pn.numpy(), np.asarray(n))


def test_onehot():
    labels = np.array([[0, 3, 1]], np.int32)
    np.testing.assert_array_equal(
        PS.onehot(torch.from_numpy(labels), 5).numpy(),
        np.asarray(JS.onehot(jnp.asarray(labels), 5)))
