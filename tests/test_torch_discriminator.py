"""Port parity: ``SNConv`` and ``DiscriminatorAP`` against the JAX package.

The same weights (the port's seeded init, converted) and the same numpy
inputs go through both.  Tolerances, float32: scores within 1e-4 absolute,
parameter gradients within 1e-3 of each tensor's largest entry, ``u``
after two forwards within 1e-6 (the power iteration is a handful of
float32 dot products and norms)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from handwriting_line_generation_tpu.models.discriminator import \
    DiscriminatorAP as JDiscriminatorAP
from handwriting_line_generation_tpu.models.layers import SNConv as JSNConv
from handwriting_line_generation_tpu.training.losses import \
    disc_hinge_loss as j_hinge
from handwriting_line_generation_tpu_torch import convert
from handwriting_line_generation_tpu_torch.config import (
    DiscriminatorConfig, ModelConfig, StyleConfig,
)
from handwriting_line_generation_tpu_torch.init import (
    _disc_tree, init_spectral,
)
from handwriting_line_generation_tpu_torch.models.discriminator import \
    DiscriminatorAP
from handwriting_line_generation_tpu_torch.models.layers import SNConv
from handwriting_line_generation_tpu_torch.training.losses import \
    disc_hinge_loss

B, W, S = 2, 64, 8
SCORE_ATOL = 1e-4
GRAD_RTOL = 1e-3
U_ATOL = 1e-6


def _max_rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _jsn(kernel, padding, x, w, b, u):
    """JAX SNConv forward with ``u``: (y, u')."""
    m = JSNConv(w.shape[-1], kernel, padding=padding)
    y, new = m.apply({"params": {"kernel": w, "bias": b},
                      "spectral": {"u": u}}, x, mutable=["spectral"])
    return y, new["spectral"]["u"]


@pytest.mark.parametrize("kernel,padding", [((3, 3), (0, 0, 1, 1)),
                                            ((1, 3), (0, 0, 1, 1)),
                                            ((1, 1), (0, 0, 0, 0)),
                                            ((3, 3), (1, 1, 1, 1))])
def test_snconv_forward_sigma_u_and_grads(kernel, padding):
    rng = np.random.default_rng(0)
    cin, cout = 5, 6
    x = rng.normal(size=(B, 7, 9, cin)).astype(np.float32)
    w = (rng.normal(size=kernel + (cin, cout)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    u = rng.normal(size=(cout,)).astype(np.float32)
    u /= np.linalg.norm(u)
    ct = rng.normal(size=(B,) + (7 - kernel[0] + 1 + padding[0] + padding[1],
                                 9 - kernel[1] + 1 + padding[2] + padding[3],
                                 cout)).astype(np.float32)

    # two forwards in a row, u threaded; gradients of the second
    _, u1 = _jsn(kernel, padding, x, w, b, u)

    def loss(w_, b_):
        y, u2 = _jsn(kernel, padding, x, w_, b_, u1)
        return jnp.sum(y * ct), (y, u2)
    (_, (y_j, u2_j)), (gw_j, gb_j) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(w, b)

    layer = SNConv(cin, cout, kernel, padding)
    layer.load_state_dict({"weight": torch.from_numpy(convert._conv(w)),
                           "bias": torch.from_numpy(b),
                           "u": torch.from_numpy(u)})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        layer(xt)
    np.testing.assert_allclose(layer.u.numpy(), np.asarray(u1), atol=U_ATOL)
    # sigma: the weight over the normalized weight, against flax's einsum
    wm = w.reshape(-1, cout)
    v = wm @ np.asarray(u1)
    v /= np.linalg.norm(v)
    u2 = wm.T @ v
    u2 /= np.linalg.norm(u2)
    sigma = float(v @ wm @ u2)
    wn = layer.normalized_weight(update_u=False)
    np.testing.assert_allclose(
        (layer.weight / wn).detach().numpy(),
        np.full(layer.weight.shape, sigma, np.float32), rtol=1e-5)
    y = layer(xt)
    np.testing.assert_allclose(layer.u.numpy(), np.asarray(u2_j),
                               atol=U_ATOL)
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(y_j), atol=SCORE_ATOL)
    (y * torch.from_numpy(ct).permute(0, 3, 1, 2)).sum().backward()
    assert _max_rel(layer.weight.grad.numpy(),
                    convert._conv(np.asarray(gw_j))) <= GRAD_RTOL
    assert _max_rel(layer.bias.grad.numpy(), np.asarray(gb_j)) <= GRAD_RTOL


VARIANTS = {
    "paper": dict(),
    "small": dict(small=True),
    "global": dict(use_global=True, use_med=False),
    "cond": dict(cond=True, use_low=False),
}


def _pair(dim, seed, **kw):
    """JAX module, flax variables and the port module with the same
    weights (biases and norms drawn at random, so none is trivially 0/1)."""
    cfg = ModelConfig(style=StyleConfig(style_dim=S),
                      discriminator=DiscriminatorConfig(dim=dim, **kw))
    rng = np.random.default_rng(seed)
    params = _disc_tree(rng, cfg)
    for layer in params.values():
        for k in ("bias", "scale"):
            if k in layer:
                layer[k] = layer[k] + 0.1 * rng.normal(
                    size=layer[k].shape).astype(np.float32)
    spectral = init_spectral(cfg, seed)
    d = cfg.discriminator
    jm = JDiscriminatorAP(dim=dim, use_low=d.use_low, use_med=d.use_med,
                          small=d.small, cond=d.cond,
                          use_global=d.use_global)
    pm = DiscriminatorAP(dim=dim, use_low=d.use_low, use_med=d.use_med,
                         small=d.small, cond=d.cond, use_global=d.use_global,
                         style_dim=S)
    sd = convert.convert_params({"discriminator": params}, spectral)
    pm.load_state_dict({k[len("discriminator."):]: v for k, v in sd.items()})
    return jm, params, spectral["discriminator"], pm


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_discriminator_matches_jax(variant):
    """Two forwards (real, then fake, u threaded as in the disc step), the
    hinge loss and its parameter gradients; ``u`` after both."""
    jm, params, spec, pm = _pair(8, seed=1, **VARIANTS[variant])
    rng = np.random.default_rng(2)
    real, fake = (np.tanh(rng.normal(size=(B, 64, W, 1))).astype(np.float32)
                  for _ in range(2))
    style = rng.normal(size=(B, S)).astype(np.float32) \
        if VARIANTS[variant].get("cond") else None
    kw = {"style": style} if style is not None else {}

    def loss(p):
        r, s1 = jm.apply({"params": p, "spectral": spec}, real,
                         mutable=["spectral"], **kw)
        f, s2 = jm.apply({"params": p, "spectral": s1["spectral"]}, fake,
                         mutable=["spectral"], **kw)
        return j_hinge(r, f), (r, f, s2["spectral"])
    (l_j, (r_j, f_j, s_j)), g_j = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)

    ts = None if style is None else torch.from_numpy(style)
    r_t = pm(torch.from_numpy(real), style=ts)
    f_t = pm(torch.from_numpy(fake), style=ts)
    l_t = disc_hinge_loss(r_t, f_t)
    assert len(r_t) == len(r_j)
    for got, want in zip(r_t + f_t, list(r_j) + list(f_j)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=SCORE_ATOL)
    np.testing.assert_allclose(l_t.item(), float(l_j), rtol=1e-5)
    l_t.backward()
    g_want = convert.convert_params(
        {"discriminator": jax.tree_util.tree_map(np.asarray, g_j)},
        {"discriminator": jax.tree_util.tree_map(np.asarray, s_j)})
    for name, p in pm.named_parameters():
        want = g_want["discriminator." + name].numpy()
        assert _max_rel(p.grad.numpy(), want) <= GRAD_RTOL, name
    for i, layer in enumerate(pm.sn):
        np.testing.assert_allclose(
            layer.u.numpy(), np.asarray(s_j[f"SNConv_{i}"]["u"]),
            atol=U_ATOL)


def test_paper_heights_collapse_to_one_and_update_u_flag():
    _, _, _, pm = _pair(8, seed=3)
    x = torch.zeros((1, 64, 96, 1))
    before = [l.u.clone() for l in pm.sn]
    out = pm(x, update_u=False)
    assert [tuple(o.shape) for o in out] == [(1, 12), (1, 3)]
    assert all(torch.equal(a, l.u) for a, l in zip(before, pm.sn))
    pm(x)
    # a one-output conv's u is +-1 whatever the iteration does
    assert all(not torch.equal(a, l.u) for a, l in zip(before, pm.sn)
               if l.u.numel() > 1)


def test_dropout_only_with_a_generator():
    _, _, _, pm = _pair(8, seed=4)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 64, 64, 1)).astype(np.float32))
    a = pm(x, update_u=False)
    b = pm(x, update_u=False)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    c = pm(x, update_u=False, generator=torch.Generator().manual_seed(0))
    assert not all(torch.equal(p, q) for p, q in zip(a, c))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_init_tree_matches_flax(variant):
    """The seeded init has flax's exact discriminator tree and shapes, and
    its ``spectral`` tree flax's ``u`` shapes."""
    kw = VARIANTS[variant]
    cfg = ModelConfig(style=StyleConfig(style_dim=S),
                      discriminator=DiscriminatorConfig(dim=8, **kw))
    d = cfg.discriminator
    jm = JDiscriminatorAP(dim=8, use_low=d.use_low, use_med=d.use_med,
                          small=d.small, cond=d.cond, use_global=d.use_global)
    style = jnp.zeros((B, S)) if d.cond else None
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((B, 64, W, 1)), style=style))
    shape = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)
    params = _disc_tree(np.random.default_rng(0), cfg)
    assert shape(params) == shape(shapes["params"])
    assert shape(init_spectral(cfg)["discriminator"]) == \
        shape(shapes["spectral"])
