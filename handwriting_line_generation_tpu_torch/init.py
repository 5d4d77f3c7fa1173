"""Seeded parameter init in the port, so the card runs without JAX.

:func:`init_params` builds the ``generator``, ``spacer``, ``hwr``,
``style_extractor`` and ``discriminator`` subtrees of the flax
``HWWithStyle`` param tree (those the config enables), in flax's layout
and with flax's distributions (it matches the distributions, not the
bits):

* lecun_normal — a normal truncated at 2 sigma, std ``sqrt(1/fan_in) /
  0.8796`` — for ``nn.Conv``, ``nn.ConvTranspose`` and ``nn.Dense``;
* N(0, 1) for the equal-LR layers (``EqualConv``, ``FusedUpsample``);
* zero biases; AdaIN bias (gamma = 1, beta = 0); noise weight 0.01;
  GroupNorm scale 1, bias 0; spacer mean (2, 0) and std (1.5, 0.5);
* the vmapped per-class extractors draw each class's kernels on their own,
  with the per-class fan-in;
* the discriminator's kernels (``nn.Conv``, ``SNConv``, ``nn.Dense``)
  lecun_normal, its shapes read off the port's module (the tests hold them
  against flax's own init); :func:`init_spectral` gives each ``SNConv`` a
  random unit ``u``, from a generator of its own.

The generator and spacer draw first and the discriminator last, so each
subtree's weights depend only on the subtrees drawn before it.

:func:`init_model` loads it through :func:`convert.convert_params`.
:func:`init_hwr_params` builds a recognizer tree the same way
(lecun_normal conv, dense and LSTM input kernels, orthogonal LSTM
recurrent kernels, zero biases, GroupNorm 1/0) and
:func:`init_hwr` loads it through :func:`convert.convert_hwr_params`;
:func:`init_autoencoder_params` and :func:`init_autoencoder` do the same
for an ``Autoencoder``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from handwriting_line_generation_tpu_torch.config import HWRConfig, ModelConfig
from handwriting_line_generation_tpu_torch.convert import (
    convert_autoencoder_params, convert_hwr_params, convert_params,
)
from handwriting_line_generation_tpu_torch.models.autoencoder import \
    Autoencoder
from handwriting_line_generation_tpu_torch.models.discriminator import \
    DiscriminatorAP
from handwriting_line_generation_tpu_torch.models.hw_with_style import \
    HWWithStyle
from handwriting_line_generation_tpu_torch.models.hwr import (
    DILATIONS, SMALL_NORMED, SMALL_WIDTHS, TRUNK_NORMED, TRUNK_WIDTHS,
    build_hwr,
)

# std of a unit normal truncated to [-2, 2]: flax divides by it
_TRUNC_STD = 0.87962566103423978


def _lecun(rng: np.random.Generator, shape) -> np.ndarray:
    fan_in = int(np.prod(shape[:-1]))
    x = rng.standard_normal(shape)
    bad = np.abs(x) > 2.0
    while bad.any():                       # resample outside 2 sigma
        x[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(x) > 2.0
    return (x * (np.sqrt(1.0 / fan_in) / _TRUNC_STD)).astype(np.float32)


def _layer(rng, shape, equal_lr: bool = False) -> Dict[str, np.ndarray]:
    k = rng.standard_normal(shape).astype(np.float32) if equal_lr \
        else _lecun(rng, shape)
    return {"kernel": k, "bias": np.zeros(shape[-1], np.float32)}


def _styled_block(rng, kind: str, cin: int, c: int, s: int) -> Dict:
    tree = {}
    if kind == "initial":
        tree["ConvTranspose_0"] = _layer(rng, (4, 3, cin, c))
        tree["Conv_0"] = _layer(rng, (3, 3, c, c))
    elif kind == "nearest":
        tree["Conv_0"] = _layer(rng, (3, 3, cin, c))
        tree["Conv_1"] = _layer(rng, (3, 3, c, c))
    else:                                                  # fused
        tree["FusedUpsample_0"] = _layer(rng, (3, 3, cin, c), equal_lr=True)
        tree["Conv_0"] = _layer(rng, (3, 3, c, c))
    for i in range(2):
        tree[f"NoiseInjection_{i}"] = {
            "weight": np.full((1, 1, 1, c), 0.01, np.float32)}
        tree[f"AdaIN_{i}"] = {"Dense_0": {
            "kernel": _lecun(rng, (s, 2 * c)),
            "bias": np.concatenate([np.ones(c, np.float32),
                                    np.zeros(c, np.float32)])}}
    return tree


def init_params(cfg: ModelConfig, seed: int = 0) -> Dict:
    """Flax-layout ``{"generator": ..., "spacer": ...}`` numpy tree."""
    rng = np.random.default_rng(seed)
    params = {}
    s = cfg.style.style_dim
    if cfg.generator.kind == "pure":
        g, d = cfg.generator, cfg.generator.dim
        cin = cfg.num_class + (s if g.append_style else 0) \
            + cfg.char_cond_dim()
        gen = {"StyleMLP_0": {f"Dense_{i}": _layer(rng, (s, s))
                              for i in range(g.n_style_trans)}}
        # small: the last block does not upsample (a 3x3 conv, then conv2,
        # named as the nearest blocks' are)
        specs = [("initial", cin, d), ("nearest", d, d // 2),
                 ("nearest", d // 2, d // 4), ("fused", d // 4, d // 8),
                 ("nearest" if g.small else "fused", d // 8, d // 16)]
        for i, (kind, ci, co) in enumerate(specs):
            gen[f"StyledConvBlock_{i}"] = _styled_block(rng, kind, ci, co, s)
        gen["EqualConv_0"] = _layer(rng, (1, 1, d // 16, 1), equal_lr=True)
        params["generator"] = gen
    if cfg.spacer.enabled:
        h = cfg.spacer.dim
        n_out = 2 if cfg.spacer.count_duplicates else 1
        widths = [cfg.num_class + s, h, h // 2, h // 4]
        sp = {}
        for i in range(3):
            sp[f"Conv_{i}"] = _layer(rng, (3, widths[i], widths[i + 1]))
            sp[f"GroupNorm_{i}"] = {
                "scale": np.ones(widths[i + 1], np.float32),
                "bias": np.zeros(widths[i + 1], np.float32)}
        sp["Conv_3"] = _layer(rng, (1, h // 4, n_out))
        two = n_out == 2
        sp["mean"] = np.array([2.0, 0.0] if two else [2.0] * n_out,
                              np.float32)
        sp["std"] = np.array([1.5, 0.5] if two else [1.0] * n_out,
                             np.float32)
        params["spacer"] = sp
    if cfg.hwr.kind != "none":
        params["hwr"] = _hwr_tree(rng, cfg.hwr, cfg.num_class)
    if cfg.style.kind == "char":
        params["style_extractor"] = _style_tree(rng, cfg)
    if cfg.discriminator.enabled:
        params["discriminator"] = _disc_tree(rng, cfg)
    return params


def _discriminator(cfg: ModelConfig) -> DiscriminatorAP:
    """The config's discriminator on the meta device (shapes only)."""
    d = cfg.discriminator
    with torch.device("meta"):
        return DiscriminatorAP(dim=d.dim, use_low=d.use_low,
                               use_med=d.use_med, small=d.small, cond=d.cond,
                               use_global=d.use_global,
                               style_dim=cfg.style.style_dim)


def _disc_tree(rng, cfg: ModelConfig) -> Dict:
    """A ``DiscriminatorAP`` tree, in flax's layer names."""
    m = _discriminator(cfg)
    tree = {}
    for stem, layers in (("Conv_", m.convs), ("SNConv_", m.sn)):
        for i, layer in enumerate(layers):
            tree[f"{stem}{i}"] = _layer(rng, _flax_kernel_shape(layer))
    for i, norm in enumerate(m.norms):
        tree[f"GroupNorm_{i}"] = _norm(norm.weight.numel())
    for name in ("global_fc", "global_out", "cond_proj"):
        lin = getattr(m, name)
        if lin is not None:
            layer = _layer(rng, tuple(lin.weight.shape[::-1]))
            tree[name] = layer if lin.bias is not None \
                else {"kernel": layer["kernel"]}
    return tree


def init_spectral(cfg: ModelConfig, seed: int = 0) -> Dict:
    """Flax-layout ``spectral`` collection: a random unit ``u`` for each of
    the discriminator's spectral-norm convs (``{}`` without one)."""
    if not cfg.discriminator.enabled:
        return {}
    rng = np.random.default_rng([seed, 1])
    us = {}
    for i, layer in enumerate(_discriminator(cfg).sn):
        u = rng.standard_normal(layer.weight.shape[0]).astype(np.float32)
        us[f"SNConv_{i}"] = {"u": u / (np.linalg.norm(u) + 1e-12)}
    return {"discriminator": us}


def _bank_layer(rng, n: int, shape) -> Dict[str, np.ndarray]:
    """``n`` per-class layers, each drawn on its own."""
    layers = [_layer(rng, shape) for _ in range(n)]
    return {k: np.stack([l[k] for l in layers]) for k in ("kernel", "bias")}


def _bank_norm(n: int, c: int) -> Dict[str, np.ndarray]:
    return {k: np.stack([v] * n) for k, v in _norm(c).items()}


def _style_tree(rng, cfg: ModelConfig) -> Dict:
    """A ``CharStyleEncoder`` tree (``models/char_style.py``)."""
    s = cfg.style
    nc, d, cd = cfg.num_class, s.dim, s.char_dim
    csd = s.style_dim if s.char_style_dim == 0 else s.char_style_dim
    trunk, cin = {}, 1
    specs = [(d, 5), (2 * d, 4), (2 * d, 3), (4 * d, 4), (4 * d, 3),
             (4 * d, 4), (4 * d, 4)]
    for i, (f, k) in enumerate(specs):
        trunk[f"ConvBlock_{i}"] = {"Conv_0": _layer(rng, (k, k, cin, f))}
        if i < len(specs) - 1 and s.norm in ("group", "batch"):
            trunk[f"ConvBlock_{i}"]["GroupNorm_0"] = _norm(f)
        cin = f
    c4, n = 4 * d, nc - 1
    tree = {"StyleTrunk_0": trunk, "VmapCharExtractor_0": {
        "Conv_0": _bank_layer(rng, n, (3, c4, cd)),
        "GroupNorm_0": _bank_norm(n, cd),
        "Conv_1": _bank_layer(rng, n, (3, cd, c4)),
        "Conv_2": _bank_layer(rng, n, (1 if s.window < 3 else 3, c4, 2 * cd)),
        "GroupNorm_1": _bank_norm(n, 2 * cd),
        "Dense_0": _bank_layer(rng, n, (2 * cd, 2 * cd)),
        "Dense_1": _bank_layer(rng, n, (2 * cd, csd))}}
    if s.char_style_dim > 0:
        tree["VmapFillPred_0"] = {
            "Dense_0": _bank_layer(rng, n, (csd, 2 * csd)),
            "Dense_1": _bank_layer(rng, n, (2 * csd, csd * nc))}
    tree["Conv_0"] = _layer(rng, (5, c4 + nc, c4))
    tree["Conv_1"] = _layer(rng, (3, c4, c4))
    tree["GroupNorm_0"] = _norm(c4)
    tree["Conv_2"] = _layer(rng, (3, c4, c4))
    tree["Dense_0"] = _layer(rng, (c4 + csd, c4))
    if s.char_style_dim > 0:
        head = s.style_dim + csd
    else:
        head = 2 * s.style_dim if s.vae else s.style_dim
    tree["Dense_1"] = _layer(rng, (c4, head))
    return tree


def init_model(cfg: ModelConfig, seed: int = 0) -> HWWithStyle:
    """``HWWithStyle`` on the CPU with seeded flax-distributed weights."""
    model = HWWithStyle(cfg)
    model.load_state_dict(convert_params(init_params(cfg, seed),
                                         init_spectral(cfg, seed)))
    return model


def seed_conv_biases(generator: torch.nn.Module, seed: int) -> None:
    """Set every styled block's conv1 and conv2 bias to seeded N(0, 0.05²)
    values (the init makes them 0), so that a bias the epilogue kernel
    drops or adds twice shows against the plain path."""
    g = torch.Generator("cpu").manual_seed(seed)
    with torch.no_grad():
        for blk in generator.blocks:
            for layer in (blk.conv1, blk.conv2):
                layer.bias.copy_(0.05 * torch.randn(layer.bias.shape,
                                                   generator=g))


def _norm(c: int) -> Dict[str, np.ndarray]:
    return {"scale": np.ones(c, np.float32), "bias": np.zeros(c, np.float32)}


def init_hwr_params(hwr: HWRConfig, num_class: int, seed: int = 0) -> Dict:
    """Flax-layout ``{"params": ...}`` numpy tree of the recognizer
    ``hwr.kind`` names (``cnn_only``, ``crnn``, ``small_crnn``; LSTMs of
    the JAX package's default width, 512)."""
    return {"params": _hwr_tree(np.random.default_rng(seed), hwr, num_class)}


def _orthogonal(rng: np.random.Generator, n: int) -> np.ndarray:
    """flax's ``orthogonal()`` init of an ``[n, n]`` kernel: Q of a normal
    matrix's QR, its columns' signs fixed by R's diagonal."""
    q, r = np.linalg.qr(rng.standard_normal((n, n)))
    return (q * np.sign(np.diag(r))).astype(np.float32)


def _lstm_cell(rng, in_features: int, hidden: int) -> Dict:
    """An ``OptimizedLSTMCell``: lecun_normal input kernels (no bias),
    orthogonal recurrent kernels with zero biases."""
    cell = {f"i{g}": {"kernel": _lecun(rng, (in_features, hidden))}
            for g in "ifgo"}
    cell.update({f"h{g}": {"kernel": _orthogonal(rng, hidden),
                           "bias": np.zeros(hidden, np.float32)}
                 for g in "ifgo"})
    return cell


def _hwr_tree(rng, hwr: HWRConfig, num_class: int) -> Dict:
    """A ``CNNOnlyHWR``, ``CRNN`` or ``SmallCRNN`` tree (``hwr.kind``);
    LSTMs 512 wide, the width the JAX package's ``build_hwr`` gives."""
    normed, hidden = hwr.norm != "none", 512
    if hwr.kind == "small_crnn":
        tree, cin, k = {}, 1, 0
        for i, (f, n) in enumerate(zip(SMALL_WIDTHS, SMALL_NORMED)):
            tree[f"Conv_{i}"] = _layer(rng, (3, 3, cin, f))
            if n and normed:
                tree[f"GroupNorm_{k}"] = _norm(f)
                k += 1
            cin = f
        tree["OptimizedLSTMCell_0"] = _lstm_cell(rng, cin, hidden)
        tree["OptimizedLSTMCell_1"] = _lstm_cell(rng, cin, hidden)
        tree["Dense_0"] = _layer(rng, (2 * hidden, num_class))
        return tree
    if hwr.kind not in ("cnn_only", "crnn"):
        raise ValueError(f"unknown hwr kind {hwr.kind!r}")
    trunk, cin, k = {}, 1, 0
    for i, (f, n) in enumerate(zip(TRUNK_WIDTHS, TRUNK_NORMED)):
        trunk[f"Conv_{i}"] = _layer(rng, (3, 3, cin, f))
        if n and normed:
            trunk[f"GroupNorm_{k}"] = _norm(f)
            k += 1
        cin = f
    tree = {"_ConvTrunk_0": trunk}
    if hwr.kind == "crnn":
        for l in range(2):
            for d in range(2):
                tree[f"OptimizedLSTMCell_{2 * l + d}"] = _lstm_cell(
                    rng, cin, hidden)
            tree[f"Dense_{l}"] = _layer(rng, (2 * hidden, hidden))
            cin = hidden
        tree["Dense_2"] = _layer(rng, (hidden, num_class))
        return tree
    for i in range(len(DILATIONS)):
        tree[f"Conv_{i}"] = _layer(rng, (3, 512, 512))
        if normed:
            tree[f"GroupNorm_{i}"] = _norm(512)
    tree[f"Conv_{len(DILATIONS)}"] = _layer(rng, (3, 512, num_class))
    return tree


def init_hwr(hwr: HWRConfig, num_class: int, seed: int = 0,
             dtype: torch.dtype = torch.float32) -> torch.nn.Module:
    """The recognizer of ``hwr.kind`` on the CPU with seeded
    flax-distributed weights."""
    model = build_hwr(hwr.kind, num_class, hwr.norm, hwr.small, hwr.pad,
                      dtype)
    model.load_state_dict(convert_hwr_params(
        init_hwr_params(hwr, num_class, seed)))
    return model


def _flax_kernel_shape(layer: torch.nn.Module) -> tuple:
    """flax kernel shape of a Conv1d/Conv2d (``[*k, in, out]``) or a
    ConvTranspose2d (``[kh, kw, in, out]``)."""
    w = layer.weight.shape
    if isinstance(layer, torch.nn.ConvTranspose2d):
        return tuple(w[2:]) + (w[0], w[1])
    return tuple(w[2:]) + (w[1], w[0])


def init_autoencoder_params(kind: str, hwr_classes: int,
                            seed: int = 0) -> Dict:
    """Flax-layout ``{"params": ...}`` numpy tree of an ``Autoencoder``:
    lecun_normal kernels (``nn.Conv``, ``nn.ConvTranspose``), zero biases,
    GroupNorm 1/0.  The shapes are read off the port's module of that kind
    (the tests hold them against flax's own init)."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):                 # shapes only, no storage
        model = Autoencoder(kind, hwr_classes)
    tree = {}
    for name in ("encoder", "decoder", "hwr"):
        sub = getattr(model, name)
        if sub is None:
            continue
        tree[name] = {}
        for stem, attr in (("Conv_", "convs"), ("ConvTranspose_", "convts")):
            for i, layer in enumerate(getattr(sub, attr, ())):
                tree[name][f"{stem}{i}"] = _layer(rng,
                                                  _flax_kernel_shape(layer))
        for i, norm in enumerate(sub.norms):
            tree[name][f"GroupNorm_{i}"] = _norm(norm.weight.numel())
    return {"params": tree}


def init_autoencoder(kind: str = "2tight", hwr_classes: int = 0,
                     seed: int = 0, dtype: torch.dtype = torch.float32
                     ) -> Autoencoder:
    """``Autoencoder`` on the CPU with seeded flax-distributed weights."""
    with torch.device("meta"):        # skip torch's own init: every
        model = Autoencoder(kind, hwr_classes, dtype)    # weight is loaded
    model.load_state_dict(convert_autoencoder_params(
        init_autoencoder_params(kind, hwr_classes, seed)), assign=True)
    return model
